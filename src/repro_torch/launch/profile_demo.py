"""Profiled demo mine of the port: every kernel family, measured vs modeled.

One short run that drives all five ``repro_torch.kernels.ops`` dispatch
families through the kernel profiler, each call timed on its device:

  * **bitmap / multi / pair** — the mining support counters (B3, B1 at K=8,
    and B7, ``ops.pair_supports``'s default), called eagerly on an
    IBM-generator database;
  * **subset** — the serving sweep (B4), 32 transactions as queries against
    64 as itemset masks;
  * **delta** — the streaming sweep (B5), the database's two halves as
    blocks against the same 64 masks;
  * plus a real Parallel-FIMI mine, whose B3 and B1 launches are timed calls
    too (every dispatch of the port is eager), with the progress line.

Then the attribution table.  It exits 1 if a family has no measured time.
With ``--trace DIR`` the attribution rides the run record as ``kernels/*``
gauges, which the reference's report CLI renders and checks::

    python -m repro_torch.launch.profile_demo --db T500I0.1P50PL10TL40 --support 0.2 -P 4
    python -m repro_torch.launch.profile_demo --device cpu --trace RUN
    python -m repro.launch.obs_report kernels RUN \\
        --require bitmap,multi,pair,subset,delta --check-model
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.core import bitmap as bm
from repro_torch.core import fimi
from repro_torch.data.ibm_gen import generate_dense, params_from_name
from repro_torch.kernels import ops
from repro_torch.launch.mine import mine_params
from repro_torch.obs import profile as obs_profile
from repro_torch.obs.session import add_obs_flags, start_session


@dataclasses.dataclass
class DemoRun:
    """What one demo run did: the mine, the profiler's report, the families
    without measured time, this run's launches, and the pair family's last
    output with its operands."""

    result: fimi.FimiResult
    report: dict
    missing: List[str]
    launches: Dict[str, int]
    pair_out: torch.Tensor
    item_bits: torch.Tensor
    all_tids: torch.Tensor
    eager_s: float


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--db", default="T0.5I0.024P8PL5TL8")
    ap.add_argument("--support", type=float, default=0.08)
    ap.add_argument("-P", type=int, default=2)
    ap.add_argument("--reps", type=int, default=3,
                    help="eager dispatches per family")
    ap.add_argument("--frontier", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    add_obs_flags(ap)
    return ap


def run(dense: np.ndarray, args: argparse.Namespace) -> DemoRun:
    """The demo on one dense database (bool ``[n_tx, n_items]``), printing
    what the reference's demo prints."""
    dev = device_mod.resolve(args.device)
    args.profile = True      # this launcher exists to profile
    obs = start_session(args, "profile_demo")
    prof = obs_profile.profiler()
    if obs is None:          # no run record asked for: still profile + print
        prof.clear()
        prof.enable()
    launched_before = ops.kernel_launches()

    db = bm.BitmapDB.from_dense(torch.from_numpy(np.ascontiguousarray(dense)).to(dev))
    n_tx, n_items = dense.shape
    print(f"ibm:{args.db} |D|={n_tx} |B|={n_items} sup={args.support} "
          f"P={args.P} reps={args.reps} device={dev}", flush=True)

    # ---- eager family sweep (each call timed on the device) ---------------
    all_t = db.all_tids()
    prefix_tids = all_t[None, :].repeat(8, 1)
    q_masks = db.tx_bits[: min(32, n_tx)]
    fi_masks = db.tx_bits[: min(64, n_tx)]
    half = max(1, n_tx // 2)
    blocks = db.tx_bits[: 2 * half].reshape(2, half, -1)
    t0 = time.perf_counter()
    for _ in range(max(1, args.reps)):
        ops.extension_supports(db.item_bits, all_t)              # bitmap
        ops.multi_extension_supports(db.item_bits, prefix_tids)  # multi
        pair_out = ops.pair_supports(db.item_bits, all_t)        # pair
        ops.subset_superset_counts(q_masks, fi_masks)            # subset
        ops.block_itemset_supports(blocks, fi_masks)             # delta
    device_mod.synchronize(dev)
    eager_s = time.perf_counter() - t0
    print(f"eager sweep: {args.reps} reps x 5 families in {eager_s:.2f}s")

    # ---- a real mine: timed calls + progress --------------------------------
    res = fimi.run(fimi.shard_db(dense, args.P, dev), n_items,
                   mine_params(args.support, n_tx, args.frontier),
                   seed=args.seed, device=dev)
    print(f"|F| = {res.n_fis}  work_iters={res.work_iters.tolist()}")
    if res.progress is not None:
        print(res.progress.line())

    # ---- attribution table --------------------------------------------------
    rep = prof.report()
    m = rep["machine"]
    print(f"machine={m['name']} word_ops_peak={m['word_ops_peak']:.3g} "
          f"hbm_bw={m['hbm_bw']:.3g}")
    for family in obs_profile.FAMILIES:
        fam = rep["families"].get(family)
        if fam is None:
            print(f"  {family:<7} (no dispatches)")
            continue
        frac = fam["achieved_frac"]
        print(f"  {family:<7} calls={fam['calls']:<4d} "
              f"loop_execs={fam['loop_execs']:<6d} "
              f"measured={fam['measured_ms']:.3f}ms "
              f"modeled={fam['modeled_ms']:.3f}ms "
              f"frac={frac if frac is None else round(frac, 4)} "
              f"{'memory' if fam['mem_bound'] else 'compute'}-bound")
    missing = [f for f in obs_profile.FAMILIES
               if rep["families"].get(f, {}).get("measured_ms", 0.0) <= 0.0]
    launches = {k: n - launched_before[k] for k, n in ops.kernel_launches().items()}
    print("kernel launches: " + " ".join(f"{k}={n}" for k, n in launches.items()))
    if obs:
        obs.finish(n_fis=res.n_fis, families=len(rep["families"]))
    else:
        prof.disable()
    if missing:
        print(f"profile_demo: families without measured time: {missing}")
    return DemoRun(result=res, report=rep, missing=missing, launches=launches,
                   pair_out=pair_out, item_bits=db.item_bits, all_tids=all_t,
                   eager_s=eager_s)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    device_mod.resolve(args.device)
    dense = generate_dense(params_from_name(args.db, seed=args.seed))
    return 1 if run(dense, args).missing else 0


if __name__ == "__main__":
    sys.exit(main())

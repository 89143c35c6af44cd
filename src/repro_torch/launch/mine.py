"""Parallel-FIMI launcher of the port: mine an IBM-generator database over P
miners on one device, with the Phase-1 method ``--variant`` names (``seq``,
``par`` or ``reservoir``, the thesis' Methods 1–3; the default is
``reservoir``).

Runs on the card unless ``--device cpu`` is given; without CUDA and without
that flag it raises.  The support sweeps on the card are the hand-written
kernels.

``--trace DIR`` / ``--metrics DIR`` record the run (the reference's run
record, read by its ``obs_report``), ``--profile`` adds the kernel
profiler's attribution to it, ``--torch-profile DIR`` a ``torch.profiler``
trace.  Without them nothing is recorded.

  python -m repro_torch.launch.mine --db T500I0.1P50PL10TL40 --support 0.2 -P 4
  python -m repro_torch.launch.mine --db T500I0.1P50PL10TL40 --support 0.2 --variant seq
  python -m repro_torch.launch.mine --db T500I0.1P50PL10TL40 --support 0.2 \
      --scheduler repl_min --trace RUN --profile
  python -m repro_torch.launch.mine --db T1I0.032P20PL6TL10 --support 0.08 --device cpu
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch import device as device_mod
from repro_torch.core import eclat, fimi
from repro_torch.data.ibm_gen import generate_dense, params_from_name
from repro_torch.obs.session import add_obs_flags, start_session


def mine_params(support: float, n_tx: int, frontier: int, scheduler: str = "lpt",
                alpha: float = 0.5, variant: str = "reservoir") -> fimi.FimiParams:
    """The launcher's pipeline settings (the reference launcher's values)."""
    return fimi.FimiParams(
        variant=variant, min_support_rel=support, alpha=alpha, scheduler=scheduler,
        n_db_sample=min(2048, n_tx), n_fi_sample=1024,
        eclat=eclat.EclatConfig(max_out=1 << 15, max_stack=8192, frontier_size=frontier),
    )


def mine_dense(dense: np.ndarray, *, support: float, P: int = 4, frontier: int = 16,
               scheduler: str = "lpt", alpha: float = 0.5, seed: int = 0,
               device: Optional[str] = None, materialize: bool = False,
               variant: str = "reservoir"):
    """Shard, mine and report one dense database; returns ``(result, wall_s)``."""
    dev = device_mod.resolve(device)
    n_tx = dense.shape[0]
    params = mine_params(support, n_tx, frontier, scheduler, alpha, variant)
    t0 = time.perf_counter()
    res = fimi.run(
        fimi.shard_db(dense, P, dev), dense.shape[1], params,
        seed=seed, device=dev, materialize=materialize,
    )
    device_mod.synchronize(dev)
    return res, time.perf_counter() - t0


def report(res: fimi.FimiResult, wall_s: float) -> None:
    w = res.work_iters.astype(float)
    print(f"|F| = {res.n_fis}  in {wall_s:.2f}s")
    print(f"classes={len(res.classes)}  replication={res.replication:.4f}  "
          f"exchange_overflow={res.exchange_overflow}")
    print(f"phase-4 DFS trips per miner: {res.work_iters.tolist()}  "
          f"balance={w.max() / max(w.mean(), 1):.2f}")
    print(f"phase-1 DFS trips per miner: {res.phase1_iters.tolist()}  "
          f"stack overflow: phase1={res.phase1_overflow.tolist()} "
          f"phase4={res.phase4_overflow.tolist()}")
    if res.variant != "reservoir":
        print(f"phase 1 ({res.variant}): MFI candidates kept per miner "
              f"{res.mfi_count.tolist()}, dropped {res.phase1_overflow.tolist()}; "
              f"|M|={res.n_mfi} coverage-sampled"
              + (" (maximal)" if res.variant == "seq" else ""))
    if res.progress is not None:
        print(res.progress.line() + "  stragglers="
              + ",".join(f"{s:.2f}" for s in res.progress.stragglers))
    print("phase seconds: " + json.dumps({k: round(v, 4) for k, v in res.phase_s.items()}))
    print("kernel launches: " + " ".join(f"{k}={n}" for k, n in res.launches.items()))


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--db", default="T2I0.048P50PL10TL16")
    ap.add_argument("--support", type=float, default=0.1)
    ap.add_argument("--variant", default="reservoir", choices=["seq", "par", "reservoir"],
                    help="Phase-1 method: the thesis' Methods 1-3")
    ap.add_argument("-P", type=int, default=4)
    ap.add_argument("--frontier", type=int, default=16,
                    help="DFS nodes mined per trip (K)")
    ap.add_argument("--scheduler", default="lpt", choices=["lpt", "repl_min"])
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    add_obs_flags(ap)
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    obs = start_session(args, "mine")

    t0 = time.perf_counter()
    dense = generate_dense(params_from_name(args.db, seed=args.seed))
    n_tx, n_items = dense.shape
    print(f"{args.db} |D|={n_tx} |B|={n_items} sup={args.support} "
          f"variant={args.variant} P={args.P} frontier={args.frontier} device={dev}  "
          f"(generated in {time.perf_counter() - t0:.2f}s)")
    res, wall_s = mine_dense(
        dense, support=args.support, P=args.P, frontier=args.frontier,
        scheduler=args.scheduler, alpha=args.alpha, seed=args.seed, device=dev,
        variant=args.variant,
    )
    report(res, wall_s)
    if obs:
        obs.event("mined", n_fis=res.n_fis, wall_s=wall_s,
                  work_iters=res.work_iters.tolist())
        obs.finish(n_fis=res.n_fis, n_tx=n_tx, n_items=n_items,
                   mine_wall_s=wall_s, replication=res.replication)
    return res


if __name__ == "__main__":
    main()

"""Parallel-FIMI launcher of the port: mine a database over P miners, with
the Phase-1 method ``--variant`` names (``seq``, ``par`` or ``reservoir``,
the thesis' Methods 1–3; the default is ``reservoir``).

``--devices N`` with N ≥ P runs the miners as P rank processes, one miner a
rank (``launch/ranks.py``; NCCL on the card, rank r on ``cuda:r``, gloo with
``--device cpu``); rank 0 prints, records and runs ``--parity``.  With a
store each rank reads only its own shard's blocks, through a reader of its
own.  With N < P (the default N = 0)
the P miners share one device.  ``--digest`` prints the FITable's SHA-256, to
compare runs across processes.

Three data sources, as in the JAX launcher:

  * default          — generate the ``--db`` IBM database in RAM;
  * ``--store DIR``  — mine **out of core** from an on-disk TxStore (spilled
    there block by block from ``--db`` first if DIR holds none): the blocks
    stream through pinned host buffers onto the card, within a host budget
    of ``--budget-blocks`` blocks;
  * ``--dataset F.dat`` — ingest a FIMI file into a store (at ``--store``,
    else a temporary directory), then mine it out of core.

``--parity`` is the exactness gate: mine the store's contents once more in
RAM (``store.to_dense()``) and exit 1 on any FITable difference.

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
  python -m repro_torch.launch.mine --db T1I0.032P20PL6TL10 --support 0.08 --device cpu \
      -P 4 --devices 4                      # four gloo ranks
  python -m repro_torch.launch.mine --db T500I0.1P50PL10TL40 --support 0.2 \
      --store DIR --blocktx 65536 --parity
  python -m repro_torch.launch.mine --db T1I0.032P20PL6TL10 --support 0.08 --device cpu \
      --store DIR --blocktx 128 -P 4 --devices 4 --parity
  python -m repro_torch.launch.mine --dataset examples/retail_tiny.dat \
      --support 0.2 -P 2 --parity --device cpu
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch import device as device_mod
from repro_torch.core import eclat, fimi
from repro_torch.launch import ranks
from repro_torch.launch.data_source import resolve_source, store_argv
from repro_torch.obs.session import add_obs_flags, start_session
from repro_torch.store.reader import BlockReader
from repro_torch.store.store import TxStore


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
               variant: str = "reservoir", coll=None):
    """Shard, mine and report one dense database; returns ``(result, wall_s)``.
    ``coll`` is the miners' collectives (default: all P on ``device``)."""
    dev = device_mod.resolve(device)
    n_tx = dense.shape[0]
    params = mine_params(support, n_tx, frontier, scheduler, alpha, variant)
    t0 = time.perf_counter()
    res = fimi.run(
        fimi.shard_db(dense, P, dev, miners=coll.miners if coll is not None else None),
        dense.shape[1], params,
        seed=seed, device=dev, materialize=materialize, coll=coll,
    )
    device_mod.synchronize(dev)
    return res, time.perf_counter() - t0


def mine_store(store: TxStore, *, support: float, P: int = 4, frontier: int = 16,
               scheduler: str = "lpt", alpha: float = 0.5, seed: int = 0,
               device: Optional[str] = None, materialize: bool = False,
               variant: str = "reservoir", reader: Optional[BlockReader] = None,
               coll=None):
    """Mine a store out of core, its shards assembled on the device through
    ``reader`` (a new 2-block reader when None; a rank of ``coll`` assembles
    its own shard alone); returns ``(result, wall_s)``, the wall including
    the assembly."""
    dev = device_mod.resolve(device)
    params = mine_params(support, store.n_tx, frontier, scheduler, alpha, variant)
    t0 = time.perf_counter()
    res = fimi.run(store, None, params, seed=seed, device=dev, materialize=materialize,
                   P=P, reader=reader, coll=coll)
    device_mod.synchronize(dev)
    return res, time.perf_counter() - t0


def parity(got: dict, want: dict) -> bool:
    """Print the FITable comparison; True when the two are equal."""
    if got == want:
        return True
    only_got, only_ref = set(got) - set(want), set(want) - set(got)
    diff = {k for k in set(got) & set(want) if got[k] != want[k]}
    print(f"PARITY FAIL: +{len(only_got)} -{len(only_ref)} support-mismatch={len(diff)}",
          flush=True)
    return False


def report(res: fimi.FimiResult, wall_s: float) -> None:
    w = res.work_iters.astype(float)
    print(f"|F| = {res.n_fis}  in {wall_s:.2f}s  backend={res.backend}")
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
    ap.add_argument("--dataset", default="",
                    help="mine a FIMI .dat file (ingested into a store)")
    ap.add_argument("--store", default="",
                    help="mine out-of-core from this TxStore dir "
                         "(spilled from --db when empty)")
    ap.add_argument("--blocktx", type=int, default=256,
                    help="store block size (rows) when spilling/ingesting")
    ap.add_argument("--budget-blocks", type=int, default=2,
                    help="host block budget of the streamed reader")
    ap.add_argument("--parity", action="store_true",
                    help="verify bit-exact FITable vs the dense in-RAM path")
    ap.add_argument("--support", type=float, default=0.1)
    ap.add_argument("--variant", default="reservoir", choices=["seq", "par", "reservoir"],
                    help="Phase-1 method: the thesis' Methods 1-3")
    ap.add_argument("-P", type=int, default=4)
    ap.add_argument("--devices", type=int, default=0,
                    help="run the P miners as P rank processes when N >= P "
                         "(NCCL on the card, gloo with --device cpu)")
    ap.add_argument("--digest", action="store_true",
                    help="print the FITable's SHA-256")
    ap.add_argument("--frontier", type=int, default=16,
                    help="DFS nodes mined per trip (K)")
    ap.add_argument("--scheduler", default="lpt", choices=["lpt", "repl_min"])
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    add_obs_flags(ap)
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    coll = ranks.from_flags("repro_torch.launch.mine", argv, args.devices, args.P, dev,
                            prepare=lambda a: store_argv(args, a))
    if coll is not None:
        dev = coll.device
    obs = start_session(args, "mine") if coll is None or coll.rank == 0 else None

    t0 = time.perf_counter()
    store, dense, src = resolve_source(args.dataset, args.store, args.db,
                                       block_tx=args.blocktx, seed=args.seed)
    n_tx, n_items = (store.n_tx, store.n_items) if store is not None else dense.shape
    print(f"{src} |D|={n_tx} |B|={n_items} sup={args.support} "
          f"variant={args.variant} P={args.P} frontier={args.frontier} device={dev}  "
          f"({'prepared' if store is not None else 'generated'} in "
          f"{time.perf_counter() - t0:.2f}s)")
    kw = dict(support=args.support, P=args.P, frontier=args.frontier,
              scheduler=args.scheduler, alpha=args.alpha, seed=args.seed, device=dev,
              variant=args.variant)
    materialize = args.parity or args.digest
    if store is not None:
        reader = BlockReader(store, args.budget_blocks, device=dev)
        print(f"store: {store.n_blocks} blocks x <= {store.block_tx} tx "
              f"({store.total_bytes} packed bytes on disk)  "
              f"host budget = {args.budget_blocks} blocks ({reader.budget_bytes} bytes)")
        # the mine's own block stream is the residency measurement: fimi.run
        # assembles the shards through this reader (one pass, no extra I/O)
        res, wall_s = mine_store(store, reader=reader, materialize=materialize, coll=coll,
                                 **kw)
    else:
        res, wall_s = mine_dense(dense, materialize=materialize, coll=coll, **kw)
    report(res, wall_s)
    if args.digest:
        print(f"FITable sha256={fimi.fitable_digest(res.fi_dict)}", flush=True)
    if store is not None:
        if coll is None:
            print(f"streamed host high-water: {reader.peak_host_bytes} bytes "
                  f"(budget {reader.budget_bytes})")
        else:   # each rank's own reader
            peaks = coll.gather_counts([reader.peak_host_bytes]).tolist()
            print(f"streamed host high-water: {max(peaks)} bytes "
                  f"(budget {reader.budget_bytes}; by rank {peaks})")
    if obs:
        obs.event("mined", n_fis=res.n_fis, wall_s=wall_s,
                  work_iters=res.work_iters.tolist())
        obs.finish(n_fis=res.n_fis, n_tx=n_tx, n_items=n_items,
                   mine_wall_s=wall_s, replication=res.replication)
    if coll is not None:
        ranks.finish()
        if coll.rank != 0:
            return res

    # ---- parity gate: out-of-core result == dense in-RAM result ------------
    if args.parity:
        if store is None:
            print("--parity needs --store or --dataset (nothing to compare)")
            sys.exit(2)
        out_of_core = store.total_bytes > reader.budget_bytes
        if not out_of_core:
            print(f"note: store ({store.total_bytes}B) fits the host budget "
                  f"({reader.budget_bytes}B); gate still exact but not "
                  f"out-of-core — use a bigger --db or smaller --blocktx")
        ref, _ = mine_dense(store.to_dense(), materialize=True, **kw)  # O(n_tx) host
        if not parity(res.fi_dict, ref.fi_dict):
            sys.exit(1)
        print(f"parity vs dense in-RAM fimi.run: OK ({len(res.fi_dict)} itemsets"
              + (f", bit-exact supports; store {store.total_bytes}B > "
                 f"host budget {reader.budget_bytes}B)" if out_of_core else ")"),
              flush=True)
    return res


if __name__ == "__main__":
    main()

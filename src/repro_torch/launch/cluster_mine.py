"""Distributed mining launcher of the port: the cluster executor end to end.

Runs planner → exchange → miner rounds → rebalance over P miners, on the
card unless ``--device cpu`` is given (without CUDA and without that flag it
raises): on one device, or with ``--devices N`` (N ≥ P) as P rank processes,
one miner a rank (``launch/ranks.py``: NCCL on the card, gloo on the CPU;
rank 0 prints and records).  It reports:

  * per-phase time (plan / exchange / mine / merge),
  * load imbalance (observed DFS trips, max/mean) and the planner's
    estimation error (predicted vs observed load shares),
  * a speedup-vs-miners curve (``--curve 1,2,4``) in modeled makespan
    (Σ_r max_p trips, the barrier-aware metric) and wall time,
  * exact parity against the port's single-miner ``fimi.run`` (``--parity``;
    exits 1 on any itemset or support mismatch),
  * fault tolerance: ``--checkpoint DIR`` persists the inter-round state
    after every round; ``--resume`` restarts from the latest checkpoint,
    bit-exact with an unbroken run; ``--kill-after-round R`` exits 0 right
    after round R's checkpoint,
  * the kernel launches of the run, summed over the ranks,
  * a live progress line after every round (sample-estimated completion,
    barrier-aware ETA, worst straggler).

``--trace DIR`` / ``--metrics DIR`` / ``--profile`` record the run (the
reference's run record: each round an event, the cluster gauges, the speedup
waterfall's ``speedup/*`` gauges, the spans ``cluster/plan``,
``cluster/exchange``, ``cluster/mine`` and a modeled lane a miner);
``--doctor`` diagnoses it at exit.  Read a record with
``python -m repro_torch.launch.obs_report``.

``--store DIR`` / ``--dataset F.dat`` mine out of core, as in the JAX
launcher: the plan is sampled off disk (``planner.plan`` on the store) and
the shards are assembled on the card block by block through the
double-buffered reader (``phase_ms["assemble"]``); under ``--devices`` each
rank reads its own shard's blocks and the sampled rows that fall in it.
Under ``--devices`` the ``--curve`` points and the ``--parity`` reference
run on rank 0 alone, on its device.

  python -m repro_torch.launch.cluster_mine --db T500I0.1P50PL10TL40 --support 0.2 -P 4
  python -m repro_torch.launch.cluster_mine --db T1I0.032P20PL6TL10 --support 0.08 \\
      --device cpu --parity [--checkpoint DIR [--resume | --kill-after-round R]]
  python -m repro_torch.launch.cluster_mine --db T1I0.032P20PL6TL10 --support 0.08 \
      --device cpu -P 4 --devices 4 --trace RUN --doctor
  python -m repro_torch.launch.cluster_mine --dataset examples/retail_tiny.dat \\
      --support 0.2 -P 2 --parity --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Optional, Sequence

import numpy as np

from repro_torch import cluster
from repro_torch import device as device_mod
from repro_torch.core import eclat, fimi
from repro_torch.launch import ranks
from repro_torch.launch.data_source import resolve_source, store_argv
from repro_torch.obs.session import add_obs_flags, start_session
from repro_torch.store.reader import to_device_shards
from repro_torch.store.store import TxStore


def _skew_plan(plan: cluster.MiningPlan) -> cluster.MiningPlan:
    """Fault injection (``--force-skew``): pile every class onto miner 0.

    The estimated loads move with the assignment, so the skew is planned and
    predicted: pure imbalance, zero estimation error.
    """
    est_loads = np.zeros_like(plan.est_loads)
    if est_loads.shape[0]:
        est_loads[0] = float(np.sum(plan.est_loads))
    return dataclasses.replace(plan, assignment=np.zeros_like(plan.assignment),
                               est_loads=est_loads)


def cluster_params(args, n_tx: int, use_mxu: bool = False) -> cluster.ClusterParams:
    """The launcher's executor settings (the reference launcher's values)."""
    return cluster.ClusterParams(
        planner=cluster.PlannerParams(
            min_support_rel=args.support, alpha=args.alpha, scheduler=args.scheduler,
            n_db_sample=min(2048, n_tx), n_fi_sample=1024,
        ),
        eclat=eclat.EclatConfig(max_out=1 << 15, max_stack=8192, frontier_size=args.frontier),
        chunk=args.chunk or None,
        # --force-skew also pins rebalancing off: the injected skew must
        # survive to the report
        rebalance=not (args.no_rebalance or args.force_skew),
        skew_threshold=args.skew,
        use_mxu=use_mxu,
    )


def run_once(dense: Optional[np.ndarray], P: int, args, dev, use_mxu: bool = False,
             store: Optional[TxStore] = None, coll=None, progress_cb=None):
    """One executor run at P miners; returns ``(result, wall seconds)``.

    ``use_mxu`` is ``ClusterParams.use_mxu`` (Phase 4 on kernel B2); the
    command line has no flag for it, as the JAX launcher has none.  With
    ``store`` set the plan is computed off disk and the shards are
    assembled block by block through the reader; ``dense`` is used only
    otherwise.  ``coll`` is the miners' collectives (default: all P on
    ``dev``), ``progress_cb`` gets the executor's snapshot after every round.
    """
    n_tx, n_items = (store.n_tx, store.n_items) if store is not None else dense.shape
    params = cluster_params(args, n_tx, use_mxu)
    t0 = time.perf_counter()
    plan, phase_ms = None, {}
    if store is not None:
        plan = cluster.plan(store, None, params.planner, seed=args.seed, device=dev, P=P,
                            coll=coll)
        t1 = time.perf_counter()
        shards = to_device_shards(store, P, miners=coll.miners if coll is not None else None,
                                  device=dev)
        device_mod.synchronize(dev)
        phase_ms = {"plan": (t1 - t0) * 1e3, "assemble": (time.perf_counter() - t1) * 1e3}
    else:
        shards = fimi.shard_db(dense, P, dev, miners=coll.miners if coll is not None else None)
        if args.force_skew:
            plan = cluster.plan(shards, n_items, params.planner, seed=args.seed, device=dev,
                                coll=coll)
            phase_ms = {"plan": (time.perf_counter() - t0) * 1e3}
    if args.force_skew:
        plan = _skew_plan(plan)
    res = cluster.execute(
        shards, n_items, params, seed=args.seed, device=dev, plan=plan,
        checkpoint_dir=args.checkpoint or None, resume=args.resume,
        round_hook=_kill_hook(args.kill_after_round), progress_cb=progress_cb, coll=coll,
    )
    # execute() saw a precomputed plan: charge the planning (and the
    # block-streamed assembly) where they ran, and re-set the gauges so the
    # waterfall counts them as host work
    if phase_ms:
        res.report.phase_ms.update(phase_ms)
        res.report.republish_gauges()
    device_mod.synchronize(dev)
    return res, time.perf_counter() - t0


def _kill_hook(kill_at: int):
    """Round hook that simulates a death mid-run."""
    if kill_at < 0:
        return None

    def hook(r: int) -> None:
        if r >= kill_at:
            print(f"KILLED after round {r} (checkpoint saved) — "
                  f"rerun with --resume to finish", flush=True)
            sys.exit(0)

    return hook


def report(res: cluster.ClusterResult, wall_s: float) -> None:
    rep, plan = res.report, res.plan
    print(f"|F| = {res.table.n_fis}  in {wall_s:.2f}s  backend={rep.backend}  "
          f"rounds={rep.n_rounds}  scheduler={plan.scheduler_used}")
    print("per-phase ms: " + "  ".join(f"{k}={v:.0f}" for k, v in rep.phase_ms.items()))
    replication = np.mean([r.replication for r in rep.rounds]) if rep.rounds else 0.0
    print(f"classes={len(plan.classes)}  "
          f"volume lpt={plan.lpt_volume:.0f} repl_min={plan.repl_volume:.0f}  "
          f"replication/round={replication:.2f}")
    print(f"load: observed trips={rep.observed_loads.astype(int).tolist()}  "
          f"imbalance={rep.imbalance:.2f}  "
          f"estimation_error={rep.estimation_error():.3f}  "
          f"donations={len(rep.donations)}")
    print("kernel launches: " + " ".join(f"{k}={n}" for k, n in res.launches.items()),
          flush=True)


def parity(res: cluster.ClusterResult, dense: np.ndarray, args, dev) -> bool:
    """The FITable against the port's single-miner ``fimi.run``."""
    fp = fimi.FimiParams(
        min_support_rel=args.support, n_db_sample=min(2048, dense.shape[0]),
        n_fi_sample=1024,
        eclat=eclat.EclatConfig(max_out=1 << 15, max_stack=8192, frontier_size=args.frontier),
    )
    ref = fimi.run(fimi.shard_db(dense, 1, dev), dense.shape[1], fp, seed=args.seed,
                   device=dev, materialize=True)
    got = res.table.to_dict()
    if got != ref.fi_dict:
        only_got = set(got) - set(ref.fi_dict)
        only_ref = set(ref.fi_dict) - set(got)
        diff = {k for k in set(got) & set(ref.fi_dict) if got[k] != ref.fi_dict[k]}
        print(f"PARITY FAIL: +{len(only_got)} -{len(only_ref)} "
              f"support-mismatch={len(diff)}", flush=True)
        return False
    print(f"parity vs single-device fimi.run: OK "
          f"({len(got)} itemsets, bit-exact supports)", flush=True)
    return True


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--db", default="T2I0.048P50PL10TL16")
    ap.add_argument("--dataset", default="",
                    help="mine a FIMI .dat file (ingested into a store)")
    ap.add_argument("--store", default="",
                    help="mine out-of-core from this TxStore dir "
                         "(spilled from --db when empty)")
    ap.add_argument("--blocktx", type=int, default=256,
                    help="store block size (rows) when spilling/ingesting")
    ap.add_argument("--support", type=float, default=0.1)
    ap.add_argument("-P", type=int, default=4)
    ap.add_argument("--devices", type=int, default=0,
                    help="run the P miners as P rank processes when N >= P "
                         "(NCCL on the card, gloo with --device cpu)")
    ap.add_argument("--digest", action="store_true",
                    help="print the FITable's SHA-256")
    ap.add_argument("--scheduler", default="auto", choices=["auto", "lpt", "repl_min"])
    ap.add_argument("--alpha", type=float, default=0.5)
    ap.add_argument("--frontier", type=int, default=16,
                    help="DFS nodes mined per trip (K)")
    ap.add_argument("--chunk", type=int, default=0,
                    help="classes per miner per round (0 = auto)")
    ap.add_argument("--skew", type=float, default=1.25,
                    help="rebalance when remaining max/mean exceeds this")
    ap.add_argument("--no-rebalance", action="store_true")
    ap.add_argument("--force-skew", action="store_true",
                    help="fault injection: assign every class to miner 0 and "
                         "disable rebalancing")
    ap.add_argument("--curve", default="",
                    help="comma-separated miner counts for a speedup curve")
    ap.add_argument("--parity", action="store_true",
                    help="verify exact FI parity vs single-miner fimi.run")
    ap.add_argument("--checkpoint", default="",
                    help="persist inter-round state to this dir after every round")
    ap.add_argument("--resume", action="store_true",
                    help="restart from the latest checkpoint in --checkpoint")
    ap.add_argument("--kill-after-round", type=int, default=-1, metavar="R",
                    help="simulate a crash: exit 0 right after round R's checkpoint")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    add_obs_flags(ap)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Optional[cluster.ClusterResult]:
    args = build_parser().parse_args(argv)
    dev = device_mod.resolve(args.device)
    coll = ranks.from_flags("repro_torch.launch.cluster_mine", argv, args.devices, args.P, dev,
                            prepare=lambda a: store_argv(args, a))
    if coll is not None:
        dev = coll.device
    lead = coll is None or coll.rank == 0
    obs = start_session(args, "cluster_mine") if lead else None

    t0 = time.perf_counter()
    store, dense, src = resolve_source(args.dataset, args.store, args.db,
                                       block_tx=args.blocktx, seed=args.seed)
    n_tx, n_items = (store.n_tx, store.n_items) if store is not None else dense.shape
    print(f"{src} |D|={n_tx} |B|={n_items} sup={args.support} P={args.P} "
          f"device={dev} rebalance={not args.no_rebalance} scheduler={args.scheduler}  "
          f"({'prepared' if store is not None else 'generated'} in "
          f"{time.perf_counter() - t0:.2f}s)", flush=True)
    if store is not None:
        print(f"store: {store.n_blocks} blocks x <= {store.block_tx} tx "
              f"({store.total_bytes} packed bytes; plan sampled off-disk)", flush=True)

    # the live line: sample-estimated completion, barrier-aware ETA and the
    # worst straggler, at every round boundary
    res, wall = run_once(dense, args.P, args, dev, store=store, coll=coll,
                         progress_cb=lambda s: print("  " + s.line(), flush=True))
    report(res, wall)
    if args.digest:
        print(f"FITable sha256={fimi.fitable_digest(res.table.to_dict())}", flush=True)
    rep = res.report
    if obs:
        for r in rep.rounds:
            obs.event("round", index=r.round_index, classes_mined=r.classes_mined,
                      work_iters=r.work_iters.tolist(), replication=r.replication,
                      donations=len(r.donations))
        obs.finish(n_fis=res.table.n_fis, mine_wall_s=wall, rounds=rep.n_rounds,
                   backend=rep.backend, imbalance=rep.imbalance,
                   makespan_trips=rep.makespan_trips,
                   estimation_error=rep.estimation_error())
    if coll is not None:
        ranks.finish()
        if not lead:
            return res

    if args.curve:
        counts = [int(c) for c in args.curve.split(",") if c]
        base = None
        print("speedup curve (modeled makespan = sum of per-round max trips):")
        for Pc in counts:
            r, w = run_once(dense, Pc, args, dev, store=store)
            mk = r.report.makespan_trips
            base = mk if base is None else base
            print(f"  P={Pc:<3d} makespan={mk:>8.0f} trips  "
                  f"speedup={base / max(mk, 1):.2f}x  wall={w:.2f}s  "
                  f"imbalance={r.report.imbalance:.2f}")

    if args.parity:
        if dense is None:
            dense = store.to_dense()  # O(n_tx) host: the parity reference only
        if not parity(res, dense, args, dev):
            sys.exit(1)
    return res


if __name__ == "__main__":
    main()

"""Streaming launcher of the port: ingest a drifting stream while serving.

Transactions arrive in blocks, the sliding window advances, mined supports
are delta-updated in place (one arrive/expire sweep of kernel B5 per block),
and the drift monitor decides when the serving table is stale enough to
re-mine; the window is then re-mined with the port's Parallel-FIMI pipeline
(or, with ``--cluster N``, the cluster executor over N miners) and the
serving indexes are hot-swapped under live traffic.  ``--spill DIR``
persists every block the window evicts into a store at DIR (resumed if one
is there), re-minable with ``mine --store DIR``.  Between admits
a Zipf-hot workload of support lookups is served through the engine (kernel
B4) and the LRU cache, whose keys carry the swap generation.  Runs on the
card unless ``--device cpu`` is given; without CUDA and without that flag it
raises.

Reports ingest throughput, re-mines by trigger reason, swap latency,
staleness (max support error of the served table against a full recompute of
the window), serving QPS and cache hit rate, the torn-index parity check
(engine against the index's own supports before and after every swap: must
be 0), the delta check (the delta-maintained supports against the full
recompute after every block: must be 0), and the kernel launches of the run.

  python -m repro_torch.launch.stream_mine --db T500I0.1P50PL10TL40 --support 0.2 \\
      --blocks 8 --blocktx 65536 --stream 24 --breaks 12 --minconf 0.6
  python -m repro_torch.launch.stream_mine --support 0.12 --blocks 8 --blocktx 256 \\
      --stream 24 --breaks 12 --device cpu [--cluster 4] [--spill DIR] [--trace DIR]

The reference's ``--force`` (a kernel backend pin) has no counterpart: the
tensors' device picks the sweep, and ``--device`` picks the device.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np

from repro_torch import cluster as cluster_mod
from repro_torch import device as device_mod
from repro_torch.core import bitmap as bm
from repro_torch.core import eclat, fimi
from repro_torch.data.ibm_gen import drifting_stream, params_from_name
from repro_torch.kernels import ops
from repro_torch.obs.session import add_obs_flags, start_session
from repro_torch.serve.cache import query_key
from repro_torch.stream import StreamingMiner, StreamParams, fimi_mine_fn


def parity_failures(sm, rng, n_probe=32) -> int:
    """Torn-index check: engine answers against the host-read index itself.

    Every indexed itemset must look up at exactly its indexed support; a
    torn swap (old FI masks against new supports, or half-published state)
    breaks this at once.
    """
    idx = sm.engine.index
    if idx.n_fis == 0:
        return 0
    pick = rng.choice(idx.n_fis, size=min(n_probe, idx.n_fis), replace=False)
    masks = bm.to_reference(idx.masks)[pick]
    want = idx.supports.cpu().numpy()[pick]
    got = sm.engine.support(masks)
    return int((got != want).sum())


def serve_block(sm, rng, n_queries, zipf_a=1.3):
    """Serve a Zipf-hot batch of support lookups through cache + engine."""
    idx = sm.engine.index
    if idx.n_fis == 0 or n_queries == 0:
        return 0.0, 0
    rows = np.minimum(rng.zipf(zipf_a, size=n_queries) - 1, idx.n_fis - 1).astype(np.int64)
    masks = bm.to_reference(idx.masks)[rows]
    gen = sm.engine.generation
    keys = [query_key("support", m, sm.engine.top_k, gen) for m in masks]
    t0 = time.perf_counter()
    results, miss = sm.cache.split_batch(keys)
    # dispatch misses in batch-width chunks, then resolve the whole batch in
    # ONE fill (fill_batch resolves every pending None from the values it is
    # given, so partial fills would KeyError on keys of later chunks)
    vals = []
    for lo in range(0, len(miss), sm.engine.batch):
        part = miss[lo: lo + sm.engine.batch]
        vals.extend(sm.engine.support(masks[part]))
    sm.cache.fill_batch(keys, results, miss, vals)
    return time.perf_counter() - t0, len(miss)


@dataclasses.dataclass
class StreamRun:
    """What one streaming run produced."""

    miner: StreamingMiner
    events: list                      # (AdmitEvent, segment) per block
    remine_log: list                  # (block, segment, reason, mine_ms, swap_ms, F)
    torn: int                         # torn-index parity failures
    delta_mismatches: int             # blocks whose delta supports ≠ the recompute
    delta_checks: int                 # blocks checked
    max_staleness: float
    ingest_s: float
    serve_s: float
    n_served: int
    n_dispatched: int
    launches: Dict[str, int]          # kernel launches of the run


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--db", default="T2I0.048P50PL10TL16",
                    help="IBM generator family (n_tx field sets nothing; "
                         "the stream length does)")
    ap.add_argument("--support", type=float, default=0.12)
    ap.add_argument("--blocks", type=int, default=8,
                    help="sliding-window length B in blocks")
    ap.add_argument("--blocktx", type=int, default=256,
                    help="transactions per stream block")
    ap.add_argument("--stream", type=int, default=32, help="total blocks to replay")
    ap.add_argument("--breaks", default="16",
                    help="comma-separated block indices of concept drift")
    ap.add_argument("--eps", type=float, default=0.1,
                    help="staleness tolerance ε (Thm 6.1 monitor)")
    ap.add_argument("--delta", type=float, default=0.05)
    ap.add_argument("--margin", type=float, default=0.02,
                    help="border tracking width around minsup (0 disables)")
    ap.add_argument("--hysteresis", type=float, default=0.02,
                    help="border crossing must clear minsup by this much")
    ap.add_argument("--check-every", type=int, default=1)
    ap.add_argument("--cooldown", type=int, default=2,
                    help="blocks after a re-mine before triggers re-arm")
    ap.add_argument("-P", type=int, default=4, help="miners for re-mining")
    ap.add_argument("--cluster", type=int, default=0, metavar="N",
                    help="re-mine with the distributed cluster executor over "
                         "N miners (planner + exchange + shard-mine + "
                         "rebalance) instead of the in-process fimi.run")
    ap.add_argument("--frontier", type=int, default=16)
    ap.add_argument("--queries", type=int, default=512,
                    help="queries served per ingested block")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--minconf", type=float, default=0.6)
    ap.add_argument("--cache", type=int, default=2048)
    ap.add_argument("--spill", default="", metavar="DIR",
                    help="persist expired window blocks to a TxStore at DIR")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    add_obs_flags(ap)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Optional[StreamRun]:
    ap = build_parser()
    args = ap.parse_args(argv)
    dev = device_mod.resolve(args.device)
    gen_params = params_from_name(args.db, seed=args.seed)
    breaks = tuple(int(b) for b in args.breaks.split(",") if b != "")
    n_items = gen_params.n_items
    window_tx = args.blocks * args.blocktx
    if args.cluster and window_tx % args.cluster:
        ap.error(f"--cluster {args.cluster} must divide the window size "
                 f"({args.blocks} blocks x {args.blocktx} tx = {window_tx})")
    obs = start_session(args, "stream_mine")

    dfs = eclat.EclatConfig(max_out=1 << 15, max_stack=8192, frontier_size=args.frontier)
    if args.cluster:
        mine_fn = cluster_mod.cluster_mine_fn(
            P=args.cluster,
            cluster_params=cluster_mod.ClusterParams(
                planner=cluster_mod.PlannerParams(
                    n_db_sample=min(2048, window_tx), n_fi_sample=1024),
                eclat=dfs,
            ),
            seed=args.seed,
        )
    else:
        mine_fn = fimi_mine_fn(
            P=args.P,
            fimi_params=fimi.FimiParams(n_db_sample=min(2048, window_tx), n_fi_sample=1024,
                                        eclat=dfs),
            seed=args.seed,
        )
    sp = StreamParams(
        n_blocks=args.blocks, block_tx=args.blocktx,
        min_support_rel=args.support, min_confidence=args.minconf,
        eps=args.eps, delta=args.delta, border_margin=args.margin,
        border_hysteresis=args.hysteresis, check_every=args.check_every,
        cooldown_blocks=args.cooldown,
        batch=args.batch, top_k=args.topk, cache_capacity=args.cache,
        spill_dir=args.spill or None, seed=args.seed,
    )
    sm = StreamingMiner(sp, n_items, mine_fn=mine_fn, device=dev)
    print(f"stream: db-family={args.db} |B|={n_items} window={args.blocks}"
          f"x{args.blocktx}tx sup={args.support} eps={args.eps} "
          f"breaks={breaks} stream={args.stream} blocks device={dev}", flush=True)

    rng = np.random.default_rng(args.seed + 1)
    before = ops.kernel_launches()
    ingest_s = serve_s = 0.0
    n_served = n_dispatched = torn = delta_mismatches = delta_checks = 0
    max_stale = 0.0
    events: List = []
    remine_log: List = []
    prev_gen = -1
    for dense_block, segment in drifting_stream(
        gen_params, n_blocks=args.stream, block_tx=args.blocktx, breaks=breaks,
    ):
        if sm.engine is not None:
            torn += parity_failures(sm, rng)     # before a potential swap
        t0 = time.perf_counter()
        ev = sm.admit(dense_block)
        device_mod.synchronize(dev)
        ingest_s += time.perf_counter() - t0
        events.append((ev, segment))
        if ev.remined:
            post = parity_failures(sm, rng)      # after the swap
            torn += post
            if args.cluster:
                # a distributed re-mine must preserve the serving invariants:
                # the swap is atomic (no torn index) and bumps the generation
                if post:
                    raise RuntimeError(
                        f"cluster re-mine broke index parity ({post} failures)")
                if ev.generation != prev_gen + 1:
                    raise RuntimeError(f"cluster re-mine generation {ev.generation} "
                                       f"!= {prev_gen + 1}")
            remine_log.append((ev.block_index, segment, ev.remine_reason, ev.mine_ms,
                               ev.swap_ms, sm.engine.index.n_fis))
            if obs:
                obs.event(
                    "remine", block=ev.block_index, segment=segment,
                    reason=ev.remine_reason, mine_ms=ev.mine_ms,
                    swap_ms=ev.swap_ms, generation=ev.generation,
                    n_fis=sm.engine.index.n_fis,
                )
            print(f"  block {ev.block_index:>3} (segment {segment}): "
                  f"re-mine [{ev.remine_reason}] -> F={sm.engine.index.n_fis} "
                  f"R={sm.engine.rules.n_rules} gen={ev.generation} "
                  f"mine={ev.mine_ms:.0f}ms swap={ev.swap_ms:.2f}ms", flush=True)
        prev_gen = sm.engine.generation if sm.engine else -1
        if sm.engine is not None:
            # off the clock: one full recompute of the window checks the
            # delta-maintained supports and measures the staleness
            exact = sm.exact_window_supports()
            delta_checks += 1
            delta_mismatches += int(not np.array_equal(exact, sm.current_supports))
            max_stale = max(max_stale, sm.staleness(exact))
            dt, nd = serve_block(sm, rng, args.queries)
            serve_s += dt
            n_served += args.queries
            n_dispatched += nd
    launches = {k: n - before[k] for k, n in ops.kernel_launches().items()}

    s = sm.stats
    print(f"ingest: {s.tx_in} tx in {ingest_s:.3f}s -> "
          f"{s.tx_in / ingest_s:,.0f} tx/s "
          f"({s.blocks_in} blocks, delta-updated supports)")
    if sm.engine is None:
        print(f"no mine: stream ended after {s.blocks_in} blocks, window "
              f"needs {args.blocks} to fill (raise --stream)")
        if obs:
            obs.finish(**s.as_dict())
        return None
    reasons = {
        "initial": s.remines - s.fired_error - s.fired_border - s.fired_recovery,
        "error": s.fired_error, "border": s.fired_border,
        "recovery": s.fired_recovery,
    }
    print(f"re-mine: {s.remines} total ({reasons}), "
          f"mine mean={np.mean(s.mine_ms):.0f}ms, "
          f"swap p100={np.max(s.swap_ms):.2f}ms")
    print(f"staleness: max |served - true| = {max_stale:.4f} "
          f"(tolerance eps={args.eps})")
    if n_served:
        print(f"serve: {n_served} queries in {serve_s:.3f}s -> "
              f"{n_served / serve_s:,.0f} QPS "
              f"({n_dispatched} engine dispatches after cache)")
    es = sm.engine.stats()
    print(f"engine: generation={es['generation']} F={es['n_fis']} "
          f"R={es['n_rules']} cache hit_rate={es['hit_rate']:.1%} "
          f"invalidations={es['invalidations']}")
    print(f"torn-index parity failures: {torn}"
          + ("  <-- BUG" if torn else "  (zero = atomic swaps)"))
    print(f"delta supports vs full recompute: {delta_mismatches} of {delta_checks} "
          "blocks differ" + ("  <-- BUG" if delta_mismatches else ""))
    print("kernel launches: " + " ".join(f"{k}={n}" for k, n in launches.items()))
    if obs:
        obs.finish(
            **s.as_dict(), max_staleness=max_stale, torn=torn,
            ingest_wall_s=ingest_s, serve_wall_s=serve_s,
            n_served=n_served, generation=sm.engine.generation,
        )
    if sm.spill is not None:
        hist = sm.spill.store()
        print(f"spill: {hist.n_blocks} expired blocks persisted to "
              f"{args.spill} ({hist.n_tx} tx, {hist.total_bytes} packed "
              f"bytes) — re-minable via `launch.mine --store`")
    return StreamRun(sm, events, remine_log, torn, delta_mismatches, delta_checks, max_stale,
                     ingest_s, serve_s, n_served, n_dispatched, launches)


if __name__ == "__main__":
    main()

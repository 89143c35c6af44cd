"""Mine-then-serve launcher of the port: the store-owner scenario end to end.

Mines a named IBM database with the port's Parallel-FIMI pipeline, builds the
serving indexes (FI table → packed FI index, ap-genrules → rule index), then
replays a synthetic query workload through the batched engine with an LRU
cache in front and reports QPS, batch-latency percentiles, the cache hit
rate, and the kernel launches of the replay.  Runs on the card unless
``--device cpu`` is given; without CUDA and without that flag it raises.  On
the card every query dispatch runs kernel B4.

The workload is the reference launcher's, draw for draw: a fixed population
of distinct queries per kind (support lookups, basket → rules, itemset →
supersets) drawn with a Zipf-tilted popularity from numpy's generator, so
one FITable gives one query stream in either package.

``--devices N`` with N ≥ P mines across P rank processes, one miner a rank
(``launch/ranks.py``: NCCL on the card, gloo with ``--device cpu``); rank 0
then builds the indexes and serves alone.

  python -m repro_torch.launch.serve_mine --db T500I0.1P50PL10TL40 --support 0.2
  python -m repro_torch.launch.serve_mine --db T1I0.032P20PL6TL10 --support 0.08 --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from repro_torch import device as device_mod
from repro_torch.core.rules import format_rule, pack_itemsets
from repro_torch.data.ibm_gen import generate_dense, params_from_name
from repro_torch.kernels import ops
from repro_torch.launch import mine, ranks
from repro_torch.obs.session import add_obs_flags, start_session
from repro_torch.serve import QueryCache, QueryEngine
from repro_torch.serve.cache import query_key
from repro_torch.serve.index import FIIndex, RuleIndex, build_indexes

KINDS = ("support", "rules", "superset")


def build_workload(rng, fis, dense, n_items, n_queries, pool=64, zipf_a=1.3):
    """A query stream [(kind, packed uint32 mask row)] with Zipf-hot
    repetition: the reference's draws, in the reference's order."""
    fi_list = sorted(fis, key=lambda s: (len(s), tuple(sorted(s))))
    pools = {}
    # support: indexed FIs plus a sprinkle of (likely) non-frequent probes
    cand = [fi_list[i] for i in rng.choice(len(fi_list),
                                           size=min(pool, len(fi_list)),
                                           replace=False)]
    probes = [
        frozenset(rng.choice(n_items, size=min(6, n_items), replace=False)
                  .tolist())
        for _ in range(max(pool // 8, 1))
    ]
    pools["support"] = cand + probes
    # rules: real baskets — transaction rows of the database
    rows = rng.choice(dense.shape[0], size=min(pool, dense.shape[0]),
                      replace=False)
    pools["rules"] = [frozenset(np.nonzero(dense[t])[0].tolist())
                      for t in rows]
    # superset: small frequent prefixes (completion queries)
    small = [s for s in fi_list if len(s) <= 2] or fi_list[:1]
    pools["superset"] = [small[i] for i in
                         rng.choice(len(small),
                                    size=min(pool, len(small)),
                                    replace=False)]

    packed = {k: pack_itemsets(v, n_items) for k, v in pools.items()}
    mix = rng.choice(len(KINDS), size=n_queries, p=[0.5, 0.3, 0.2])
    stream = []
    for kind_id in mix:
        kind = KINDS[kind_id]
        n = packed[kind].shape[0]
        # Zipf-tilted popularity over the pool (hot queries repeat)
        i = min(int(rng.zipf(zipf_a)) - 1, n - 1)
        stream.append((kind, packed[kind][i]))
    return stream


def _dispatchers(engine):
    """Per-kind batched dispatch: packed masks [n, IW] -> n result values."""
    return {
        "support": lambda m: list(engine.support(m)),
        "rules": lambda m: list(zip(*map(list, engine.rules_for(m)))),
        "superset": lambda m: list(zip(*map(list, engine.supersets(m)))),
    }


def warm(stream, engine):
    """Run each query kind once off the clock (deploy-time warm)."""
    dispatch = _dispatchers(engine)
    for kind in KINDS:
        mask = next((m for k, m in stream if k == kind), None)
        if mask is not None:
            dispatch[kind](mask[None])


def replay(stream, engine, cache, batch):
    """Serve the stream in fixed-width batches.

    Returns the latency of each batch [s], the queries dispatched to the
    engine after the cache, and the answer to every query of the stream, in
    stream order.
    """
    dispatch = _dispatchers(engine)
    latencies = []
    answers: List[Any] = [None] * len(stream)
    n_dispatched = 0
    for lo in range(0, len(stream), batch):
        chunk = stream[lo: lo + batch]
        t0 = time.perf_counter()
        for kind in KINDS:
            rows = [(i, m) for i, (k, m) in enumerate(chunk) if k == kind]
            if not rows:
                continue
            # keys carry the swap generation: a hot-swapped index (the
            # streaming subsystem) can never serve a stale cached hit
            keys = [query_key(kind, m, engine.top_k, engine.generation)
                    for _, m in rows]
            results, miss = cache.split_batch(keys)
            if miss:
                masks = np.stack([rows[j][1] for j in miss])
                vals = dispatch[kind](masks)
                n_dispatched += len(miss)
                cache.fill_batch(keys, results, miss, vals)
            for (i, _), value in zip(rows, results):
                answers[lo + i] = value
        latencies.append(time.perf_counter() - t0)
    return latencies, n_dispatched, answers


@dataclasses.dataclass
class ServeRun:
    """What one mine-then-serve run produced."""

    fis: Dict[frozenset, int]
    n_tx: int
    fi_index: FIIndex
    rule_index: RuleIndex
    engine: QueryEngine
    cache: QueryCache
    stream: list
    latencies: List[float]          # seconds per replayed batch
    n_dispatched: int
    answers: list                   # one per query of the stream
    mine_s: float
    index_s: float
    serve_s: float
    launches: Dict[str, int]        # kernel launches of the warm and the replay


def run(dense: np.ndarray, args, device, obs=None, coll=None) -> Optional[ServeRun]:
    """Mine ``dense``, build the indexes, warm and replay the workload;
    ``obs`` (a :func:`start_session` session) gets the ``served`` event and
    the sealed record.  With ``coll`` (a rank's collectives) the mine runs
    across the ranks and only rank 0 goes on to serve; the others return
    None."""
    dev = device_mod.resolve(device)
    n_tx, n_items = dense.shape
    print(f"mine: db={args.db} |D|={n_tx} |B|={n_items} sup={args.support} "
          f"variant={args.variant} P={args.P} frontier={args.frontier} device={dev}",
          flush=True)
    res, mine_s = mine.mine_dense(dense, support=args.support, P=args.P,
                                  frontier=args.frontier, seed=args.seed,
                                  device=dev, materialize=True, variant=args.variant,
                                  coll=coll)
    fis = res.fi_dict
    print(f"mine: |F| = {len(fis)} in {mine_s:.2f}s  backend={res.backend}")
    if coll is not None:
        ranks.finish()
        if coll.rank != 0:
            return None

    # ---- index + rules ------------------------------------------------------
    t0 = time.perf_counter()
    fi_index, rule_index = build_indexes(fis, n_items, n_tx,
                                         min_confidence=args.minconf, device=dev)
    device_mod.synchronize(dev)
    index_s = time.perf_counter() - t0
    print(f"index: F={fi_index.n_fis} itemsets "
          f"(max size {fi_index.max_size}, {fi_index.n_words} words/mask), "
          f"R={rule_index.n_rules} rules @ conf>={args.minconf} "
          f"in {index_s:.2f}s")

    # ---- serve --------------------------------------------------------------
    cache = QueryCache(capacity=args.cache)
    engine = QueryEngine(fi_index, rule_index, batch=args.batch,
                         top_k=args.topk, cache=cache)
    rng = np.random.default_rng(args.seed + 1)
    stream = build_workload(rng, fis, dense, n_items, args.queries,
                            pool=args.pool)
    before = ops.kernel_launches()
    # warm every query kind off the clock (a real server warms at deploy
    # time), then replay the measured workload
    warm(stream, engine)
    t0 = time.perf_counter()
    latencies, n_dispatched, answers = replay(stream, engine, cache, args.batch)
    serve_s = time.perf_counter() - t0
    launches = {k: n - before[k] for k, n in ops.kernel_launches().items()}

    lat = np.asarray(latencies) * 1e3
    qps = len(stream) / serve_s
    print(f"serve: {len(stream)} queries in {serve_s:.3f}s -> {qps:,.0f} QPS "
          f"(batch={args.batch}, {len(latencies)} dispatch rounds, "
          f"{n_dispatched} engine queries after cache)")
    print(f"serve: batch latency ms p50={np.percentile(lat, 50):.2f} "
          f"p95={np.percentile(lat, 95):.2f} "
          f"p99={np.percentile(lat, 99):.2f} max={lat.max():.2f}")
    s = cache.stats
    print(f"cache: {s.hits}/{s.lookups} hits ({s.hit_rate:.1%}), "
          f"{s.evictions} evictions, {s.invalidations} invalidations, "
          f"{len(cache)} resident")
    es = engine.stats()
    print(f"engine: generation={es['generation']} (index hot-swaps; see "
          f"repro_torch.launch.stream_mine) F={es['n_fis']} R={es['n_rules']}")
    print("kernel launches (warm + replay): "
          + " ".join(f"{k}={n}" for k, n in launches.items()))
    if obs:
        obs.event("served", queries=len(stream), dispatched=n_dispatched,
                  qps=qps)
        obs.finish(
            n_fis=fi_index.n_fis, n_rules=rule_index.n_rules, qps=qps,
            serve_wall_s=serve_s,
            batch_p50_ms=float(np.percentile(lat, 50)),
            batch_p95_ms=float(np.percentile(lat, 95)),
            batch_p99_ms=float(np.percentile(lat, 99)),
            cache_hit_rate=s.hit_rate,
        )

    # a taste of the product: the most confident rules overall
    print(f"top-{min(5, rule_index.n_rules)} rules by confidence:")
    for r in range(min(5, rule_index.n_rules)):
        print("  " + format_rule(rule_index.rule(r), n_tx))
    return ServeRun(fis, n_tx, fi_index, rule_index, engine, cache, stream,
                    latencies, n_dispatched, answers, mine_s, index_s, serve_s,
                    launches)


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--db", default="T2I0.048P50PL10TL16")
    ap.add_argument("--support", type=float, default=0.1)
    ap.add_argument("--variant", default="reservoir", choices=["seq", "par", "reservoir"],
                    help="Phase-1 method: the thesis' Methods 1-3")
    ap.add_argument("-P", type=int, default=4)
    ap.add_argument("--devices", type=int, default=0,
                    help="mine across P rank processes when N >= P (NCCL on "
                         "the card, gloo with --device cpu); rank 0 serves")
    ap.add_argument("--frontier", type=int, default=16,
                    help="DFS nodes mined per trip (K)")
    ap.add_argument("--queries", type=int, default=1024)
    ap.add_argument("--batch", type=int, default=256,
                    help="queries per engine dispatch")
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--minconf", type=float, default=0.5)
    ap.add_argument("--cache", type=int, default=2048,
                    help="LRU capacity (0 disables)")
    ap.add_argument("--pool", type=int, default=64,
                    help="distinct queries per kind in the workload")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    add_obs_flags(ap)
    return ap


def main(argv: Optional[Sequence[str]] = None) -> Optional[ServeRun]:
    args = build_parser().parse_args(argv)
    dev = device_mod.resolve(args.device)
    coll = ranks.from_flags("repro_torch.launch.serve_mine", argv, args.devices, args.P, dev)
    if coll is not None:
        dev = coll.device
    obs = start_session(args, "serve_mine") if coll is None or coll.rank == 0 else None
    dense = generate_dense(params_from_name(args.db, seed=args.seed))
    return run(dense, args, dev, obs=obs, coll=coll)


if __name__ == "__main__":
    main()

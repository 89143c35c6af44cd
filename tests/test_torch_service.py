"""The port's serving front end (``serve/service.py``) against the JAX package's.

Twins of ``tests/test_service.py``'s cases: both packages' ``MiningService``
run over one index (built by each package from the same FITable) and get the
same submissions, staged with ``auto_start=False`` where the reference
stages them.  Every value is compared with the reference service's for the
same request ids: answers (float32 confidences bit for bit, NaN slots
alike), typed sheds, drains, round-robin counts, generations under a
hot-swap, cache hits, metrics and the per-request spans.  Also a case at 150
items (5 mask words): ``build_indexes`` and the service's answers; and a
stress case of the port alone: many submitting threads and a swapping one.
"""
import json
import time

import numpy as np
import pytest

from repro.core import eclat as ref_eclat
from repro.data.ibm_gen import IBMParams, generate_dense
from repro.obs import metrics as ref_metrics
from repro.obs import trace as ref_trace
from repro.obs.slo import SLOPolicy as RefPolicy
from repro.obs.slo import SLOTracker as RefTracker
from repro.serve import MiningService as RefService
from repro.serve import QueryCache as RefCache
from repro.serve import QueryEngine as RefEngine
from repro.serve import Shed as RefShed
from repro.serve.index import build_indexes as ref_build_indexes
from repro_torch.core.rules import pack_itemsets
from repro_torch.obs import metrics
from repro_torch.obs import trace
from repro_torch.obs.slo import SLOPolicy, SLOTracker
from repro_torch.serve import Failed, MiningService, QueryCache, QueryEngine, Shed
from repro_torch.serve.index import build_indexes


def _reset():
    for m, t in ((ref_metrics, ref_trace), (metrics, trace)):
        m.reset()
        t.TRACER.disable()
        t.TRACER.clear()


@pytest.fixture(autouse=True)
def _fresh_obs():
    _reset()
    yield
    _reset()


@pytest.fixture(scope="module")
def indexed(small_db):
    dense, db, minsup, oracle = small_db
    ref = ref_build_indexes(oracle, db.n_items, db.n_tx, min_confidence=0.6)
    port = build_indexes(oracle, db.n_items, db.n_tx, min_confidence=0.6, device="cpu")
    return dense, db, oracle, ref, port


def _engines(indexed, n=1, **kw):
    """n reference replicas and n port replicas over the same index pair."""
    *_, ref, port = indexed
    kw.setdefault("batch", 32)
    kw.setdefault("top_k", 5)
    return ([RefEngine(*ref, **kw) for _ in range(n)],
            [QueryEngine(*port, **kw) for _ in range(n)])


def _pack(sets, n_items=24):
    return pack_itemsets(list(sets), n_items)


def _drain(tickets, timeout=60.0):
    return [t.result(timeout) for t in tickets]


def _same(got, want):
    """One outcome of each package: the same value, or the same typed shed."""
    if isinstance(want, RefShed):
        assert isinstance(got, Shed)
        assert (got.reason, got.queue_depth) == (want.reason, want.queue_depth)
        return
    assert not isinstance(got, (Shed, Failed)), got
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            g, w = np.asarray(g), np.asarray(w)
            assert g.dtype == w.dtype and g.shape == w.shape
            if w.dtype == np.float32:
                np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
                g, w = np.nan_to_num(g).view(np.uint32), np.nan_to_num(w).view(np.uint32)
            np.testing.assert_array_equal(g, w)
        return
    assert type(got) is type(want) and got == want


def _same_all(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        _same(g, w)


def _service_counters(mod) -> dict:
    snap = mod.snapshot()
    return {k: v for k, v in snap["counters"].items()
            if k.startswith(("service/", "serve/cache/", "serve/queries"))}


def _staged(svc, kind_masks):
    return [svc.submit(kind, m) for kind, m in kind_masks]


# ---------------------------------------------------------------------------
# Parity: service answers == the reference service's, all three kinds
# ---------------------------------------------------------------------------


def test_service_matches_reference_and_direct_engine(indexed):
    dense, db, oracle, *_ = indexed
    (ref_e,), (port_e,) = _engines(indexed)
    sets = sorted(oracle, key=lambda s: (len(s), tuple(sorted(s))))[:12]
    baskets = [frozenset(np.nonzero(dense[t])[0].tolist()) for t in range(8)]
    set_masks, basket_masks = _pack(sets), _pack(baskets)
    subs = ([("support", m) for m in set_masks] + [("rules", m) for m in basket_masks]
            + [("superset", m) for m in set_masks])
    out = []
    for cls, eng in ((RefService, ref_e), (MiningService, port_e)):
        with cls([eng], deadline_ms=2.0) as svc:
            out.append(_drain(_staged(svc, subs)))
    _same_all(out[1], out[0])
    # and the port's direct engine, call for call
    direct = (list(port_e.support(set_masks))
              + list(zip(*port_e.rules_for(basket_masks)))
              + list(zip(*port_e.supersets(set_masks))))
    _same_all(out[1], [tuple(d) if isinstance(d, tuple) else d for d in direct])


def test_service_rejects_unknown_kind(indexed):
    for cls, (eng,) in zip((RefService, MiningService), _engines(indexed)):
        svc = cls([eng], auto_start=False)
        with pytest.raises(AssertionError):
            svc.submit("nope", np.zeros(eng.index.n_words, np.uint32))


# ---------------------------------------------------------------------------
# Micro-batching: a staged queue coalesces into one flush
# ---------------------------------------------------------------------------


def test_microbatch_coalesces_staged_queue(indexed):
    oracle = indexed[2]
    sets = list(oracle)[:32]
    masks = _pack(sets)
    out, stats, snaps = [], [], []
    for cls, (eng,), mod in zip((RefService, MiningService), _engines(indexed, batch=32),
                                (ref_metrics, metrics)):
        svc = cls([eng], deadline_ms=50.0, auto_start=False)
        tickets = _staged(svc, [("support", m) for m in masks])
        assert svc.stats()["queue_depth"] == 32
        svc.start()
        out.append(_drain(tickets))
        svc.stop()
        stats.append(svc.stats())
        snaps.append(mod.snapshot())
    _same_all(out[1], out[0])
    assert [int(v) for v in out[1]] == [oracle[s] for s in sets]
    assert stats[1] == stats[0] and stats[1]["flushes"] == 1
    for name in ("service/batch_fill",):
        assert snaps[1]["histograms"][name] == snaps[0]["histograms"][name]
    assert snaps[1]["histograms"]["service/batch_fill"]["max"] == 32
    assert snaps[1]["gauges"]["service/queue_depth"] == \
        snaps[0]["gauges"]["service/queue_depth"] == 32


def test_deadline_cuts_partial_batches(indexed):
    masks = _pack(list(indexed[2])[:3])
    out = []
    for cls, (eng,) in zip((RefService, MiningService), _engines(indexed, batch=32)):
        with cls([eng], deadline_ms=2.0) as svc:
            t0 = time.monotonic()
            out.append(_drain([svc.submit("support", m) for m in masks]))
            assert time.monotonic() - t0 < 30.0   # the deadline, not a full batch
    _same_all(out[1], out[0])
    assert all(isinstance(v, np.integer) for v in out[1])


# ---------------------------------------------------------------------------
# Admission control: typed sheds, never silent
# ---------------------------------------------------------------------------


def test_queue_full_sheds_typed(indexed):
    masks = _pack(list(indexed[2])[:3])
    sheds, firsts, counters, slo_shed = [], [], [], []
    for cls, tracker, policy, (eng,), mod in zip(
            (RefService, MiningService), (RefTracker, SLOTracker), (RefPolicy, SLOPolicy),
            _engines(indexed), (ref_metrics, metrics)):
        slo = tracker(policy())
        svc = cls([eng], max_queue=2, auto_start=False, slo=slo)
        t1, t2, t3 = _staged(svc, [("support", m) for m in masks])
        assert t3.done() and not t1.done() and not t2.done()
        sheds.append(t3.result(0))
        counters.append(_service_counters(mod))
        slo_shed.append(slo.evaluate().shed)
        svc.start()
        firsts.append(t1.result(60))
        svc.stop()
    _same(sheds[1], sheds[0])
    assert sheds[1] == Shed(reason="queue_full", queue_depth=2)
    assert counters[1] == counters[0] and counters[1]["service/shed"] == 1
    assert slo_shed == [1, 1]
    _same(firsts[1], firsts[0])


def test_stop_without_drain_sheds_queue(indexed):
    masks = _pack(list(indexed[2])[:4])
    out = []
    for cls, (eng,) in zip((RefService, MiningService), _engines(indexed)):
        svc = cls([eng], auto_start=False)
        tickets = _staged(svc, [("support", m) for m in masks])
        svc.stop(drain=False)
        out.append([t.result(0) for t in tickets])
        with pytest.raises(RuntimeError):
            svc.submit("support", masks[0])
    _same_all(out[1], out[0])
    assert all(v.reason == "shutdown" for v in out[1])


def test_stop_with_drain_resolves_everything(indexed):
    oracle = indexed[2]
    sets = list(oracle)[:20]
    masks = _pack(sets)
    out, stats = [], []
    for cls, (eng,) in zip((RefService, MiningService), _engines(indexed, batch=8)):
        svc = cls([eng], deadline_ms=100.0, auto_start=False)
        tickets = _staged(svc, [("support", m) for m in masks])
        svc.start()
        svc.stop(drain=True)
        out.append([t.result(0) for t in tickets])       # all resolved already
        stats.append(svc.stats())
    _same_all(out[1], out[0])
    assert [int(v) for v in out[1]] == [oracle[s] for s in sets]
    assert stats[1] == stats[0]


# ---------------------------------------------------------------------------
# Replicas + generation-consistent hot swap
# ---------------------------------------------------------------------------


def test_round_robin_spreads_flushes(indexed):
    masks = _pack(list(indexed[2])[:16])
    out, stats, counters = [], [], []
    for cls, engines, mod in zip((RefService, MiningService),
                                 _engines(indexed, n=2, batch=4), (ref_metrics, metrics)):
        svc = cls(engines, auto_start=False)
        tickets = _staged(svc, [("support", m) for m in masks])
        svc.start()
        out.append(_drain(tickets))
        svc.stop()
        stats.append(svc.stats())
        counters.append(_service_counters(mod))
    _same_all(out[1], out[0])
    assert stats[1] == stats[0] and counters[1] == counters[0]
    st = stats[1]
    assert st["replicas"] == 2 and sum(st["per_replica_flushes"]) == st["flushes"] >= 4
    assert all(f > 0 for f in st["per_replica_flushes"])
    assert sum(st["per_replica_requests"]) == 16


def test_hot_swap_is_generation_consistent(indexed):
    dense, db, oracle, *_ = indexed
    small = {f: s for f, s in oracle.items() if len(f) == 1}
    standby = (ref_build_indexes(small, db.n_items, db.n_tx, min_confidence=0.6),
               build_indexes(small, db.n_items, db.n_tx, min_confidence=0.6, device="cpu"))
    doomed = max(oracle, key=len)                # gone after the swap
    mask = _pack([doomed])[0]
    seen = []
    for cls, cache_cls, engines, pair in zip((RefService, MiningService), (RefCache, QueryCache),
                                             _engines(indexed, n=2), standby):
        cache = cache_cls(64)
        log = []
        with cls(engines, cache=cache, deadline_ms=2.0) as svc:
            log.append(svc.generation)
            log.append(svc.submit("support", mask).result(60))
            log.append(len(cache) > 0)
            gen = svc.swap_indexes(*pair)
            log += [gen, svc.generation, {e.generation for e in svc.engines}, len(cache),
                    cache.stats.invalidations]
            # the old answer is gone on EVERY replica (round-robin hits both)
            log += [svc.submit("support", mask).result(60) for _ in range(4)]
            log.append(svc.stats()["per_replica_flushes"])
        # a replica fleet must refuse to construct on diverged generations
        engines[0].swap_indexes(*pair)
        with pytest.raises(AssertionError):
            cls(engines, auto_start=False)
        seen.append(log)
    _same_all(seen[1], seen[0])
    assert seen[1][:3] == [0, oracle[doomed], True]
    assert seen[1][3:8] == [1, 1, {1}, 0, 1] and seen[1][8:12] == [-1] * 4
    assert seen[1][12] == [3, 2]


def test_cache_serves_repeats_and_updates_hit_rate_gauge(indexed):
    oracle = indexed[2]
    mask = _pack([next(iter(oracle))])[0]
    out, stats, gauges = [], [], []
    for cls, cache_cls, (eng,), mod in zip((RefService, MiningService), (RefCache, QueryCache),
                                           _engines(indexed), (ref_metrics, metrics)):
        cache = cache_cls(64)
        with cls([eng], cache=cache, deadline_ms=2.0) as svc:
            out.append([svc.submit("support", mask).result(60) for _ in range(2)])
        stats.append(cache.stats.as_dict())
        gauges.append(mod.snapshot()["gauges"]["serve/cache/hit_rate"])
    _same_all(out[1], out[0])
    assert out[1][0] == out[1][1]
    assert stats[1] == stats[0] and stats[1]["hits"] >= 1
    assert gauges[1] == gauges[0] == pytest.approx(stats[1]["hit_rate"])


# ---------------------------------------------------------------------------
# Per-request tracing: ids flow enqueue -> assemble -> sweep -> respond
# ---------------------------------------------------------------------------


def _traced_run(cls, eng, tr, subs):
    tr.enable()
    svc = cls([eng], deadline_ms=20.0, auto_start=False)
    tickets = _staged(svc, subs)
    svc.start()
    _drain(tickets)
    svc.stop()
    tr.disable()
    return json.loads(json.dumps(tr.export())), {t.id for t in tickets}


def _service_spans(out):
    """Each service span's name and args (timing left out), in a stable order."""
    return sorted((e["name"], json.dumps(e["args"], sort_keys=True))
                  for e in out["traceEvents"]
                  if e.get("ph") == "X" and e["name"].startswith("service/"))


def test_per_request_spans_share_request_ids(indexed):
    dense = indexed[0]
    sets = list(indexed[2])[:6]
    baskets = [frozenset(np.nonzero(dense[t])[0].tolist()) for t in range(3)]
    subs = ([("support", m) for m in _pack(sets)] + [("rules", m) for m in _pack(baskets)]
            + [("superset", m) for m in _pack(sets[:2])])
    traces = []
    for cls, (eng,), tr in zip((RefService, MiningService), _engines(indexed),
                               (ref_trace.TRACER, trace.TRACER)):
        traces.append(_traced_run(cls, eng, tr, subs))
    (want, ids), (got, got_ids) = traces
    assert got_ids == ids
    assert _service_spans(got) == _service_spans(want)
    spans = [e for e in got["traceEvents"] if e.get("ph") == "X"]
    by_name = {}
    for e in spans:
        by_name.setdefault(e["name"], []).append(e)
    assert {e["args"]["req"] for e in by_name["service/enqueue"]} == ids
    assert all(e["dur"] >= 0 for e in by_name["service/enqueue"])
    for stage in ("service/flush", "service/assemble", "service/sweep", "service/respond"):
        assert {i for e in by_name[stage] for i in e["args"]["reqs"]} == ids, stage
    assert all(e["args"]["generation"] == 0 for e in by_name["service/flush"])
    tracks = [{e["args"]["name"] for e in out["traceEvents"] if e.get("ph") == "M"}
              for out in (want, got)]
    assert "service/replica0/queue" in tracks[1] and "service/replica0/queue" in tracks[0]


def test_queue_depth_renders_as_counter_track(indexed):
    subs = [("support", m) for m in _pack(list(indexed[2])[:6])]
    depths = []
    for cls, (eng,), tr in zip((RefService, MiningService), _engines(indexed),
                               (ref_trace.TRACER, trace.TRACER)):
        out, _ = _traced_run(cls, eng, tr, subs)
        depths.append([e["args"]["depth"] for e in out["traceEvents"]
                       if e.get("ph") == "C" and e.get("name") == "queue depth"])
    assert depths[1] == depths[0]
    assert max(depths[1]) >= 1 and min(depths[1]) == 0 and len(depths[1]) >= len(subs)


def test_slo_tracker_fed_by_service(indexed):
    masks = _pack(list(indexed[2])[:8])
    out = []
    for cls, tracker, policy, (eng,), mod in zip(
            (RefService, MiningService), (RefTracker, SLOTracker), (RefPolicy, SLOPolicy),
            _engines(indexed), (ref_metrics, metrics)):
        slo = tracker(policy(p99_ms=60_000.0, min_requests=1))
        with cls([eng], slo=slo, deadline_ms=2.0) as svc:
            _drain([svc.submit("support", m) for m in masks])
        st = slo.evaluate()
        assert st.p99_ms is not None and st.p99_ms > 0 and not st.alert_active
        out.append((st.served, st.shed, st.errors,
                    mod.snapshot()["histograms"]["service/latency_ms"]["count"]))
    assert out[1] == out[0] == (8, 0, 0, 8)


# ---------------------------------------------------------------------------
# Masks of 5 words: 150 items
# ---------------------------------------------------------------------------


def test_service_at_150_items_equals_the_reference():
    n_items, n_tx = 150, 640
    dense = generate_dense(IBMParams(n_tx=n_tx, n_items=n_items, n_patterns=20,
                                     avg_pattern_len=5, avg_tx_len=10, seed=5))
    fis = ref_eclat.brute_force_fis(dense, int(np.ceil(0.04 * n_tx)))
    ref = ref_build_indexes(fis, n_items, n_tx, min_confidence=0.5)
    port = build_indexes(fis, n_items, n_tx, min_confidence=0.5, device="cpu")
    assert port[0].n_words == 5 and port[0].n_fis == len(fis) > 4000
    assert port[1].n_rules == ref[1].n_rules > 10_000
    for got, want in zip((port[0].to_reference(), port[1].to_reference()), ref):
        for k, v in got.items():
            w = getattr(want, k)
            if isinstance(v, np.ndarray):
                np.testing.assert_array_equal(v, np.asarray(w))
            else:
                assert v == w, k
    rng = np.random.default_rng(11)
    fi_list = sorted(fis, key=lambda s: (len(s), tuple(sorted(s))))
    sets = [fi_list[i] for i in rng.choice(len(fi_list), 40, replace=False)]
    probes = [frozenset(rng.choice(n_items, size=5, replace=False).tolist()) for _ in range(8)]
    baskets = [frozenset(np.nonzero(dense[t])[0].tolist())
               for t in rng.choice(n_tx, 40, replace=False)]
    subs = ([("support", m) for m in _pack(sets + probes, n_items)]
            + [("rules", m) for m in _pack(baskets, n_items)]
            + [("superset", m) for m in _pack(sets[:24], n_items)])
    order = rng.permutation(len(subs))
    subs = [subs[i] for i in order]
    out, stats = [], []
    for cls, cache_cls, pair, eng_cls in ((RefService, RefCache, ref, RefEngine),
                                          (MiningService, QueryCache, port, QueryEngine)):
        engines = [eng_cls(*pair, batch=32, top_k=7) for _ in range(2)]
        svc = cls(engines, cache=cache_cls(256), deadline_ms=50.0, auto_start=False)
        tickets = _staged(svc, subs + subs[:10])          # repeats hit the cache
        svc.start()
        out.append(_drain(tickets))
        svc.stop()
        stats.append(svc.stats())
    _same_all(out[1], out[0])
    assert stats[1] == stats[0] and stats[1]["cache"]["hits"] >= 10


# ---------------------------------------------------------------------------
# Concurrency: many submitters, a swapping thread, a short switch interval
# ---------------------------------------------------------------------------


def test_concurrent_submitters_and_swaps_lose_nothing(indexed):
    """16 submitter threads and a swapping thread against 2 replicas with a
    small queue, the interpreter switching threads every 10 µs: every ticket
    resolves, served + shed is what was offered, the replicas' request
    counts add up to the served ones, each flush serves one generation, and
    each answer is the engine's at that generation."""
    import sys
    import threading

    dense, db, oracle, _, port = indexed
    small = {f: s for f, s in oracle.items() if len(f) <= 2}
    standby = build_indexes(small, db.n_items, db.n_tx, min_confidence=0.6, device="cpu")
    pairs = (port, standby)
    masks = _pack(list(oracle)[:48] + [frozenset({0, 5, 9})])
    engines = [QueryEngine(*port, batch=8, top_k=5) for _ in range(2)]
    want = [QueryEngine(*p, batch=64, top_k=5).support(masks) for p in pairs]
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    trace.TRACER.enable()
    try:
        svc = MiningService(engines, deadline_ms=1.0, max_queue=12, cache=QueryCache(16))
        out, lock = [], threading.Lock()

        def submitter(seed):
            rng = np.random.default_rng(seed)
            for _ in range(60):
                i = int(rng.integers(len(masks)))
                t = svc.submit("support", masks[i])
                with lock:
                    out.append((i, t))

        def swapper():
            for k in range(1, 7):
                time.sleep(0.01)
                svc.swap_indexes(*pairs[k % 2])

        threads = [threading.Thread(target=submitter, args=(s,)) for s in range(16)]
        threads.append(threading.Thread(target=swapper))
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        assert not any(t.is_alive() for t in threads)
        svc.stop()
    finally:
        sys.setswitchinterval(old)
        trace.TRACER.disable()
    gen_of = {}
    for e in trace.TRACER.export()["traceEvents"]:
        if e.get("name") == "service/flush" and e.get("ph") == "X":
            for rid in e["args"]["reqs"]:
                assert rid not in gen_of
                gen_of[rid] = e["args"]["generation"]
    st = svc.stats()
    values = [(i, t.id, t.result(0)) for i, t in out]
    served = [(i, rid, v) for i, rid, v in values if not isinstance(v, Shed)]
    assert len(values) == 16 * 60 and st["errors"] == 0 and st["generation"] == 6
    assert st["shed"] + len(served) == len(values)
    assert sum(st["per_replica_requests"]) == len(served) == len(gen_of)
    for i, rid, v in served:
        assert v == want[gen_of[rid] % 2][i], (rid, gen_of[rid])


def test_cache_cleared_from_another_thread_while_read():
    """A thread clearing the cache while another looks up, fills and
    evicts, the interpreter switching threads every microsecond: no lookup
    raises, and every lookup counts once, as a hit or a miss."""
    import sys
    import threading

    cache = QueryCache(8)
    keys = [("support", k) for k in range(12)]
    errors, stop, lookups = [], threading.Event(), [0]

    def reader():
        try:
            while not stop.is_set():
                results, miss = cache.split_batch(keys)
                cache.fill_batch(keys, results, miss, [("v", keys[j]) for j in miss])
                assert results == [("v", k) for k in keys]
                lookups[0] += len(keys)
        except Exception as e:   # reported below
            errors.append(f"{type(e).__name__}: {e}")

    def clearer():
        while not stop.is_set():
            cache.clear()
            time.sleep(1e-5)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader), threading.Thread(target=clearer)]
        for t in threads:
            t.start()
        time.sleep(0.5)
        stop.set()
        for t in threads:
            t.join(30)
    finally:
        sys.setswitchinterval(old)
    assert not errors, errors[:3]
    assert lookups[0] > 0 and cache.stats.lookups == lookups[0]
    assert cache.stats.invalidations > 0 and cache.stats.hits > 0


def test_swaps_under_load_with_the_cache_fail_nothing(indexed):
    """Four submitters repeating a few queries, so many are cache hits,
    while a thread swaps the index pair 200 times, one swap every two
    flushes (each swap clears the cache), at a 1 µs switch interval: no
    request fails, and each answer is the engine's."""
    import sys
    import threading

    dense, db, oracle, _, port = indexed
    masks = _pack(list(oracle)[:6])
    want = QueryEngine(*port, batch=64, top_k=5).support(masks)
    svc = MiningService([QueryEngine(*port, batch=8, top_k=5) for _ in range(2)],
                        deadline_ms=0.5, max_queue=4096, cache=QueryCache(16))
    out, lock, stop = [], threading.Lock(), threading.Event()

    def submitter(seed):
        rng = np.random.default_rng(seed)
        while not stop.is_set():
            i = int(rng.integers(len(masks)))
            t = svc.submit("support", masks[i])
            with lock:
                out.append((i, t))
            t.result(60)

    def swapper():
        for _ in range(200):
            target, t_end = svc.stats()["flushes"] + 2, time.monotonic() + 10
            while svc.stats()["flushes"] < target and time.monotonic() < t_end:
                time.sleep(1e-4)
            svc.swap_indexes(*port)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=submitter, args=(s,)) for s in range(4)]
        for t in threads:
            t.start()
        sw = threading.Thread(target=swapper)
        sw.start()
        sw.join(60)
        stop.set()
        for t in threads:
            t.join(60)
        assert not sw.is_alive() and not any(t.is_alive() for t in threads)
        svc.stop()
    finally:
        sys.setswitchinterval(old)
    st = svc.stats()
    values = [(i, t.result(0)) for i, t in out]
    failed = [v.error for _, v in values if isinstance(v, Failed)]
    assert not failed and st["errors"] == 0, failed[:3]
    assert st["generation"] == 200 and st["shed"] == 0 and st["cache"]["hits"] > 0
    for i, v in values:
        assert v == want[i]

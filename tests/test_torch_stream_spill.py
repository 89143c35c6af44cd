"""The rest of the port's streaming miner against the JAX package's: the
window spill, the cluster executor as re-miner, the loop's spans and
``stream_mine --cluster --spill``.

* ``WindowSpill`` (and ``StreamParams.spill_dir``): twins of
  ``tests/test_store.py``'s spill and resume cases; the spilled store's files
  are byte-identical to the reference's spill of the same stream, and the
  reference's ``TxStore`` reads them.
* ``cluster_mine_fn``: the twin of ``tests/test_cluster.py``'s streaming case,
  with every event and each re-mine's FITable equal to the reference's.
* The ``stream/drift``, ``stream/remine`` and ``stream/swap`` spans, equal to
  the reference's on one stream.
* ``StreamingMiner`` on a drifting stream of 150 items (5 mask words).
* The launcher, ``stream_mine --cluster 2 --spill DIR --device cpu``.
"""
import dataclasses
import filecmp
import json
import os
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest

from repro import cluster as ref_cluster
from repro.core import eclat as ref_eclat
from repro.data import ibm_gen as ref_gen
from repro.obs import trace as ref_trace
from repro.store import TxStore as RefTxStore
from repro.store.store import StoreWriter as RefStoreWriter
from repro.stream import StreamingMiner as RefMiner
from repro.stream import StreamParams as RefParams
from repro.stream.window import SlidingWindow as RefWindow
from repro.stream.window import WindowSpill as RefSpill
from repro_torch import cluster
from repro_torch.core import bitmap as bm
from repro_torch.core import eclat, fimi
from repro_torch.launch import stream_mine
from repro_torch.obs import trace
from repro_torch.store import StoreWriter, TxStore, pack_bool_np
from repro_torch.stream import SlidingWindow, StreamingMiner, StreamParams, WindowSpill

CPU = "cpu"


def _ref_brute(window, abs_minsup):
    return ref_eclat.brute_force_fis(np.asarray(window.to_bitmap_db().dense()), abs_minsup)


def _port_brute(window, abs_minsup):
    return ref_eclat.brute_force_fis(bm.unpack_bool(window.rows(), window.n_items).numpy(),
                                     abs_minsup)


def _same_dirs(a, b):
    """Two stores, byte for byte: the manifest and every block file."""
    assert Path(a, "manifest.json").read_text() == Path(b, "manifest.json").read_text()
    names = sorted(os.listdir(Path(a, "blocks")))
    assert names == sorted(os.listdir(Path(b, "blocks"))) and names
    _, mismatch, errors = filecmp.cmpfiles(Path(a, "blocks"), Path(b, "blocks"), names,
                                           shallow=False)
    assert mismatch == [] and errors == []


def _fimi_params():
    return fimi.FimiParams(
        min_support_rel=0.1, n_db_sample=128, n_fi_sample=256,
        eclat=eclat.EclatConfig(max_out=1 << 14, max_stack=2048, frontier_size=8),
    )


# ---------------------------------------------------------------------------
# WindowSpill
# ---------------------------------------------------------------------------


def test_window_spill_persists_expired_blocks(tmp_path):
    rng = np.random.default_rng(1)
    blocks = [rng.random((16, 12)) < 0.3 for _ in range(7)]
    dirs = tmp_path / "port", tmp_path / "ref"
    port = StreamingMiner(StreamParams(n_blocks=3, block_tx=16, min_support_rel=0.3,
                                       spill_dir=str(dirs[0])), 12, mine_fn=_port_brute,
                          device=CPU)
    ref = RefMiner(RefParams(n_blocks=3, block_tx=16, min_support_rel=0.3,
                             spill_dir=str(dirs[1])), 12, mine_fn=_ref_brute)
    for b in blocks:
        got, want = port.admit(b), ref.admit(b)
        assert (got.expired, got.remined, got.generation) == \
            (want.expired, want.remined, want.generation)
    assert port.spill.n_spilled == ref.spill.n_spilled == 4
    hist = port.spill.store()
    ref.spill.store()
    # 7 admitted into a 3-block ring: blocks 0..3 expired, in arrival order
    assert hist.n_blocks == 4 and hist.n_tx == 64
    want = np.concatenate([pack_bool_np(b) for b in blocks[:4]])
    assert np.array_equal(hist.read_all_packed(), want)
    _same_dirs(*dirs)
    assert np.array_equal(RefTxStore.open(str(dirs[0])).read_all_packed(), want)
    # the spilled history is itself a minable store
    got = fimi.run(hist, None, _fimi_params(), device=CPU, materialize=True, P=2)
    dense = fimi.run(fimi.shard_db(np.concatenate(blocks[:4]), 2, CPU), 12, _fimi_params(),
                     device=CPU, materialize=True)
    assert got.fi_dict == dense.fi_dict == ref_eclat.brute_force_fis(
        np.concatenate(blocks[:4]), int(np.ceil(0.1 * 64)))


def test_window_spill_resumes_existing_history(tmp_path):
    """A restarted stream appends to the spill store instead of resetting it,
    as the reference's does, file for file."""
    rng = np.random.default_rng(2)
    blocks = [rng.random((8, 12)) < 0.3 for _ in range(6)]
    packed = [pack_bool_np(b) for b in blocks]

    def port_session(blks):
        spill = WindowSpill(str(tmp_path / "port"), 8, 12)
        win = SlidingWindow.empty(2, 8, 12, device=CPU)
        for b in blks:
            expired = win.admit(bm.from_reference(pack_bool_np(b)))
            if expired is not None:
                spill.append(expired)
        return spill.store()

    def ref_session(blks):
        spill = RefSpill(str(tmp_path / "ref"), 8, 12)
        win = RefWindow.empty(2, 8, 12)
        for b in blks:
            win, expired = win.admit(jnp.asarray(pack_bool_np(b)))
            if expired is not None:
                spill.append(expired)
        return spill.store()

    h1 = port_session(blocks[:4])         # ring of 2 -> blocks 0,1 expire
    assert h1.n_blocks == 2 == ref_session(blocks[:4]).n_blocks
    h2 = port_session(blocks[3:])         # fresh session, same directory
    assert h2.n_blocks == 3 == ref_session(blocks[3:]).n_blocks
    want = np.concatenate([packed[0], packed[1], packed[3]])
    assert np.array_equal(h2.read_all_packed(), want)
    _same_dirs(tmp_path / "port", tmp_path / "ref")
    # geometry mismatch is refused, never silently reset, by either writer
    for writer in (StoreWriter, RefStoreWriter):
        with pytest.raises(ValueError, match="resume"):
            writer(str(tmp_path / "port"), n_items=16, block_tx=8, resume=True)
    with pytest.raises(ValueError, match="resume"):
        WindowSpill(str(tmp_path / "port"), 8, 16)


def test_spill_takes_device_words_and_host_words_alike(tmp_path):
    """An evicted int32 block (negative words included) lands as its uint32
    bits: the same file as the same block handed over as host words."""
    rng = np.random.default_rng(4)
    dense = rng.random((5, 64)) < 0.5
    dense[:, 31] = dense[:, 63] = True                 # the sign bits
    words = pack_bool_np(dense)
    a = WindowSpill(str(tmp_path / "a"), 5, 64)
    a.append(bm.from_reference(words))
    a.store()
    b = WindowSpill(str(tmp_path / "b"), 5, 64)
    b.append(words)
    b.store()
    _same_dirs(tmp_path / "a", tmp_path / "b")
    assert np.array_equal(TxStore.open(str(tmp_path / "a")).read_block(0), words)


# ---------------------------------------------------------------------------
# cluster_mine_fn: the distributed re-miner
# ---------------------------------------------------------------------------


def _fitable(engine):
    idx = engine.index
    return dict(zip(map(tuple, np.asarray(idx.masks)[: idx.n_fis].tolist()),
                    np.asarray(idx.supports)[: idx.n_fis].tolist()))


def _port_fitable(engine):
    got = engine.index.to_reference()
    n = engine.index.n_fis
    return dict(zip(map(tuple, got["masks"][:n].tolist()), got["supports"][:n].tolist()))


def test_streaming_miner_with_cluster_mine_fn():
    """The executor plugs in as StreamingMiner.mine_fn: the initial mine and
    the drift's re-mines are exact over the live window, the swap
    generation advances atomically, and every event and FITable equals the
    reference's with its own cluster re-miner."""
    p = ref_gen.IBMParams(n_tx=512, n_items=20, n_patterns=6, avg_pattern_len=4,
                          avg_tx_len=7, seed=4)
    kw = dict(n_blocks=2, block_tx=64, min_support_rel=0.15, eps=0.01, delta=0.2,
              check_every=1, cooldown_blocks=0, seed=4)
    port_fn = cluster.cluster_mine_fn(
        P=2, cluster_params=cluster.ClusterParams(
            planner=cluster.PlannerParams(n_db_sample=128, n_fi_sample=64),
            eclat=eclat.EclatConfig(max_out=4096, max_stack=1024, frontier_size=4)),
        seed=4)
    ref_fn = ref_cluster.cluster_mine_fn(
        P=2, cluster_params=ref_cluster.ClusterParams(
            planner=ref_cluster.PlannerParams(n_db_sample=128, n_fi_sample=64),
            eclat=ref_eclat.EclatConfig(max_out=4096, max_stack=1024, frontier_size=4)),
        seed=4)
    port = StreamingMiner(StreamParams(**kw), p.n_items, mine_fn=port_fn, device=CPU)
    ref = RefMiner(RefParams(**kw), p.n_items, mine_fn=ref_fn)
    seen, remines = [], 0
    for dense_block, _ in ref_gen.drifting_stream(p, n_blocks=4, block_tx=64, breaks=(2,)):
        got, want = port.admit(dense_block), ref.admit(dense_block)
        seen.append(np.asarray(dense_block))
        assert (got.block_index, got.expired, got.delta_applied, got.remined,
                got.remine_reason, got.generation) == (
            want.block_index, want.expired, want.delta_applied, want.remined,
            want.remine_reason, want.generation)
        assert dataclasses.astuple(got.verdict) == dataclasses.astuple(want.verdict) \
            if want.verdict else got.verdict is None
        if got.remined:
            remines += 1
            # distributed re-mine == brute force over the current window
            oracle = ref_eclat.brute_force_fis(np.concatenate(seen[-2:]), port.abs_minsup)
            assert _port_fitable(port.engine) == _fitable(ref.engine)
            assert len(_fitable(ref.engine)) == len(oracle)
            assert got.generation == port.engine.generation
        if port.engine is not None:
            np.testing.assert_array_equal(port.current_supports, ref.current_supports)
    assert remines >= 1 and port.stats.remines == ref.stats.remines


def test_cluster_mine_fn_keeps_itemsets_at_exactly_minsup():
    """``(abs − 0.5)/n_tx``: an itemset whose support is exactly
    ``abs_minsup`` is mined; the window must split over the miners."""
    rng = np.random.default_rng(4)
    w = SlidingWindow.empty(2, 64, 12, device=CPU)
    for _ in range(2):
        w.admit(bm.from_reference(pack_bool_np(rng.random((64, 12)) < 0.3)))
    dense = bm.unpack_bool(w.rows(), 12).numpy()
    counts = sorted(set(int(c) for c in dense.sum(axis=0)))
    abs_minsup = counts[len(counts) // 2]
    got = cluster.cluster_mine_fn(P=2)(w, abs_minsup)
    assert got == ref_eclat.brute_force_fis(dense, abs_minsup)
    assert abs_minsup in got.values()
    with pytest.raises(ValueError, match="divisible"):
        cluster.cluster_mine_fn(P=3)(w, abs_minsup)


# ---------------------------------------------------------------------------
# The loop's spans
# ---------------------------------------------------------------------------

STREAM = dict(n_items=20, n_patterns=6, avg_pattern_len=4, avg_tx_len=7, seed=3)
PARAMS = dict(n_blocks=4, block_tx=128, min_support_rel=0.15, min_confidence=0.6, eps=0.125,
              delta=0.05, border_margin=0.03, border_hysteresis=0.02, cooldown_blocks=1,
              batch=32, seed=0)


def _stream_spans(tracer):
    out = json.loads(json.dumps(tracer.export()))
    return [(e["name"], e["ph"], json.dumps(e.get("args", {}), sort_keys=True))
            for e in out["traceEvents"]
            if e.get("name", "").startswith("stream/") and e.get("ph") in ("X", "i")]


def test_stream_spans_equal_the_reference():
    blocks = [b for b, _ in ref_gen.drifting_stream(ref_gen.IBMParams(**STREAM), n_blocks=12,
                                                     block_tx=128, breaks=(6,))]
    spans, events = [], []
    for tracer, make in ((ref_trace.TRACER,
                          lambda: RefMiner(RefParams(**PARAMS), 20, mine_fn=_ref_brute)),
                         (trace.TRACER,
                          lambda: StreamingMiner(StreamParams(**PARAMS), 20,
                                                 mine_fn=_port_brute, device=CPU))):
        tracer.clear()
        tracer.enable()
        try:
            miner = make()
            events.append([(ev.block_index, ev.remine_reason) for ev in map(miner.admit, blocks)
                           if ev.remined])
        finally:
            tracer.disable()
        spans.append(_stream_spans(tracer))
        tracer.clear()
    assert spans[1] == spans[0] and events[1] == events[0]
    names = [(n, ph) for n, ph, _ in spans[1]]
    remines = events[1]
    assert names.count(("stream/remine", "X")) == names.count(("stream/swap", "X")) == \
        len(remines) >= 2
    drifts = [json.loads(a) for n, ph, a in spans[1] if n == "stream/drift"]
    assert [(d["block"], d["reason"]) for d in drifts] == remines[1:]


# ---------------------------------------------------------------------------
# Masks of 5 words: 150 items
# ---------------------------------------------------------------------------


def test_streaming_miner_at_150_items_equals_the_reference():
    p = ref_gen.IBMParams(n_tx=0, n_items=150, n_patterns=20, avg_pattern_len=5,
                          avg_tx_len=10, seed=3)
    blocks = [b for b, _ in ref_gen.drifting_stream(p, n_blocks=10, block_tx=128,
                                                     breaks=(5,))]
    kw = dict(PARAMS, min_support_rel=0.08, cooldown_blocks=0)
    port = StreamingMiner(StreamParams(**kw), 150, mine_fn=_port_brute, device=CPU)
    ref = RefMiner(RefParams(**kw), 150, mine_fn=_ref_brute)
    reasons = []
    for block in blocks:
        got, want = port.admit(block), ref.admit(block)
        assert (got.block_index, got.expired, got.delta_applied, got.remined,
                got.remine_reason, got.generation) == (
            want.block_index, want.expired, want.delta_applied, want.remined,
            want.remine_reason, want.generation)
        assert (got.verdict is None) == (want.verdict is None)
        if got.verdict is not None:
            assert dataclasses.astuple(got.verdict) == dataclasses.astuple(want.verdict)
        if port.engine is not None:
            assert port.engine.index.n_words == 5
            np.testing.assert_array_equal(port.current_supports, ref.current_supports)
            np.testing.assert_array_equal(port.exact_window_supports(), port.current_supports)
        if got.remined:
            reasons.append(got.remine_reason)
            assert _port_fitable(port.engine) == _fitable(ref.engine)
    assert reasons[0] == "initial" and len(reasons) >= 2


# ---------------------------------------------------------------------------
# The launcher
# ---------------------------------------------------------------------------

LAUNCH = ["--device", "cpu", "--db", "T1I0.02P6PL4TL7", "--support", "0.15", "--blocks", "4",
          "--blocktx", "128", "--stream", "9", "--breaks", "5"]


def test_stream_mine_cluster_and_spill(tmp_path, capsys):
    """``--cluster 2 --spill DIR``: the same re-mine log as the in-process
    re-miner's (every FITable is exact), 0 torn, the delta check equal, and
    the evicted blocks in the store, the stream's rows in arrival order."""
    base = stream_mine.main(LAUNCH + ["-P", "2"])
    run = stream_mine.main(LAUNCH + ["--cluster", "2", "--spill", str(tmp_path / "hist"),
                                     "--trace", str(tmp_path / "rec")])
    out = capsys.readouterr().out
    key = [(b, seg, why, f) for b, seg, why, _, _, f in base.remine_log]
    assert [(b, seg, why, f) for b, seg, why, _, _, f in run.remine_log] == key
    assert len(key) >= 2 and run.torn == 0 and run.delta_mismatches == 0
    assert [(ev.block_index, ev.generation) for ev, _ in run.events] == \
        [(ev.block_index, ev.generation) for ev, _ in base.events]
    hist = TxStore.open(str(tmp_path / "hist"))
    assert hist.n_blocks == 9 - 4 and hist.n_tx == 5 * 128
    stream = [b for b, _ in ref_gen.drifting_stream(ref_gen.params_from_name(
        "T1I0.02P6PL4TL7", seed=0), n_blocks=9, block_tx=128, breaks=(5,))]
    assert np.array_equal(hist.to_dense(), np.concatenate(stream[:5]))
    assert "spill: 5 expired blocks persisted to" in out
    names = {json.loads(line)["kind"] for line in
             (tmp_path / "rec" / "events.jsonl").read_text().splitlines()}
    assert "remine" in names
    spans = {e["name"] for e in json.loads((tmp_path / "rec" / "trace.json").read_text())
             ["traceEvents"]}
    assert {"stream/remine", "stream/swap"} <= spans
    with pytest.raises(SystemExit):
        stream_mine.main(LAUNCH + ["--cluster", "3"])      # 512 rows over 3 miners

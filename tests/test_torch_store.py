"""The port's out-of-core store (``repro_torch.store``) against the JAX
package's ``repro.store``, on the CPU.

Port twins of ``tests/test_store.py``'s format, reader and mining tests, and
the checks across the two packages: one on-disk format (a store written by
either reads back to the same rows in the other, manifests and block files
byte for byte), one FITable when both mine one store, one plan when the
port's planner is handed the reference's sample indices, one ``fsck``
report.  Supports are integers, so every comparison is exact.
"""
import filecmp
import json
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import cluster as ref_cluster
from repro import store as ref_store
from repro.core import eclat as ref_eclat
from repro.core import fimi as ref_fimi
from repro.data import ibm_gen as ref_gen
from repro_torch import cluster
from repro_torch.core import bitmap as bm
from repro_torch.core import eclat, fimi
from repro_torch.data import ibm_gen
from repro_torch.data.ibm_gen import IBMParams, generate_dense
from repro_torch.store import (
    BlockReadError,
    BlockReader,
    HostBudgetExceeded,
    StoreWriter,
    TxStore,
    export_dat,
    gather_rows,
    ingest_dat,
    pack_bool_np,
    parse_dat,
    sample_rows,
    streamed_itemset_supports,
    to_device_rows,
    to_device_shards,
    unpack_bool_np,
    write_dat,
    write_ibm_store,
)
from test_torch_cluster import reference_draws

ROOT = Path(__file__).resolve().parents[1]
FIXTURE = str(ROOT / "examples" / "retail_tiny.dat")
CPU = "cpu"


def _random_dense(n_tx, n_items, seed, density=0.3):
    return np.random.default_rng(seed).random((n_tx, n_items)) < density


def _store_from_dense(directory, dense, sizes, writer=StoreWriter):
    """A store (written by ``writer``, either package's) whose blocks cover
    ``dense`` with the given row counts."""
    assert sum(sizes) == dense.shape[0]
    w = writer(str(directory), n_items=dense.shape[1], block_tx=max(sizes) if sizes else 1)
    off = 0
    for sz in sizes:
        w.append_dense(dense[off:off + sz])
        off += sz
    return w.close()


def _masks(dense_masks):
    """Bool itemset masks as the port's int32 words."""
    return torch.from_numpy(pack_bool_np(dense_masks).view(np.int32))


def _fimi_params():
    return fimi.FimiParams(min_support_rel=0.1, n_db_sample=128, n_fi_sample=256,
                           eclat=eclat.EclatConfig(max_out=1 << 14, max_stack=2048,
                                                   frontier_size=8))


def _ref_fimi_params():
    return ref_fimi.FimiParams(min_support_rel=0.1, n_db_sample=128, n_fi_sample=256,
                               eclat=ref_eclat.EclatConfig(max_out=1 << 14, max_stack=2048,
                                                           frontier_size=8))


RAGGED = [
    [8, 8, 8, 8, 5],      # ragged final block
    [37],                 # single block
    [8, 0, 8, 8, 0, 13],  # empty blocks mid-stream
]


# ---------------------------------------------------------------------------
# Packing + disk format round-trips, and one format across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_items", [1, 5, 32, 40, 96])
def test_host_packing_matches_port_bitmap(n_items):
    dense = _random_dense(23, n_items, seed=n_items)
    packed = pack_bool_np(dense)
    assert packed.dtype == np.uint32
    assert np.array_equal(packed, bm.to_reference(bm.pack_bool(torch.from_numpy(dense))))
    assert np.array_equal(packed, ref_store.pack_bool_np(dense))
    assert np.array_equal(unpack_bool_np(packed, n_items), dense)


@pytest.mark.parametrize("sizes", RAGGED)
def test_store_roundtrip_ragged(tmp_path, sizes):
    dense = _random_dense(sum(sizes), 19, seed=1)
    s = _store_from_dense(tmp_path / "st", dense, sizes)
    assert s.n_tx == sum(sizes) and s.block_sizes == sizes
    assert np.array_equal(s.to_dense(), dense)
    assert np.array_equal(s.item_counts(), dense.sum(axis=0))
    s2 = TxStore.open(s.directory)
    assert s2.block_sizes == sizes and s2.n_tx == s.n_tx


def test_block_sketches_are_topk(tmp_path):
    dense = _random_dense(40, 24, seed=2, density=0.4)
    s = _store_from_dense(tmp_path / "st", dense, [40])
    meta = s.manifest.blocks[0]
    counts = dense.sum(axis=0)
    assert len(meta.sketch_items) <= 16
    got = dict(zip(meta.sketch_items, meta.sketch_counts))
    assert all(counts[i] == c for i, c in got.items())
    if got:
        floor = min(got.values())
        assert all(c <= floor for i, c in enumerate(counts) if i not in got)


@pytest.mark.parametrize("sizes", RAGGED)
def test_writers_produce_identical_stores(tmp_path, sizes):
    """Both packages' writers make the same manifest and the same block
    files, byte for byte."""
    dense = _random_dense(sum(sizes), 40, seed=3)
    port = _store_from_dense(tmp_path / "port", dense, sizes)
    ref = _store_from_dense(tmp_path / "ref", dense, sizes, writer=ref_store.StoreWriter)
    assert Path(port.directory, "manifest.json").read_text() == \
        Path(ref.directory, "manifest.json").read_text()
    names = sorted(os.listdir(Path(port.directory, "blocks")))
    assert names == sorted(os.listdir(Path(ref.directory, "blocks")))
    _, mismatch, errors = filecmp.cmpfiles(Path(port.directory, "blocks"),
                                           Path(ref.directory, "blocks"), names, shallow=False)
    assert mismatch == [] and errors == []


@pytest.mark.parametrize("sizes", RAGGED)
@pytest.mark.parametrize("written_by", ["port", "reference"])
def test_store_reads_back_in_the_other_package(tmp_path, sizes, written_by):
    dense = _random_dense(sum(sizes), 33, seed=4)
    writer = StoreWriter if written_by == "port" else ref_store.StoreWriter
    s = _store_from_dense(tmp_path / "st", dense, sizes, writer=writer)
    port, ref = TxStore.open(s.directory), ref_store.TxStore.open(s.directory)
    assert port.manifest.as_json() == ref.manifest.as_json()
    for i in range(port.n_blocks):
        assert np.array_equal(port.read_block(i), ref.read_block(i))
    assert np.array_equal(port.read_all_packed(), ref.read_all_packed())
    assert np.array_equal(port.to_dense(), dense)
    rows = torch.cat([blk for _, _, blk, _ in BlockReader(port, device=CPU).device_blocks()])
    assert np.array_equal(bm.to_reference(rows), ref.read_all_packed())


def test_read_block_into_a_caller_buffer(tmp_path):
    dense = _random_dense(30, 70, seed=5)
    s = _store_from_dense(tmp_path / "st", dense, [16, 14])
    buf = np.full(16 * s.n_words + 5, 7, np.uint32)
    got = s.read_block(1, out=buf)
    assert np.shares_memory(got, buf) and got.shape == (14, s.n_words)
    assert np.array_equal(got, pack_bool_np(dense[16:]))
    assert (buf[14 * s.n_words:] == 7).all()       # nothing past the block written
    with pytest.raises(ValueError, match="out must be"):
        s.read_block(0, out=np.zeros(10, np.uint32))


# ---------------------------------------------------------------------------
# FIMI .dat reader/writer
# ---------------------------------------------------------------------------


def test_fimi_dat_write_then_read_bitexact(tmp_path):
    labels0 = ["39", "41", "48", "170", "999", "32"]
    txs = [[3, 1, 2], [2, 5], [1], [5, 3, 2, 1], [0, 4]]
    path = str(tmp_path / "a.dat")
    write_dat(path, txs, labels=labels0)
    got, labels = parse_dat(path)
    assert (got, labels) == ref_store.parse_dat(path)
    want_sets = [{labels0[i] for i in tx} for tx in txs]
    assert [{labels[i] for i in tx} for tx in got] == want_sets
    path2, path3 = str(tmp_path / "b.dat"), str(tmp_path / "c.dat")
    write_dat(path2, got, labels=labels)
    got2, labels2 = parse_dat(path2)
    assert [{labels2[i] for i in tx} for tx in got2] == want_sets
    write_dat(path3, got2, labels=labels2)
    assert open(path3).read() == open(path2).read()


def test_ingest_export_roundtrip(tmp_path):
    txs, labels = parse_dat(FIXTURE)
    store = ingest_dat(FIXTURE, str(tmp_path / "st"), block_tx=7)
    ref = ref_store.ingest_dat(FIXTURE, str(tmp_path / "ref"), block_tx=7)
    assert store.manifest.as_json() == ref.manifest.as_json()
    assert store.n_tx == len(txs) and store.item_labels == labels
    dense = np.zeros((len(txs), len(labels)), bool)
    for t, tx in enumerate(txs):
        dense[t, tx] = True
    assert np.array_equal(store.to_dense(), dense)
    out = str(tmp_path / "out.dat")
    export_dat(store, out)
    ref_store.export_dat(ref, str(tmp_path / "ref.dat"))
    assert open(out).read() == open(tmp_path / "ref.dat").read()
    got, labels2 = parse_dat(out)
    assert [{labels2[i] for i in tx} for tx in got] == [{labels[i] for i in tx} for tx in txs]


def test_retail_tiny_fixture_frequencies(tmp_path):
    store = ingest_dat(FIXTURE, str(tmp_path / "st"), block_tx=16)
    labels = store.item_labels
    counts = dict(zip(labels, store.item_counts()))
    assert counts["39"] > store.n_tx * 0.5 and counts["48"] > store.n_tx * 0.5
    pair = np.zeros((1, store.n_items), bool)
    pair[0, [labels.index("39"), labels.index("48")]] = True
    sup = streamed_itemset_supports(store, _masks(pair))
    assert sup.dtype == torch.int64 and sup[0] >= store.n_tx * 0.4
    want = ref_store.streamed_itemset_supports(ref_store.TxStore.open(store.directory),
                                               pack_bool_np(pair))
    assert sup.tolist() == want.tolist()


# ---------------------------------------------------------------------------
# Streamed reader: residency budget + device assembly parity
# ---------------------------------------------------------------------------


def test_reader_residency_within_budget(tmp_path):
    dense = _random_dense(64, 40, seed=3)
    s = _store_from_dense(tmp_path / "st", dense, [16, 16, 16, 16])
    r = BlockReader(s, host_budget_blocks=2, device=CPU)
    rows = [bm.to_reference(dev) for _, _, dev, _ in r.device_blocks()]
    assert np.array_equal(np.concatenate(rows), pack_bool_np(dense))
    # double buffering holds at most two blocks: high-water <= budget
    assert 0 < r.peak_host_bytes <= r.budget_bytes == 2 * 16 * s.n_words * 4
    assert r.staging_bytes <= r.budget_bytes
    # every staging went into the other buffer than the last, and found its
    # buffer's previous block done with
    assert [(b, k) for b, k, _, _ in r.refills] == [(0, 0), (1, 1), (2, 0), (3, 1)]
    assert all(done for *_, done in r.refills)
    with pytest.raises(ValueError):
        BlockReader(s, host_budget_blocks=1, device=CPU)


def test_reader_refuses_to_refill_a_buffer_whose_copy_never_ran(tmp_path, monkeypatch):
    """The refill check can fail: a copy that leaves its staging buffer held
    without issuing anything makes the next staging into that buffer log
    False and raise, instead of overwriting rows the device never got."""
    dense = _random_dense(64, 40, seed=3)
    s = _store_from_dense(tmp_path / "st", dense, [16, 16, 16, 16])
    r = BlockReader(s, host_budget_blocks=2, device=CPU)

    def copy_never_issued(slot, n_rows, dst, side):
        return torch.zeros((n_rows, s.n_words), dtype=torch.int32)

    monkeypatch.setattr(r, "_copy", copy_never_issued)
    with pytest.raises(BlockReadError, match="buffer 0 still holds block 0"):
        list(r.device_blocks())
    assert r.refills == [(0, 0, None, True), (1, 1, None, True), (2, 0, 0, False)]


def test_reader_emits_host_bytes_counter_track(tmp_path):
    from repro_torch.obs import trace as obs_trace

    dense = _random_dense(64, 40, seed=5)
    s = _store_from_dense(tmp_path / "st", dense, [16, 16, 16, 16])
    r = BlockReader(s, host_budget_blocks=2, device=CPU)
    obs_trace.TRACER.enable()
    try:
        for _ in r.device_blocks():
            pass
        samples = [e for e in obs_trace.TRACER.export()["traceEvents"]
                   if e.get("ph") == "C" and e.get("name") == "host bytes"]
    finally:
        obs_trace.TRACER.disable()
        obs_trace.TRACER.clear()
    assert samples
    lives = [e["args"]["live"] for e in samples]
    assert max(lives) == r.peak_host_bytes > 0
    assert lives[-1] == 0.0                      # everything released
    assert all(e["args"]["peak"] <= r.peak_host_bytes for e in samples)


def test_reader_metrics(tmp_path):
    from repro_torch.obs import metrics as obs_metrics

    dense = _random_dense(48, 16, seed=6)
    s = _store_from_dense(tmp_path / "st", dense, [16, 16, 16])
    reg = obs_metrics.registry()
    blocks0 = reg.counter("store/blocks_read").value
    stalls0 = reg.histogram("store/prefetch_stall_s").count
    r = BlockReader(s, device=CPU)
    list(r.device_blocks())
    assert reg.counter("store/blocks_read").value - blocks0 == 3
    assert reg.histogram("store/prefetch_stall_s").count - stalls0 == 3
    assert reg.gauge("store/host_bytes_peak").value >= r.peak_host_bytes > 0


def test_reader_budget_enforced(tmp_path):
    """A reader that somehow over-holds raises instead of silently growing."""
    dense = _random_dense(32, 16, seed=4)
    s = _store_from_dense(tmp_path / "st", dense, [8, 8, 8, 8])
    r = BlockReader(s, host_budget_blocks=2, device=CPU)
    r.budget_bytes = 1  # simulate a misconfigured (too small) byte budget
    with pytest.raises(HostBudgetExceeded):
        list(r.device_blocks())


@pytest.mark.parametrize("n_tx,P,sizes", [
    (37, 2, [8, 8, 8, 8, 5]),     # ragged last + truncation (37 % 2 = 1)
    (32, 4, [32]),                # single block
    (29, 3, [8, 0, 8, 8, 0, 5]),  # empty blocks + truncation
])
def test_to_device_shards_matches_shard_db(tmp_path, n_tx, P, sizes):
    dense = _random_dense(n_tx, 19, seed=n_tx + P)
    s = _store_from_dense(tmp_path / "st", dense, sizes)
    got = to_device_shards(s, P, device=CPU)
    want = fimi.shard_db(dense, P, CPU)
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert torch.equal(got, want)
    assert np.array_equal(bm.to_reference(got), np.asarray(ref_fimi.shard_db(dense, P)))


def test_to_device_rows_prefix_reads_only_what_it_needs(tmp_path, monkeypatch):
    dense = _random_dense(40, 19, seed=7)
    s = _store_from_dense(tmp_path / "st", dense, [8, 8, 8, 8, 8])
    r = BlockReader(s, device=CPU)
    got = to_device_rows(s, 13, reader=r)
    assert torch.equal(got, torch.from_numpy(pack_bool_np(dense[:13]).view(np.int32)))
    assert r.refills[-1][0] <= 2      # blocks 3 and 4 were never needed
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(ValueError, match="streams to cpu"):
        to_device_rows(s, reader=r, device="cuda")


def test_gather_rows_with_duplicates(tmp_path):
    dense = _random_dense(30, 19, seed=5)
    s = _store_from_dense(tmp_path / "st", dense, [8, 8, 8, 6])
    idx = np.array([29, 0, 7, 8, 7, 15, 29, 29])
    assert np.array_equal(gather_rows(s, idx), pack_bool_np(dense)[idx])
    assert np.array_equal(gather_rows(s, torch.from_numpy(idx)), pack_bool_np(dense)[idx])


# ---------------------------------------------------------------------------
# Off-disk Thm 6.1 sample: the reference's rows at the reference's indices
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
def test_sample_rows_given_reference_indices(tmp_path, seed):
    dense = _random_dense(96, 24, seed=6)
    s = _store_from_dense(tmp_path / "st", dense, [32, 32, 32])
    key = jax.random.PRNGKey(seed)
    idx = np.array(jax.random.randint(key, (40,), 0, 96))
    got = sample_rows(s, torch.from_numpy(idx.astype(np.int64)), device=CPU)
    want = ref_store.sample_rows(ref_store.TxStore.open(s.directory), key, 40)
    assert np.array_equal(bm.to_reference(got), np.asarray(want))
    flat = fimi.shard_db(dense, 1, CPU)[0]
    assert torch.equal(got, bm.sample_transactions(flat, 40, idx=torch.from_numpy(idx)))


def test_offdisk_sample_meets_thm61_bound(tmp_path):
    from repro_torch.core import sampling

    p = IBMParams(n_tx=2048, n_items=24, n_patterns=8, avg_pattern_len=5, avg_tx_len=8, seed=9)
    store = write_ibm_store(p, str(tmp_path / "ibm"), block_tx=256)
    eps, delta = 0.05, 0.1
    n = min(sampling.db_sample_size(eps, delta), store.n_tx)
    idx = torch.randint(0, store.n_tx, (n,), generator=torch.Generator().manual_seed(2))
    samp = unpack_bool_np(bm.to_reference(sample_rows(store, idx, device=CPU)), store.n_items)
    est_rel = samp.sum(axis=0) / n
    true_rel = store.item_counts() / store.n_tx
    assert np.abs(est_rel - true_rel).max() <= np.sqrt(np.log(2.0 / delta) / (2.0 * n))


def test_streamed_itemset_supports_exact(tmp_path):
    dense = _random_dense(60, 24, seed=8, density=0.35)
    s = _store_from_dense(tmp_path / "st", dense, [16, 16, 0, 16, 12])
    masks_dense = _random_dense(9, 24, seed=9, density=0.12)
    masks_dense[0] = False  # the empty itemset: contained in every row
    got = streamed_itemset_supports(s, _masks(masks_dense))
    want = np.array([(~(m[None, :] & ~dense).any(axis=1)).sum() for m in masks_dense])
    assert got.dtype == torch.int64 and np.array_equal(got.numpy(), want)
    assert got[0] == 60
    ref = ref_store.streamed_itemset_supports(ref_store.TxStore.open(s.directory),
                                              pack_bool_np(masks_dense))
    assert np.array_equal(got.numpy(), ref)


# ---------------------------------------------------------------------------
# Out-of-core mining parity: fimi.run(store) == the reference's FITable
# ---------------------------------------------------------------------------


STORE_N_TX = 300


@pytest.fixture(scope="module")
def ibm300():
    return generate_dense(IBMParams(n_tx=STORE_N_TX, n_items=24, n_patterns=8,
                                    avg_pattern_len=5, avg_tx_len=8, seed=3))


@pytest.fixture(scope="module")
def reference_store_fis(ibm300, tmp_path_factory):
    """A store written by the reference and mined out of core by the
    reference: ``(store directory, FITable)``."""
    d = tmp_path_factory.mktemp("ref_store") / "st"
    s = _store_from_dense(d, ibm300, [64, 64, 64, 64, 44], writer=ref_store.StoreWriter)
    res = ref_fimi.run(s, None, _ref_fimi_params(), jax.random.PRNGKey(0),
                       materialize=True, P=4)
    assert len(res.fi_dict) > 0
    return s.directory, res.fi_dict


@pytest.mark.parametrize("sizes,P", [
    ([64, 64, 64, 64, 44], 4),         # ragged last block
    ([300], 4),                        # single block
    ([64, 0, 64, 64, 64, 0, 44], 2),   # empty blocks mid-stream
])
def test_fimi_run_store_parity(tmp_path, ibm300, reference_store_fis, sizes, P):
    """The port mines a store of each layout (every one holding the same 300
    rows, which P divides) to the reference's FITable of those rows."""
    s = _store_from_dense(tmp_path / "st", ibm300, sizes)
    r = BlockReader(s, device=CPU)
    got = fimi.run(s, None, _fimi_params(), device=CPU, materialize=True, P=P, reader=r)
    dense_run = fimi.run(fimi.shard_db(ibm300, P, CPU), 24, _fimi_params(), device=CPU,
                         materialize=True)
    assert got.fi_dict == reference_store_fis[1] == dense_run.fi_dict
    # the same shards give the same plan: one sample, one partition
    np.testing.assert_array_equal(got.assignment, dense_run.assignment)
    assert "assemble_store" in got.phase_s and 0 < r.peak_host_bytes <= r.budget_bytes


def test_both_packages_mine_one_store(reference_store_fis):
    """The reference-written store the reference mined, mined by the port."""
    directory, want = reference_store_fis
    got = fimi.run(TxStore.open(directory), None, _fimi_params(), device=CPU,
                   materialize=True, P=4).fi_dict
    assert got == want


def test_fimi_run_store_requires_P(tmp_path):
    s = _store_from_dense(tmp_path / "st", _random_dense(32, 16, seed=10), [32])
    with pytest.raises(ValueError, match="P"):
        fimi.run(s, None, _fimi_params(), device=CPU)


def test_planner_store_parity(tmp_path):
    from test_torch_planner import assert_same_plan

    p = IBMParams(n_tx=300, n_items=24, n_patterns=8, avg_pattern_len=5, avg_tx_len=8, seed=3)
    dense = generate_dense(p)
    s = _store_from_dense(tmp_path / "st", dense, [64, 64, 64, 64, 44])
    pp = dict(min_support_rel=0.1, n_db_sample=128, n_fi_sample=256)
    want = ref_cluster.plan(ref_fimi.shard_db(dense, 4), 24, ref_cluster.PlannerParams(**pp),
                            jax.random.PRNGKey(0))
    sample_idx, draws = reference_draws(0, 300 // 4 * 4, pp["n_db_sample"])
    got = cluster.plan(s, None, cluster.PlannerParams(**pp), device=CPU, P=4,
                       sample_idx=sample_idx, reservoir_draws=draws)
    assert_same_plan(got, want)
    # with torch's own draws, the store's plan is the in-RAM shards' plan
    a = cluster.plan(fimi.shard_db(dense, 4, CPU), 24, cluster.PlannerParams(**pp),
                     seed=5, device=CPU)
    b = cluster.plan(s, None, cluster.PlannerParams(**pp), seed=5, device=CPU, P=4)
    assert_same_plan(b, a)
    with pytest.raises(ValueError, match="P"):
        cluster.plan(s, None, cluster.PlannerParams(**pp), device=CPU)


def test_cluster_execute_from_store_plan(tmp_path):
    """Executor fed the off-disk plan + block-assembled shards stays exact."""
    p = IBMParams(n_tx=240, n_items=24, n_patterns=8, avg_pattern_len=5, avg_tx_len=8, seed=5)
    dense = generate_dense(p)
    s = _store_from_dense(tmp_path / "st", dense, [64, 64, 64, 48])
    params = cluster.ClusterParams(
        planner=cluster.PlannerParams(min_support_rel=0.12, n_db_sample=128, n_fi_sample=256),
        eclat=eclat.EclatConfig(max_out=1 << 14, max_stack=2048, frontier_size=8),
    )
    plan = cluster.plan(s, None, params.planner, device=CPU, P=4)
    res = cluster.execute(to_device_shards(s, 4, device=CPU), 24, params, device=CPU, plan=plan)
    assert res.table.to_dict() == eclat.brute_force_fis(dense, int(np.ceil(0.12 * 240)))


# ---------------------------------------------------------------------------
# IBM spill and blocked generation
# ---------------------------------------------------------------------------


def test_ibm_spill_matches_blocked_generation(tmp_path):
    p = IBMParams(n_tx=100, n_items=24, n_patterns=8, avg_pattern_len=5, avg_tx_len=8, seed=3)
    s = write_ibm_store(p, str(tmp_path / "ibm"), block_tx=32)
    assert s.block_sizes == [32, 32, 32, 4]
    assert np.array_equal(s.to_dense(), np.concatenate(list(ibm_gen.generate_blocks(p, 32))))
    ref = ref_store.write_ibm_store(ref_gen.IBMParams(**vars(p)), str(tmp_path / "ref"),
                                    block_tx=32)
    assert s.manifest.as_json() == ref.manifest.as_json()


@pytest.mark.parametrize("n_tx,block_tx,seed", [(100, 32, 3), (64, 64, 11), (50, 7, 1),
                                                (10, 100, 2)])
def test_generate_blocks_bitequal_reference(n_tx, block_tx, seed):
    kw = dict(n_tx=n_tx, n_items=24, n_patterns=8, avg_pattern_len=5, avg_tx_len=8, seed=seed)
    got = list(ibm_gen.generate_blocks(IBMParams(**kw), block_tx))
    want = list(ref_gen.generate_blocks(ref_gen.IBMParams(**kw), block_tx))
    assert len(got) == len(want) == -(-n_tx // block_tx)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert IBMParams(**kw).name == ref_gen.IBMParams(**kw).name
    with pytest.raises(ValueError):
        next(ibm_gen.generate_blocks(IBMParams(**kw), 0))


def test_generate_blocks_single_block_is_generate_dense():
    p = IBMParams(n_tx=64, n_items=24, n_patterns=8, avg_pattern_len=5, avg_tx_len=8, seed=11)
    blocks = list(ibm_gen.generate_blocks(p, 64))
    assert len(blocks) == 1 and np.array_equal(blocks[0], generate_dense(p))


# ---------------------------------------------------------------------------
# fsck: one report from either package on a port-written store
# ---------------------------------------------------------------------------


def _damaged_copy(src, dst):
    from faults import corrupt_block, orphan_block

    shutil.copytree(src, dst)
    corrupt_block(dst, 0, "bitflip")
    corrupt_block(dst, 2, "delete")
    orphan_block(dst, n_rows=4)
    return dst


@pytest.mark.parametrize("mode", ["scan", "repair", "quarantine"])
def test_fsck_report_equals_reference(tmp_path, mode):
    from repro.store import fsck as ref_fsck
    from repro_torch.store import fsck as port_fsck   # the functions

    s = _store_from_dense(tmp_path / "st", _random_dense(128, 16, seed=12), [32, 32, 32, 32])
    kw = {"scan": {}, "repair": {"repair": True}, "quarantine": {"quarantine": True}}[mode]
    a = port_fsck(_damaged_copy(s.directory, str(tmp_path / "x" / "st")), **kw)
    b = ref_fsck(_damaged_copy(s.directory, str(tmp_path / "y" / "st")), **kw)
    assert [(d.kind, os.path.relpath(d.path, a.directory), d.block_index, d.action)
            for d in a.damages] == \
        [(d.kind, os.path.relpath(d.path, b.directory), d.block_index, d.action)
         for d in b.damages]
    assert (a.n_blocks, a.n_tx, a.clean) == (b.n_blocks, b.n_tx, b.clean)
    assert a.summary().replace(a.directory, "S") == b.summary().replace(b.directory, "S")
    assert json.loads(Path(a.directory, "manifest.json").read_text()) == \
        json.loads(Path(b.directory, "manifest.json").read_text())


def test_fsck_cli_reports_equal(tmp_path):
    """``repro.launch.fsck`` and ``repro_torch.launch.fsck`` print the same
    report and exit alike on a damaged port-written store."""
    s = _store_from_dense(tmp_path / "st", _random_dense(96, 16, seed=13), [32, 32, 32])
    outs = []
    for pkg, where in (("repro", "x"), ("repro_torch", "y")):
        d = _damaged_copy(s.directory, str(tmp_path / where / "st"))
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        done = subprocess.run([sys.executable, "-m", f"{pkg}.launch.fsck", d],
                              capture_output=True, text=True, env=env, timeout=120)
        outs.append((done.returncode, done.stdout.replace(d, "S"), done.stderr))
    assert outs[0][0] == outs[1][0] == 1
    assert outs[0][1] == outs[1][1] and "[bit-flip]" in outs[1][1]


# ---------------------------------------------------------------------------
# Launchers: --store / --dataset / --parity on the CPU
# ---------------------------------------------------------------------------


def honest_high_waters(directory, budget: int) -> set:
    """The host high-waters the double-buffered reader can report on the
    store at ``directory``: one block's bytes, or the sum of two consecutive
    blocks' (the worker stages the next while the last is still copied),
    each size read from the store's manifest, none above ``budget``.  The
    high-water is a maximum over the whole run, in which every block is
    read, so it is never below the largest block."""
    store = TxStore.open(str(directory))
    sizes = [n * store.n_words * 4 for n in store.block_sizes]
    both = {a + b for a, b in zip(sizes, sizes[1:])}
    return {s for s in set(sizes) | both if max(sizes) <= s <= budget}


def test_honest_high_waters_of_the_launcher_store(tmp_path):
    """The launcher's store (500 rows in blocks of 64, one word a row): seven
    blocks of 256 B and a last of 52 rows, 208 B, which alone is never the
    run's high-water (the 256 B blocks come before it)."""
    s = write_ibm_store(ibm_gen.params_from_name("T0.5I0.024P8PL5TL8"), str(tmp_path / "st"),
                        64)
    assert s.block_sizes == [64] * 7 + [52]
    assert honest_high_waters(tmp_path / "st", 512) == {256, 464, 512}
    assert honest_high_waters(tmp_path / "st", 256) == {256}


def test_mine_launcher_store_parity(tmp_path, capsys):
    from repro_torch.launch import mine

    argv = ["--device", "cpu", "--db", "T0.5I0.024P8PL5TL8", "--support", "0.08",
            "--store", str(tmp_path / "st"), "--blocktx", "64", "--parity"]
    res = mine.main(argv)
    out = capsys.readouterr().out
    assert "store: 8 blocks x <= 64 tx (2000 packed bytes on disk)" in out
    assert "parity vs dense in-RAM fimi.run: OK" in out and "> host budget 512B" in out
    # one block, or two consecutive ones, held at once, as the worker and the
    # copy meet: 256 B, 512 B, or 464 B when the last two (256 + 208) overlap
    high = re.search(r"streamed host high-water: (\d+) bytes \(budget 512\)", out)
    assert high and int(high.group(1)) in honest_high_waters(tmp_path / "st", 512)
    assert '"assemble_store"' in out and res.n_fis == len(res.fi_dict) > 0


def test_mine_launcher_dataset_parity(tmp_path, capsys):
    from repro_torch.launch import mine

    mine.main(["--device", "cpu", "--dataset", FIXTURE, "--support", "0.2", "-P", "2",
               "--parity", "--store", str(tmp_path / "st")])
    out = capsys.readouterr().out
    assert f"dataset={FIXTURE}" in out and "fits the host budget" in out
    assert "parity vs dense in-RAM fimi.run: OK" in out


def test_mine_launcher_store_needs_cuda_or_cpu_flag(tmp_path, monkeypatch):
    from repro_torch.launch import mine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mine.main(["--dataset", FIXTURE, "--store", str(tmp_path / "st")])
    with pytest.raises(SystemExit) as ei:   # --parity without a store
        mine.main(["--device", "cpu", "--db", "T0.1I0.01P5PL3TL4", "--parity"])
    assert ei.value.code == 2


def test_cluster_mine_launcher_store_parity(tmp_path, capsys):
    from repro_torch.launch import cluster_mine

    res = cluster_mine.main(["--device", "cpu", "--db", "T0.3I0.024P8PL5TL8", "--support",
                             "0.1", "--store", str(tmp_path / "st"), "--blocktx", "64",
                             "--parity"])
    out = capsys.readouterr().out
    assert "store: 5 blocks x <= 64 tx (1200 packed bytes; plan sampled off-disk)" in out
    assert "parity vs single-device fimi.run: OK" in out
    assert {"plan", "assemble"} <= set(res.report.phase_ms)


def test_resolve_source(tmp_path):
    from repro_torch.launch.data_source import resolve_source

    store, dense, label = resolve_source("", "", "T0.1I0.01P5PL3TL4", block_tx=32, seed=1)
    assert store is None and dense.shape == (100, 10) and label == "db=T0.1I0.01P5PL3TL4"
    d = str(tmp_path / "st")
    store, dense, label = resolve_source("", d, "T0.1I0.01P5PL3TL4", block_tx=32, seed=1)
    assert dense is None and store.block_sizes == [32, 32, 32, 4]
    assert label == f"store={d} (spilled from T0.1I0.01P5PL3TL4)"
    assert store.manifest.source == "ibm:T0.1I0.01P5PL3TL4:seed=1"
    store, _, label = resolve_source("", d, "ignored", block_tx=8, seed=0)
    assert label == f"store={d}" and store.block_tx == 32      # opened, not re-spilled
    store, _, label = resolve_source(FIXTURE, str(tmp_path / "ds"), "", block_tx=16, seed=0)
    assert label == f"dataset={FIXTURE}" and store.item_labels


def test_store_host_tools_import_no_torch(tmp_path):
    """The writer, ``fsck`` and the fsck CLI stay importable without torch."""
    code = (
        "import json, sys\n"
        "import numpy as np\n"
        "import repro_torch.store as st\n"
        "from repro_torch.launch import fsck as cli\n"
        f"w = st.StoreWriter({str(tmp_path / 'st')!r}, n_items=9, block_tx=4)\n"
        "w.append_dense(np.eye(4, 9, dtype=bool)); s = w.close()\n"
        "assert st.fsck(s.directory).clean\n"
        "print(json.dumps(sorted(m for m in sys.modules"
        " if m.split('.')[0] in ('torch', 'jax', 'repro'))))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, timeout=120)
    assert done.returncode == 0, done.stderr
    assert json.loads(done.stdout.strip().splitlines()[-1]) == []

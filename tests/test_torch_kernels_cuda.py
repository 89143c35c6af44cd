"""The CUDA kernels B1–B7 against their plain torch versions, on the card.

Every case carries the ``cuda`` marker and skips where CUDA is not available.
The file imports neither JAX nor the JAX package, so it runs on a machine
with a card and PyTorch alone:

  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_kernels_cuda.py

The plain versions are held to the Pallas kernels in ``test_torch_kernels.py``.
Supports are integers, so every comparison is exact.
"""
import numpy as np
import pytest
import torch

from repro_torch.core import bitmap as bm
from repro_torch.kernels import bitmap_support as bs
from repro_torch.kernels import delta_support as ds
from repro_torch.kernels import multi_support as ms
from repro_torch.kernels import ops
from repro_torch.kernels import pair_support as ps
from repro_torch.kernels import subset_query as sq

pytestmark = pytest.mark.cuda

# ragged (K, I, W), the main path's shapes (Phase 1: W=64; Phase 4: W=15625),
# edges of the kernels' tiles, and empty axes
MULTI_SHAPES = [
    (1, 7, 2), (3, 16, 1), (8, 33, 9), (13, 40, 130), (5, 130, 33), (64, 24, 17),
    (16, 100, 64), (16, 100, 15625), (1, 100, 15625), (64, 100, 3907),
    (9, 5, 1025), (17, 131, 4097), (0, 10, 8), (4, 0, 8), (4, 10, 0),
]
# B2: K pads to 16 and I to 32 inside the kernel; W splits over blocks
MXU_SHAPES = [
    (k, i, w) for k in (1, 13, 16, 17, 64) for i in (1, 7, 8, 33, 100, 131)
    for w in (1, 2, 33, 1025)
] + [(16, 100, 15625), (64, 100, 15625), (0, 10, 8), (4, 0, 8), (4, 10, 0)]
# B2's edges: K around its m-tiles and tiles of 16, I around its n-tiles of 8
# and tiles of 32, W around its stages of 32 words and its chunks, odd and
# 1 mod 4 (rows start 4 bytes apart from a 16-byte boundary)
B2_RAGGED = [(k, i, w) for k in (1, 15, 16, 17, 63, 64, 65, 129)
             for i in (1, 7, 8, 9, 100, 127, 128, 129, 131)
             for w in (1, 7, 8, 9, 118, 119, 15625, 16384)]
MXU_SHAPES += B2_RAGGED
SINGLE_SHAPES = [
    (7, 2), (16, 1), (33, 9), (130, 33), (53, 300),
    (100, 64), (100, 15625), (1, 1), (257, 4097), (0, 9), (9, 0),
]


def _words(shape, seed):
    """Random uint32 words, every bit equally likely (the sign bit included)."""
    return np.random.default_rng(seed).integers(0, 2**32, size=shape, dtype=np.uint32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available")
    return torch.device("cuda")


@pytest.mark.parametrize("k,i,w", MULTI_SHAPES)
def test_multi_kernel_matches_plain(cuda, k, i, w):
    items = bm.from_reference(_words((i, w), seed=i + w)).to(cuda)
    tids = bm.from_reference(_words((k, w), seed=k * w + 1)).to(cuda)
    before = ms.multi_extension_supports_cuda.launches
    got = ops.multi_extension_supports(items, tids)
    torch.cuda.synchronize()
    # a launch is counted where the kernel runs; an empty axis launches nothing
    assert ms.multi_extension_supports_cuda.launches == before + (k * i * w > 0)
    assert got.is_cuda and got.dtype == torch.int32 and got.shape == (k, i)
    assert torch.equal(got, ms.multi_extension_supports_plain(items, tids))


@pytest.mark.parametrize("i,w", SINGLE_SHAPES)
def test_single_kernel_matches_plain(cuda, i, w):
    items = bm.from_reference(_words((i, w), seed=i * 7 + w)).to(cuda)
    tid = bm.from_reference(_words((w,), seed=w + 5)).to(cuda)
    before = bs.extension_supports_cuda.launches
    got = ops.extension_supports(items, tid)
    torch.cuda.synchronize()
    assert bs.extension_supports_cuda.launches == before + (i > 0)
    assert got.is_cuda and got.dtype == torch.int32 and got.shape == (i,)
    assert torch.equal(got, bs.extension_supports_plain(items, tid))


# B1's edges: W around the chunks of a cluster and the switch from 128- to
# 512-thread blocks (W = 2048), K and I around the 8 x 4 tile; W = 1 gives
# one-block clusters, K <= 8 and I = 1 with W >= 16384 the widest (8 blocks)
B1_RAGGED = [(k, i, w) for k in (1, 7, 16, 17, 64) for i in (1, 100, 129)
             for w in (1, 3, 5, 4096, 4097, 15625, 16384, 16385)]


@pytest.mark.parametrize("k,i,w", B1_RAGGED)
def test_multi_kernel_ragged_edges(cuda, k, i, w):
    items = bm.from_reference(_words((i, w), seed=3 * i + w)).to(cuda)
    tids = bm.from_reference(_words((k, w), seed=5 * k + w)).to(cuda)
    got = ms.multi_extension_supports_cuda(items, tids)
    torch.cuda.synchronize()
    assert torch.equal(got, ms.multi_extension_supports_plain(items, tids))


def test_multi_kernel_clusters_and_loads(cuda):
    """The ragged shapes reach clusters of one block and of eight, every
    cluster in one wave; rows that do not start on a 16-byte boundary give
    the same counts."""
    facts = [ms.launch_facts(torch.zeros((i, w), dtype=torch.int32, device=cuda),
                             torch.zeros((k, w), dtype=torch.int32, device=cuda))
             for k, i, w in B1_RAGGED]
    assert {f["cluster"] for f in facts} >= {1, 8}
    assert all(f["waves"] == 1 for f in facts if f["cluster"] > 1)
    flat = bm.from_reference(_words((100 * 4096 + 1,), seed=12)).to(cuda)
    items = flat[1:].view(100, 4096)
    tids = bm.from_reference(_words((16, 4096), seed=13)).to(cuda)
    assert torch.equal(ms.multi_extension_supports_cuda(items, tids),
                       ms.multi_extension_supports_plain(items, tids))


def test_wrappers_check_their_inputs(cuda):
    items = torch.zeros((6, 8), dtype=torch.int32, device=cuda)
    tids = torch.zeros((3, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ms.multi_extension_supports_cuda(items.to(torch.int64), tids)
    with pytest.raises(ValueError):
        ms.multi_extension_supports_cuda(items, tids[:, :4])
    with pytest.raises(ValueError):  # [6, 8] with the strides of a transpose
        ms.multi_extension_supports_cuda(torch.zeros_like(items).reshape(8, 6).t(), tids)
    with pytest.raises(ValueError):
        bs.extension_supports_cuda(items, tids[0, :5])
    with pytest.raises(ValueError):
        bs.extension_supports_cuda(items[:, ::2], tids[0, :4])
    with pytest.raises(ValueError):
        ms.multi_extension_supports_cuda(items, tids.cpu())


@pytest.mark.parametrize("k,i,w", MXU_SHAPES)
def test_mxu_kernel_matches_plain_and_b1(cuda, k, i, w):
    items = bm.from_reference(_words((i, w), seed=i * 3 + w)).to(cuda)
    tids = bm.from_reference(_words((k, w), seed=k * w + 11)).to(cuda)
    before = ms.multi_extension_supports_mxu_cuda.launches
    got = ops.multi_extension_supports(items, tids, use_mxu=True)
    torch.cuda.synchronize()
    assert ms.multi_extension_supports_mxu_cuda.launches == before + (k * i * w > 0)
    assert got.is_cuda and got.dtype == torch.int32 and got.shape == (k, i)
    assert torch.equal(got, ms.multi_extension_supports_mxu_plain(items, tids))
    assert torch.equal(got, ms.multi_extension_supports_cuda(items, tids))


def test_mxu_kernel_launch_facts(cuda):
    """B2's grid covers every prefix and item tile and every word, in one
    wave at the path's shapes, with no spilled registers."""
    for k, i, w in [(64, 100, 15625), (16, 100, 15625), (1, 1, 1)] + B2_RAGGED[::37]:
        facts = ms.mxu_launch_facts(torch.zeros((i, w), dtype=torch.int32, device=cuda),
                                    torch.zeros((k, w), dtype=torch.int32, device=cuda))
        assert facts["grid_y"] == -(-k // 16) and facts["grid_z"] == -(-i // 32)
        assert facts["grid_x"] * facts["chunk_words"] >= w > (facts["grid_x"] - 1) * facts[
            "chunk_words"]
        assert facts["threads"] == 128 and facts["local_bytes"] == 0
        assert facts["blocks_per_sm"] >= 1 and facts["registers"] > 0
    assert ms.mxu_launch_facts(torch.zeros((100, 15625), dtype=torch.int32, device=cuda),
                               torch.zeros((64, 15625), dtype=torch.int32, device=cuda)
                               )["waves"] == 1
    with pytest.raises(RuntimeError):  # no launch has an empty axis
        ms.mxu_launch_facts(torch.zeros((4, 8), dtype=torch.int32, device=cuda),
                            torch.zeros((0, 8), dtype=torch.int32, device=cuda))


def test_mxu_wrapper_checks_its_inputs(cuda):
    items = torch.zeros((6, 8), dtype=torch.int32, device=cuda)
    tids = torch.zeros((3, 8), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        ms.multi_extension_supports_mxu_cuda(items.to(torch.int64), tids)
    with pytest.raises(TypeError):
        ms.multi_extension_supports_mxu_cuda(items, tids.to(torch.uint8))
    with pytest.raises(ValueError):
        ms.multi_extension_supports_mxu_cuda(items, tids[:, :4])
    with pytest.raises(ValueError):
        ms.multi_extension_supports_mxu_cuda(items[0], tids)
    with pytest.raises(ValueError):  # [6, 8] with the strides of a transpose
        ms.multi_extension_supports_mxu_cuda(torch.zeros_like(items).reshape(8, 6).t(), tids)
    with pytest.raises(ValueError):
        ms.multi_extension_supports_mxu_cuda(items, tids.cpu())
    with pytest.raises(ValueError):
        ms.multi_extension_supports_mxu_cuda(items.cpu(), tids.cpu())


def test_use_mxu_on_the_card_never_reaches_a_plain_version(cuda, monkeypatch):
    items = bm.from_reference(_words((33, 40), seed=1)).to(cuda)
    tids = bm.from_reference(_words((17, 40), seed=2)).to(cuda)
    want = ms.multi_extension_supports_mxu_plain(items, tids)

    def refuse(*args):
        raise AssertionError("a plain version ran on CUDA tensors")

    monkeypatch.setattr(ms, "multi_extension_supports_mxu_plain", refuse)
    monkeypatch.setattr(ms, "multi_extension_supports_plain", refuse)
    before = ops.kernel_launches()
    got = ops.multi_extension_supports(items, tids, use_mxu=True)
    after = ops.kernel_launches()
    assert torch.equal(got, want)
    assert after["multi_extension_supports_mxu"] == before["multi_extension_supports_mxu"] + 1
    assert after["multi_extension_supports"] == before["multi_extension_supports"]


# B4 and B5: ragged query, itemset and row counts against 1, 4 (100 items),
# 9 and 40 item words; the serving and streaming paths' shapes
SWEEP_SIZES = (1, 7, 129, 1000)
SWEEP_WORDS = (1, 4, 9, 40)
SUBSET_SHAPES = [(q, f, iw) for q in SWEEP_SIZES for f in SWEEP_SIZES for iw in SWEEP_WORDS] + [
    (256, 15324, 4), (256, 2 * 72000, 4), (0, 5, 4), (5, 0, 4), (3, 5, 0)]
BLOCK_SHAPES = [(s, t, f, iw) for s in (1, 2) for t in SWEEP_SIZES for f in SWEEP_SIZES
                for iw in SWEEP_WORDS] + [
    (2, 65536, 15324, 4), (8, 4096, 300, 4), (0, 4, 5, 4), (2, 0, 5, 4), (2, 4, 0, 4),
    (1, 33, 7, 0), (3, 50, 20, 300)]


def _sets_from_rows(rows, n, seed):
    """``n`` itemsets: sparse subsets of the given rows (containment is
    common), random words, and ∅ first."""
    rng = np.random.default_rng(seed)
    iw = rows.shape[-1]
    flat = rows.reshape(int(np.prod(rows.shape[:-1])), iw)
    sets = _words((n, iw), seed)
    for r in range(n):
        if r % 3 and len(flat):
            sparse = (_words((iw,), seed + r) & _words((iw,), seed + r + 1)
                      & _words((iw,), seed + r + 2))
            sets[r] = flat[rng.integers(len(flat))] & sparse
    if n:
        sets[0] = 0
    return sets


@pytest.mark.parametrize("q,f,iw", SUBSET_SHAPES)
def test_subset_query_kernel_matches_plain(cuda, q, f, iw):
    queries = _words((q, iw), seed=q + 3 * f + iw)
    sets = _sets_from_rows(queries, f, seed=q * f + iw + 1)
    queries, sets = bm.from_reference(queries).to(cuda), bm.from_reference(sets).to(cuda)
    before = sq.subset_superset_counts_cuda.launches
    miss, extra = ops.subset_superset_counts(queries, sets)
    torch.cuda.synchronize()
    assert sq.subset_superset_counts_cuda.launches == before + (q * f > 0)
    assert miss.is_cuda and miss.dtype == extra.dtype == torch.int32
    assert miss.shape == extra.shape == (q, f)
    want_miss, want_extra = sq.subset_superset_counts_plain(queries, sets)
    assert torch.equal(miss, want_miss) and torch.equal(extra, want_extra)


@pytest.mark.parametrize("s,t,f,iw", BLOCK_SHAPES)
def test_block_support_kernel_matches_plain(cuda, s, t, f, iw):
    tx = _words((s, t, iw), seed=s + t + f + iw) | _words((s, t, iw), seed=t * 7 + iw)
    sets = _sets_from_rows(tx, f, seed=f * 3 + t)
    tx, sets = bm.from_reference(tx).to(cuda), bm.from_reference(sets).to(cuda)
    before = ds.block_itemset_supports_cuda.launches
    got = ops.block_itemset_supports(tx, sets)
    torch.cuda.synchronize()
    assert ds.block_itemset_supports_cuda.launches == before + (s * t * f > 0)
    assert got.is_cuda and got.dtype == torch.int32 and got.shape == (s, f)
    assert torch.equal(got, ds.block_itemset_supports_plain(tx, sets))
    if f:
        assert (got[:, 0] == t).all()     # ∅ is in every real row, and only those


# B5's edges: both word forms (IW <= 4, wider), T not a multiple of the
# row tile or of a block's rows, F not a multiple of a block's itemsets,
# S = 1 to 3, and the empty itemset first
B5_RAGGED = [(s, t, f, iw) for s in (1, 2, 3) for iw in (1, 3, 4, 5, 8, 9, 33)
             for t, f in ((70001, 1025), (257, 3))]


@pytest.mark.parametrize("s,t,f,iw", B5_RAGGED)
def test_block_support_kernel_ragged_edges(cuda, s, t, f, iw):
    tx = _words((s, t, iw), seed=s * t + iw) | _words((s, t, iw), seed=t + 2 * iw)
    sets = _sets_from_rows(tx, f, seed=f + iw)
    tx, sets = bm.from_reference(tx).to(cuda), bm.from_reference(sets).to(cuda)
    got = ds.block_itemset_supports_cuda(tx, sets)
    torch.cuda.synchronize()
    assert torch.equal(got, ds.block_itemset_supports_plain(tx, sets))
    assert (got[:, 0] == t).all()


def test_block_support_kernel_launch(cuda):
    """One wave of blocks, no spilled registers in either word form, and rows
    that do not start on a 16-byte boundary staged word by word with the
    same counts."""
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    for iw, form in ((4, 4), (8, 0), (9, 0)):
        tx = torch.zeros((2, 65536, iw), dtype=torch.int32, device=cuda)
        facts = ds.launch_facts(tx, torch.zeros((15324, iw), dtype=torch.int32, device=cuda))
        assert facts["word_form"] == form and facts["local_bytes"] == 0
        assert facts["grid_x"] == sms * facts["blocks_per_sm"]
    flat = _words((2 * 3001 * 4 + 1,), seed=14) | _words((2 * 3001 * 4 + 1,), seed=15)
    tx = bm.from_reference(flat).to(cuda)[1:].view(2, 3001, 4)
    sets = bm.from_reference(_sets_from_rows(bm.to_reference(tx.cpu()), 700, seed=16)).to(cuda)
    assert ds.launch_facts(tx, sets)["vec128"] == 0
    assert torch.equal(ds.block_itemset_supports_cuda(tx, sets),
                       ds.block_itemset_supports_plain(tx, sets))


def test_delta_supports_on_the_card_never_reaches_a_plain_version(cuda, monkeypatch):
    tx = bm.from_reference(_words((2, 300, 4), seed=3) | _words((2, 300, 4), seed=4)).to(cuda)
    sets = bm.from_reference(_sets_from_rows(bm.to_reference(tx), 77, seed=5)).to(cuda)
    want = ds.block_itemset_supports_plain(tx, sets)

    def refuse(*args):
        raise AssertionError("a plain version ran on CUDA tensors")

    monkeypatch.setattr(ds, "block_itemset_supports_plain", refuse)
    monkeypatch.setattr(sq, "subset_superset_counts_plain", refuse)
    before = ops.kernel_launches()
    got = ops.delta_supports(tx[0], tx[1], sets)
    miss, _ = ops.subset_superset_counts(tx[0], sets)
    after = ops.kernel_launches()
    assert torch.equal(got, want) and miss.shape == (300, 77)
    assert after["block_itemset_supports"] == before["block_itemset_supports"] + 1
    assert after["subset_superset_counts"] == before["subset_superset_counts"] + 1


def test_sweep_wrappers_check_their_inputs(cuda):
    q = torch.zeros((6, 4), dtype=torch.int32, device=cuda)
    f = torch.zeros((3, 4), dtype=torch.int32, device=cuda)
    tx = torch.zeros((2, 6, 4), dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        sq.subset_superset_counts_cuda(q.to(torch.int64), f)
    with pytest.raises(ValueError):
        sq.subset_superset_counts_cuda(q, f[:, :3])
    with pytest.raises(ValueError):
        sq.subset_superset_counts_cuda(torch.zeros((4, 6), dtype=torch.int32, device=cuda).t(), f)
    with pytest.raises(ValueError):
        sq.subset_superset_counts_cuda(q, f.cpu())
    with pytest.raises(TypeError):
        ds.block_itemset_supports_cuda(tx, f.to(torch.int64))
    with pytest.raises(ValueError):
        ds.block_itemset_supports_cuda(tx[0], f)
    with pytest.raises(ValueError):
        ds.block_itemset_supports_cuda(tx[:, ::2], f)
    with pytest.raises(ValueError):
        ds.block_itemset_supports_cuda(tx.cpu(), f)



# B6 and B7: ragged I (B6 tiles of 8, B7 of 32) and W (B7 stages of 32 words),
# the profiled demo's I=100, W=15625, and the repl_min profit matrix's
# classes against the sample's 64 words
PAIR_SHAPES = [(i, w) for i in (1, 7, 8, 17, 33, 100, 131) for w in (1, 2, 33, 1025)] + [
    (100, 15625), (512, 64), (0, 8), (9, 0)]
# B7's edges: I around its tiles of 32 and their fragments, W around its
# stages and chunks
B7_RAGGED = [(i, w) for i in (1, 7, 8, 9, 100, 127, 128, 129, 131, 300)
             for w in (1, 7, 8, 9, 118, 119, 15625, 16384)]
PAIR_SHAPES += B7_RAGGED


def _valid(w, seed):
    """A valid-tid mask with every kind of word: whole, empty, and a ragged
    last word."""
    v = _words((w,), seed)
    if w:
        v[::3] = 0xFFFFFFFF
        v[1::5] = 0
        v[-1] = (1 << 13) - 1
    return v


@pytest.mark.parametrize("i,w", PAIR_SHAPES)
def test_pair_kernels_match_plain(cuda, i, w):
    items = bm.from_reference(_words((i, w), seed=i * 5 + w)).to(cuda)
    valid = bm.from_reference(_valid(w, seed=w + 9)).to(cuda)
    before = ops.kernel_launches()
    got = ops.pair_supports(items, valid, use_mxu=False)
    got_mxu = ops.pair_supports(items, valid)
    torch.cuda.synchronize()
    after = ops.kernel_launches()
    assert after["pair_supports"] == before["pair_supports"] + (i * w > 0)
    assert after["pair_supports_mxu"] == before["pair_supports_mxu"] + (i * w > 0)
    for out in (got, got_mxu):
        assert out.is_cuda and out.dtype == torch.int32 and out.shape == (i, i)
    assert torch.equal(got, ps.pair_supports_plain(items, valid))
    assert torch.equal(got_mxu, ps.pair_supports_mxu_plain(items, valid))
    assert torch.equal(got_mxu, got)


def test_pair_mxu_kernel_launch_facts(cuda):
    """B7's grid covers every tile pair of the upper triangle and every word,
    with no spilled registers."""
    for i, w in [(100, 15625), (1, 1)] + B7_RAGGED[::7]:
        facts = ps.mxu_launch_facts(torch.zeros((i, w), dtype=torch.int32, device=cuda),
                                    torch.zeros((w,), dtype=torch.int32, device=cuda))
        tiles = -(-i // 32)
        assert facts["grid_x"] == tiles * (tiles + 1) // 2 and facts["grid_z"] == 1
        assert facts["grid_y"] * facts["chunk_words"] >= w > (facts["grid_y"] - 1) * facts[
            "chunk_words"]
        assert facts["threads"] == 128 and facts["local_bytes"] == 0


def test_pair_wrappers_check_their_inputs(cuda):
    items = torch.zeros((6, 8), dtype=torch.int32, device=cuda)
    valid = torch.zeros((8,), dtype=torch.int32, device=cuda)
    for fn in (ps.pair_supports_cuda, ps.pair_supports_mxu_cuda):
        with pytest.raises(TypeError):
            fn(items.to(torch.int64), valid)
        with pytest.raises(TypeError):
            fn(items, valid.to(torch.uint8))
        with pytest.raises(ValueError):
            fn(items, valid[:4])
        with pytest.raises(ValueError):
            fn(items[0], valid)
        with pytest.raises(ValueError):  # [6, 8] with the strides of a transpose
            fn(torch.zeros_like(items).reshape(8, 6).t(), valid)
        with pytest.raises(ValueError):
            fn(items, valid.cpu())
        with pytest.raises(ValueError):
            fn(items.cpu(), valid.cpu())


@pytest.mark.parametrize("use_mxu", [False, True])
def test_pair_supports_on_the_card_never_reaches_a_plain_version(cuda, monkeypatch, use_mxu):
    items = bm.from_reference(_words((45, 70), seed=6)).to(cuda)
    valid = bm.from_reference(_valid(70, seed=7)).to(cuda)
    want = ps.pair_supports_plain(items, valid)

    def refuse(*args):
        raise AssertionError("a plain version ran on CUDA tensors")

    monkeypatch.setattr(ps, "pair_supports_plain", refuse)
    monkeypatch.setattr(ps, "pair_supports_mxu_plain", refuse)
    name = "pair_supports_mxu" if use_mxu else "pair_supports"
    before = ops.kernel_launches()
    got = ops.pair_supports(items, valid, use_mxu=use_mxu)
    after = ops.kernel_launches()
    assert torch.equal(got, want)
    assert {k: after[k] - before[k] for k in after} == {
        k: int(k == name) for k in after}


def test_repl_min_profit_matrix_runs_b6(cuda):
    """DB-Repl-Min's profit matrix on the card is B6, with the diagonal zeroed."""
    from repro_torch.core import schedule

    tids = bm.from_reference(_words((37, 64), seed=8)).to(cuda)
    before = ops.kernel_launches()["pair_supports"]
    got = schedule.pairwise_shared_transactions(tids)
    assert ops.kernel_launches()["pair_supports"] == before + 1
    want = schedule.pairwise_shared_transactions(tids.cpu())
    np.testing.assert_array_equal(got, want)
    assert not np.diag(got).any()


def test_profiler_times_a_card_dispatch(cuda):
    """With the profiler on, a dispatch on the card is timed with CUDA events
    and priced against the H100 model read from the device."""
    from repro_torch.obs import profile as obs_profile

    prof = obs_profile.KernelProfiler()
    items = bm.from_reference(_words((100, 4096), seed=10)).to(cuda)
    valid = bm.from_reference(_valid(4096, seed=11)).to(cuda)
    prof.enable()
    out = prof.call("pair", {"I": 100, "W": 4096},
                    lambda: ops.pair_supports(items, valid), items.device)
    rep = prof.report()
    assert torch.equal(out, ps.pair_supports_plain(items, valid))
    assert rep["machine"]["name"] == "h100-sxm"
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    assert rep["machine"]["word_ops_peak"] == sms * 1.98e9 * 64
    assert rep["families"]["pair"]["calls"] == 1
    assert rep["families"]["pair"]["measured_ms"] > 0

"""The port's support sweeps (kernels B1, B2 and B3) against the JAX package.

On the CPU the plain torch versions are held bit-equal to the Pallas kernels
run in interpret mode, the way ``tests/test_kernels.py`` runs them.  The CUDA
kernels themselves run only on the card, against these plain versions, in
``test_torch_kernels_cuda.py``.  Supports are integers, so every comparison
is exact.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitmap as ref_bm
from repro.kernels import bitmap_support as ref_bs
from repro.kernels import multi_support as ref_ms
from repro_torch.core import bitmap as bm
from repro_torch.kernels import bitmap_support as bs
from repro_torch.kernels import multi_support as ms
from repro_torch.kernels import ops

# ragged (K, I, W): sub-tile, one word, prime, multi-tile items and words
MULTI_SHAPES = [
    (1, 7, 2),
    (3, 16, 1),
    (8, 33, 9),
    (13, 40, 130),
    (5, 130, 33),
    (64, 24, 17),
]
SINGLE_SHAPES = [(7, 2), (16, 1), (33, 9), (130, 33), (53, 300)]
# (n_tx, n_items, K) of tests/test_kernels.py's matrix-unit sweep, run with
# its blocks (block_k=8, block_i=16, block_w=8)
MXU_DB_SHAPES = [(33, 7, 1), (128, 16, 3), (257, 64, 8), (300, 40, 13), (1024, 130, 5),
                 (512, 24, 64)]


def _words(shape, seed):
    """Random uint32 words, every bit equally likely (the sign bit included)."""
    return np.random.default_rng(seed).integers(0, 2**32, size=shape, dtype=np.uint32)


@pytest.mark.parametrize("k,i,w", MULTI_SHAPES)
def test_multi_plain_matches_pallas_interpret(k, i, w):
    items, tids = _words((i, w), seed=i * w), _words((k, w), seed=k + w)
    want = np.asarray(
        ref_ms.multi_extension_supports_pallas(
            jnp.asarray(items), jnp.asarray(tids), interpret=True
        )
    )
    got = ms.multi_extension_supports_plain(bm.from_reference(items), bm.from_reference(tids))
    assert got.dtype == torch.int32 and got.shape == (k, i)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("i,w", SINGLE_SHAPES)
def test_single_plain_matches_pallas_interpret(i, w):
    items, tid = _words((i, w), seed=i + 3 * w), _words((w,), seed=w)
    want = np.asarray(
        ref_bs.extension_supports_pallas(jnp.asarray(items), jnp.asarray(tid), interpret=True)
    )
    got = bs.extension_supports_plain(bm.from_reference(items), bm.from_reference(tid))
    assert got.dtype == torch.int32 and got.shape == (i,)
    np.testing.assert_array_equal(got.numpy(), want)


def _db_and_tids(n_tx, n_items, k, seed):
    """A random database's vertical bitmap and the tidlists of K random small
    itemsets (∅ included), as ``tests/test_kernels.py`` builds them."""
    rng = np.random.default_rng(seed)
    db = ref_bm.BitmapDB.from_dense(jnp.asarray(rng.random((n_tx, n_items)) < 0.3))
    tids = []
    for _ in range(k):
        mask = np.zeros(n_items, bool)
        mask[rng.choice(n_items, size=int(rng.integers(0, 3)), replace=False)] = True
        tids.append(np.asarray(ref_bm.tidlist_of_itemset(db, jnp.asarray(mask))))
    return np.asarray(db.item_bits), np.stack(tids)


@pytest.mark.parametrize("n_tx,n_items,k", MXU_DB_SHAPES)
def test_mxu_plain_matches_pallas_interpret_on_databases(n_tx, n_items, k):
    items, tids = _db_and_tids(n_tx, n_items, k, seed=n_tx + k)
    want = np.asarray(
        ref_ms.multi_extension_supports_mxu_pallas(
            jnp.asarray(items), jnp.asarray(tids), block_k=8, block_i=16, block_w=8,
            interpret=True,
        )
    )
    got = ms.multi_extension_supports_mxu_plain(bm.from_reference(items), bm.from_reference(tids))
    assert got.dtype == torch.int32 and got.shape == (k, n_items)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,i,w", MULTI_SHAPES)
def test_mxu_plain_matches_pallas_interpret_on_random_words(k, i, w):
    """Every bit equally likely, the sign bit included; the matrix-unit
    kernel with its default blocks."""
    items, tids = _words((i, w), seed=i * w + 7), _words((k, w), seed=k + w + 7)
    want = np.asarray(
        ref_ms.multi_extension_supports_mxu_pallas(
            jnp.asarray(items), jnp.asarray(tids), interpret=True
        )
    )
    got = ms.multi_extension_supports_mxu_plain(bm.from_reference(items), bm.from_reference(tids))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(),
        ms.multi_extension_supports_plain(bm.from_reference(items),
                                          bm.from_reference(tids)).numpy(),
    )


@pytest.mark.parametrize("k,i,w", [(0, 10, 8), (4, 0, 8), (4, 10, 0)])
def test_mxu_plain_on_empty_axes(k, i, w):
    items, tids = bm.from_reference(_words((i, w), 3)), bm.from_reference(_words((k, w), 4))
    got = ms.multi_extension_supports_mxu_plain(items, tids)
    assert got.dtype == torch.int32 and got.shape == (k, i)
    assert torch.equal(got, ms.multi_extension_supports_plain(items, tids))


def test_ops_routes_cpu_tensors_to_plain_versions():
    items, tids = bm.from_reference(_words((9, 5), 1)), bm.from_reference(_words((4, 5), 2))
    before = ops.kernel_launches()
    np.testing.assert_array_equal(
        ops.multi_extension_supports(items, tids).numpy(),
        ms.multi_extension_supports_plain(items, tids).numpy(),
    )
    np.testing.assert_array_equal(
        ops.extension_supports(items, tids[0]).numpy(),
        bs.extension_supports_plain(items, tids[0]).numpy(),
    )
    assert ops.kernel_launches() == before


def test_ops_routes_use_mxu_on_cpu_tensors_to_the_matrix_product(monkeypatch):
    items, tids = bm.from_reference(_words((9, 5), 1)), bm.from_reference(_words((4, 5), 2))
    calls = []
    mxu_plain = ms.multi_extension_supports_mxu_plain

    def plain(a, b):
        calls.append((a, b))
        return mxu_plain(a, b)

    monkeypatch.setattr(ms, "multi_extension_supports_mxu_plain", plain)
    before = ops.kernel_launches()
    got = ops.multi_extension_supports(items, tids, use_mxu=True)
    assert len(calls) == 1 and calls[0][0] is items and calls[0][1] is tids
    np.testing.assert_array_equal(
        got.numpy(), ms.multi_extension_supports_plain(items, tids).numpy()
    )
    assert ops.kernel_launches() == before


def test_dispatch_has_no_override():
    """Only the tensors' device picks between a kernel and its plain version:
    no ``force`` or mode argument.  ``use_mxu`` chooses between two kernels."""
    for fn in (ops.multi_extension_supports, ops.extension_supports):
        assert list(inspect.signature(fn).parameters) in (
            ["item_bits", "prefix_tids", "use_mxu"], ["item_bits", "prefix_tid"]
        )
    with pytest.raises(ValueError):
        ops.extension_supports(torch.zeros((2, 3), dtype=torch.int32, device="meta"),
                               torch.zeros((3,), dtype=torch.int32, device="meta"))


def test_cuda_wrappers_refuse_cpu_tensors():
    """A wrapper launches its kernel or raises; it never computes on the CPU."""
    items, tids = bm.from_reference(_words((9, 5), 1)), bm.from_reference(_words((4, 5), 2))
    with pytest.raises(ValueError):
        ms.multi_extension_supports_cuda(items, tids)
    with pytest.raises(ValueError):
        ms.multi_extension_supports_mxu_cuda(items, tids)
    with pytest.raises(ValueError):
        bs.extension_supports_cuda(items, tids[0])



def test_launch_facts_refuse_cpu_tensors():
    """B2's and B7's launch facts describe a launch on the card: CPU tensors
    are refused before the library is asked."""
    from repro_torch.kernels import pair_support as ps

    items, tids = bm.from_reference(_words((9, 5), 3)), bm.from_reference(_words((4, 5), 4))
    with pytest.raises(ValueError):
        ms.mxu_launch_facts(items, tids)
    with pytest.raises(ValueError):
        ps.mxu_launch_facts(items, tids[0])


def test_every_c_entry_point_has_a_signature():
    """``build.SIGNATURES`` names exactly the C entry points of the sources
    (each ``int name(`` inside their ``extern "C"`` blocks), so that every
    one gets its ctypes argument types."""
    import re

    from repro_torch.kernels import build

    names = set()
    for src in build.SOURCES:
        text = src.read_text()
        names |= set(re.findall(r"^int (\w+)\(", text[text.index('extern "C" {'):], re.M))
    assert names == set(build.SIGNATURES)


def test_mxu_designs_apply_to_the_sources(tmp_path):
    """Every redesign of B2 and B7 that ``probes/mxu_designs.py`` times still
    lays over the port's current sources: each diff's hunks match once, and
    each design changes B2's or B7's source."""
    import importlib.util
    from pathlib import Path

    from repro_torch.kernels import build

    path = Path(__file__).resolve().parents[1] / "probes" / "mxu_designs.py"
    spec = importlib.util.spec_from_file_location("mxu_designs", path)
    designs = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(designs)
    for name in designs.NAMES:
        csrc = designs.sources_of(name, build.CSRC, tmp_path)
        changed = [src for src in designs.SOURCES
                   if (csrc / src).read_text() != (build.CSRC / src).read_text()]
        assert changed, name

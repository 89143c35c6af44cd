"""Kernel B5's plain version (the block containment sweep) against the JAX
package.

On the CPU the plain torch version is held bit-equal to the Pallas kernel run
in interpret mode (with its sentinel word) and to the reference's jnp oracle
(``ops`` with ``force="ref"``), ∅, T=1 and ragged T and F included.  The CUDA
kernel runs only on the card, against this plain version, in
``test_torch_kernels_cuda.py``.  Counts are integers, so every comparison is
exact.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import delta_support as ref_ds
from repro.kernels import ops as ref_ops
from repro_torch.core import bitmap as bm
from repro_torch.kernels import delta_support as ds
from repro_torch.kernels import ops

# ragged (S, T, F, IW): T=1, sub-tile, past the reference's 128-row tiles,
# IW past its word padding of 8, and the delta's S=2
SHAPES = [(1, 1, 1, 1), (2, 7, 129, 4), (2, 129, 7, 9), (3, 130, 200, 4), (1, 1, 40, 4),
          (2, 300, 33, 1), (1, 64, 5, 40)]


def _blocks_and_sets(s, t, f, iw, seed):
    """Dense-ish random rows, and itemsets drawn as sparse subsets of rows
    (so containment is common), random words (rarely contained) and ∅."""
    rng = np.random.default_rng(seed)
    tx = rng.integers(0, 2**32, size=(s, t, iw), dtype=np.uint32)
    tx |= rng.integers(0, 2**32, size=(s, t, iw), dtype=np.uint32)   # 3/4 of bits set
    sets = rng.integers(0, 2**32, size=(f, iw), dtype=np.uint32)
    for r in range(f):
        if r % 3:
            sparse = (rng.integers(0, 2**32, size=iw, dtype=np.uint32)
                      & rng.integers(0, 2**32, size=iw, dtype=np.uint32)
                      & rng.integers(0, 2**32, size=iw, dtype=np.uint32))
            sets[r] = tx[rng.integers(s), rng.integers(t)] & sparse
    sets[0] = 0                                                        # ∅
    return tx, sets


@pytest.mark.parametrize("s,t,f,iw", SHAPES)
def test_plain_matches_pallas_interpret_and_ref(s, t, f, iw):
    tx, sets = _blocks_and_sets(s, t, f, iw, seed=s + 7 * t + f + iw)
    want = np.asarray(ref_ds.block_itemset_supports_pallas(
        jnp.asarray(tx), jnp.asarray(sets), interpret=True))
    ref = np.asarray(ref_ops.block_itemset_supports(jnp.asarray(tx), jnp.asarray(sets),
                                                    force="ref"))
    got = ds.block_itemset_supports_plain(bm.from_reference(tx), bm.from_reference(sets))
    assert got.dtype == torch.int32 and got.shape == (s, f)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(got.numpy()[:, 0], t)     # ∅ is in every real row
    assert (got.numpy()[:, 1:] > 0).any() or f == 1 or t == 1


def test_plain_chunks_rows_like_one_pass(monkeypatch):
    """The plain version's row chunks add up to the one-pass count."""
    tx, sets = _blocks_and_sets(2, 257, 9, 2, seed=11)
    whole = ds.block_itemset_supports_plain(bm.from_reference(tx), bm.from_reference(sets))
    monkeypatch.setattr(ds, "_PLAIN_CHUNK", 9 * 10)   # 10 rows a chunk
    chunked = ds.block_itemset_supports_plain(bm.from_reference(tx), bm.from_reference(sets))
    assert torch.equal(whole, chunked)


def test_delta_supports_stacks_arrive_then_expire():
    tx, sets = _blocks_and_sets(2, 50, 30, 4, seed=3)
    arrive, expire = bm.from_reference(tx[0]), bm.from_reference(tx[1])
    got = ops.delta_supports(arrive, expire, bm.from_reference(sets))
    want = np.asarray(ref_ops.delta_supports(jnp.asarray(tx[0]), jnp.asarray(tx[1]),
                                             jnp.asarray(sets), force="ref"))
    np.testing.assert_array_equal(got.numpy(), want)
    # the window update adds arrivals and subtracts expiries
    one = ds.block_itemset_supports_plain(bm.from_reference(tx[:1]), bm.from_reference(sets))
    np.testing.assert_array_equal(got[0].numpy(), one[0].numpy())
    assert (got[0] != got[1]).any()


@pytest.mark.parametrize("s,t,f", [(0, 4, 3), (2, 0, 3), (2, 4, 0)])
def test_plain_on_empty_axes(s, t, f):
    got = ds.block_itemset_supports_plain(torch.zeros((s, t, 2), dtype=torch.int32),
                                          torch.zeros((f, 2), dtype=torch.int32))
    assert got.shape == (s, f)
    assert (got == t).all()


def test_ops_routes_cpu_tensors_to_the_plain_version():
    tx, sets = _blocks_and_sets(2, 20, 9, 4, seed=8)
    tx, sets = bm.from_reference(tx), bm.from_reference(sets)
    before = ops.kernel_launches()
    assert torch.equal(ops.block_itemset_supports(tx, sets),
                       ds.block_itemset_supports_plain(tx, sets))
    assert ops.kernel_launches() == before


def test_dispatch_has_no_override():
    assert list(inspect.signature(ops.block_itemset_supports).parameters) == [
        "tx_blocks", "fi_masks"]
    assert list(inspect.signature(ops.delta_supports).parameters) == [
        "arrive", "expire", "fi_masks"]
    with pytest.raises(ValueError):
        ops.block_itemset_supports(torch.zeros((1, 2, 3), dtype=torch.int32, device="meta"),
                                   torch.zeros((4, 3), dtype=torch.int32, device="meta"))


def test_cuda_wrapper_refuses_cpu_tensors():
    """The wrapper launches its kernel or raises; it never computes on the CPU."""
    tx, sets = _blocks_and_sets(1, 5, 3, 2, seed=1)
    with pytest.raises(ValueError):
        ds.block_itemset_supports_cuda(bm.from_reference(tx), bm.from_reference(sets))

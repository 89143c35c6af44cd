"""Kernel B4's plain version (the subset/superset query sweep) against the JAX
package.

On the CPU the plain torch version is held bit-equal to the Pallas kernel run
in interpret mode and to the reference's jnp oracle (``ops`` with
``force="ref"``).  The CUDA kernel runs only on the card, against this plain
version, in ``test_torch_kernels_cuda.py``.  Counts are integers, so every
comparison is exact.
"""
import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as ref_ops
from repro.kernels import subset_query as ref_sq
from repro_torch.core import bitmap as bm
from repro_torch.kernels import ops
from repro_torch.kernels import subset_query as sq

# ragged (Q, F, IW): one of each, sub-tile, IW=9 crossing the reference's
# block_w=8, Q and F past its 128-row tiles, and 40 words (1280 items)
SHAPES = [(1, 1, 1), (7, 129, 4), (129, 7, 9), (130, 200, 9), (1, 300, 4), (33, 20, 40),
          (200, 1, 4)]


def _words(shape, seed):
    """Random uint32 words, every bit equally likely (the sign bit included)."""
    return np.random.default_rng(seed).integers(0, 2**32, size=shape, dtype=np.uint32)


def _queries_and_sets(q, f, iw, seed):
    """Random queries, and itemsets of which some are subsets, supersets or
    copies of a query (so every count, zero included, occurs), plus ∅."""
    rng = np.random.default_rng(seed)
    queries = _words((q, iw), seed)
    sets = _words((f, iw), seed + 1)
    for r in range(f):
        src = queries[rng.integers(q)]
        kind = r % 4
        if kind == 0:
            sets[r] = src & _words((iw,), seed + 2 + r)          # a subset
        elif kind == 1:
            sets[r] = src | (_words((iw,), seed + 2 + r) & _words((iw,), seed + 3 + r))
        elif kind == 2:
            sets[r] = src
    sets[0] = 0
    return queries, sets


@pytest.mark.parametrize("q,f,iw", SHAPES)
def test_plain_matches_pallas_interpret_and_ref(q, f, iw):
    queries, sets = _queries_and_sets(q, f, iw, seed=q * 31 + f + iw)
    want_miss, want_extra = ref_sq.subset_superset_counts_pallas(
        jnp.asarray(queries), jnp.asarray(sets), interpret=True
    )
    ref_miss, ref_extra = ref_ops.subset_superset_counts(
        jnp.asarray(queries), jnp.asarray(sets), force="ref"
    )
    miss, extra = sq.subset_superset_counts_plain(bm.from_reference(queries),
                                                  bm.from_reference(sets))
    assert miss.dtype == extra.dtype == torch.int32
    assert miss.shape == extra.shape == (q, f)
    np.testing.assert_array_equal(miss.numpy(), np.asarray(want_miss))
    np.testing.assert_array_equal(extra.numpy(), np.asarray(want_extra))
    np.testing.assert_array_equal(miss.numpy(), np.asarray(ref_miss))
    np.testing.assert_array_equal(extra.numpy(), np.asarray(ref_extra))


def test_membership_semantics():
    """miss == 0 ⇔ f ⊆ q, extra == 0 ⇔ q ⊆ f, both ⇔ f = q."""
    q = bm.from_reference(np.array([[0b1011], [0b0000]], np.uint32))
    f = bm.from_reference(np.array([[0b0011], [0b1011], [0b1111], [0b0000]], np.uint32))
    miss, extra = sq.subset_superset_counts_plain(q, f)
    np.testing.assert_array_equal(miss.numpy(), [[0, 0, 1, 0], [2, 3, 4, 0]])
    np.testing.assert_array_equal(extra.numpy(), [[1, 0, 0, 3], [0, 0, 0, 0]])


@pytest.mark.parametrize("q,f", [(0, 5), (5, 0)])
def test_plain_on_empty_axes(q, f):
    miss, extra = sq.subset_superset_counts_plain(
        bm.from_reference(_words((q, 4), 1)), bm.from_reference(_words((f, 4), 2)))
    assert miss.shape == extra.shape == (q, f)


def test_ops_routes_cpu_tensors_to_the_plain_version():
    queries, sets = (bm.from_reference(a) for a in _queries_and_sets(9, 17, 4, seed=5))
    before = ops.kernel_launches()
    miss, extra = ops.subset_superset_counts(queries, sets)
    want = sq.subset_superset_counts_plain(queries, sets)
    assert torch.equal(miss, want[0]) and torch.equal(extra, want[1])
    assert ops.kernel_launches() == before


def test_dispatch_has_no_override():
    assert list(inspect.signature(ops.subset_superset_counts).parameters) == [
        "query_masks", "fi_masks"]
    with pytest.raises(ValueError):
        ops.subset_superset_counts(torch.zeros((2, 3), dtype=torch.int32, device="meta"),
                                   torch.zeros((4, 3), dtype=torch.int32, device="meta"))


def test_cuda_wrapper_refuses_cpu_tensors():
    """The wrapper launches its kernel or raises; it never computes on the CPU."""
    queries, sets = (bm.from_reference(a) for a in _queries_and_sets(3, 5, 2, seed=1))
    with pytest.raises(ValueError):
        sq.subset_superset_counts_cuda(queries, sets)

"""The port's support sweeps (kernels B1 and B3) against the JAX package.

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


def test_ops_routes_cpu_tensors_to_plain_versions():
    items, tids = bm.from_reference(_words((9, 5), 1)), bm.from_reference(_words((4, 5), 2))
    before = (ms.multi_extension_supports_cuda.launches, bs.extension_supports_cuda.launches)
    np.testing.assert_array_equal(
        ops.multi_extension_supports(items, tids).numpy(),
        ms.multi_extension_supports_plain(items, tids).numpy(),
    )
    np.testing.assert_array_equal(
        ops.extension_supports(items, tids[0]).numpy(),
        bs.extension_supports_plain(items, tids[0]).numpy(),
    )
    after = (ms.multi_extension_supports_cuda.launches, bs.extension_supports_cuda.launches)
    assert after == before


def test_dispatch_has_no_override():
    """Only the tensors' device picks the path: no ``force`` or mode argument."""
    for fn in (ops.multi_extension_supports, ops.extension_supports):
        assert list(inspect.signature(fn).parameters) in (
            ["item_bits", "prefix_tids"], ["item_bits", "prefix_tid"]
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
        bs.extension_supports_cuda(items, tids[0])


"""The CUDA kernels B1, B2 and B3 against their plain torch versions, on the card.

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
from repro_torch.kernels import multi_support as ms
from repro_torch.kernels import ops

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

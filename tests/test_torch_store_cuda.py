"""The store's block reader on the card: pinned staging buffers, the copy on a
side stream, the consumer's wait on its event, and the host budget.

Every case carries the ``cuda`` marker and skips where CUDA is not available.
The file imports neither JAX nor the JAX package, so it runs on a machine
with a card and PyTorch alone:

  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_store_cuda.py

The CPU path of the same reader is held to the JAX package's in
``test_torch_store.py``.  Every comparison is exact.
"""
import time

import numpy as np
import pytest
import torch

from repro_torch.core import eclat, fimi
from repro_torch.kernels import delta_support as ds
from repro_torch.store import (
    BlockReader,
    StoreWriter,
    TxStore,
    pack_bool_np,
    streamed_itemset_supports,
    to_device_rows,
    to_device_shards,
)

pytestmark = pytest.mark.cuda

# ragged, with an empty block mid-stream; 100 items = 4 words a row
SIZES = [4096, 4096, 0, 4096, 4096, 4096, 1234]
N_ITEMS = 100


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    dense = np.random.default_rng(0).random((sum(SIZES), N_ITEMS)) < 0.3
    w = StoreWriter(str(tmp_path_factory.mktemp("cuda_store") / "st"), n_items=N_ITEMS,
                    block_tx=max(SIZES))
    off = 0
    for n in SIZES:
        w.append_dense(dense[off:off + n])
        off += n
    return w.close()


def _rows(store):
    return torch.from_numpy(store.read_all_packed().view(np.int32))


@pytest.mark.parametrize("delay_s", [0.0, 0.02])
def test_blocks_equal_the_store_rows(cuda, store, delay_s):
    """Each block is read on the consumer's stream the moment it is yielded
    (no host sync), the consumer then held back or not: every row arrives."""
    r = BlockReader(store, device=cuda)
    snaps, offs = [], []
    for i, off, dev, n in r.device_blocks():
        assert dev.is_cuda and dev.shape == (n, store.n_words)
        snaps.append(dev.clone())           # queued behind the wait on the copy
        offs.append(off)
        if delay_s:
            time.sleep(delay_s)
    torch.cuda.synchronize()
    assert offs == list(np.cumsum([0] + SIZES[:-1]))
    assert torch.equal(torch.cat(snaps).cpu(), _rows(store))
    assert 0 < r.peak_host_bytes <= r.budget_bytes == 2 * store.max_block_bytes
    assert all(s.tensor.is_pinned() for s in r._slots)
    assert r.staging_bytes <= r.budget_bytes


@pytest.mark.parametrize("delay_s", [0.0, 0.02])
def test_no_staging_buffer_refilled_before_its_copy_completed(cuda, store, delay_s):
    r = BlockReader(store, device=cuda)
    for _ in r.device_blocks():
        if delay_s:
            time.sleep(delay_s)
    assert [b for b, *_ in r.refills] == list(range(len(SIZES)))
    assert [k for _, k, _, _ in r.refills] == [i % 2 for i in range(len(SIZES))]
    # a buffer still holding a block at its refill held the one two before,
    # whose copy had completed on the card (None: the consumer had already
    # seen that copy complete and freed the buffer)
    assert all(p is None or p == b - 2 for b, _, p, _ in r.refills)
    assert r.refills[0][2] is None and r.refills[1][2] is None
    assert all(done for *_, done in r.refills)
    assert not r._live                      # every block released


@pytest.mark.parametrize("P", [1, 3, 4])
def test_to_device_shards_on_the_card(cuda, store, P):
    r = BlockReader(store, device=cuda)
    got = to_device_shards(store, P, reader=r)
    assert got.is_cuda and got.dtype == torch.int32
    T = store.n_tx // P
    assert torch.equal(got.cpu(), _rows(store)[: T * P].view(P, T, store.n_words))
    assert 0 < r.peak_host_bytes <= r.budget_bytes


def test_to_device_rows_behind_pending_work(cuda, store):
    """The shards' buffer is written on the side stream only after the work
    queued on the consumer's stream before it."""
    busy = torch.zeros((4096, 4096), device=cuda)
    for _ in range(4):
        busy = busy @ busy                  # keep the consumer's stream busy
    got = to_device_rows(store, device=cuda)
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), _rows(store))


def test_streamed_itemset_supports_on_b5(cuda, store):
    masks_dense = np.random.default_rng(1).random((300, N_ITEMS)) < 0.03
    masks_dense[0] = False                  # the empty itemset: every row
    masks = torch.from_numpy(pack_bool_np(masks_dense).view(np.int32))
    before = ds.block_itemset_supports_cuda.launches
    got = streamed_itemset_supports(store, masks.to(cuda))
    launched = ds.block_itemset_supports_cuda.launches - before
    assert launched == sum(1 for n in SIZES if n)   # one launch a non-empty block
    want = ds.block_itemset_supports_plain(_rows(store)[None], masks)[0]
    assert got.is_cuda and got.dtype == torch.int64
    assert torch.equal(got.cpu(), want.long())
    assert got[0] == store.n_tx


def test_fimi_run_store_on_the_card(cuda, store):
    params = fimi.FimiParams(min_support_rel=0.3, n_db_sample=1024, n_fi_sample=256,
                             eclat=eclat.EclatConfig(max_out=1 << 14, max_stack=2048,
                                                     frontier_size=8))
    small = TxStore.open(store.directory)
    r = BlockReader(small, device=cuda)
    got = fimi.run(small, None, params, device=cuda, materialize=True, P=4, reader=r)
    want = fimi.run(small, None, params, device="cpu", materialize=True, P=4)
    assert got.fi_dict == want.fi_dict and len(got.fi_dict) > 0
    assert got.launches["extension_supports"] > 0
    assert got.launches["multi_extension_supports"] > 0
    assert 0 < r.peak_host_bytes <= r.budget_bytes

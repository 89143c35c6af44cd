"""Fault tolerance of the port's store, on the CPU: port twins of
``tests/test_faults.py``'s CRC32C, retry, reader and fsck tests, driven
through the file-level injectors of ``tests/faults.py`` (the on-disk format
is the JAX package's, so they damage either package's stores alike).  Every
damage class reaches the port as the same typed error the reference raises
for the same file, and the port's ``fsck`` finds and handles what the
reference's does.
"""
import contextlib
import json
import os
import threading

import numpy as np
import pytest

from faults import corrupt_block, orphan_block
from repro import store as ref_store
from repro_torch.core import eclat, fimi
from repro_torch.store import (
    BlockReader,
    ChecksumMismatchError,
    MissingBlockError,
    NO_RETRY,
    RetriesExhausted,
    RetryPolicy,
    StaleManifestError,
    StoreIntegrityError,
    StoreWriter,
    TruncatedBlockError,
    TxStore,
    crc32c,
    fsck,
    pack_bool_np,
)
from repro_torch.store.checksum import crc32c_ref
from repro_torch.store.reader import BlockReadError

CPU = "cpu"


def _random_dense(n_tx, n_items, seed, density=0.3):
    return np.random.default_rng(seed).random((n_tx, n_items)) < density


def _store_from_dense(tmp_path, dense, sizes, name="st"):
    w = StoreWriter(str(tmp_path / name), n_items=dense.shape[1], block_tx=max(sizes))
    off = 0
    for sz in sizes:
        w.append_dense(dense[off:off + sz])
        off += sz
    return w.close()


def _fimi_params():
    return fimi.FimiParams(min_support_rel=0.1, n_db_sample=128, n_fi_sample=256,
                           eclat=eclat.EclatConfig(max_out=1 << 14, max_stack=2048,
                                                   frontier_size=8))


@contextlib.contextmanager
def fail_nth_read(n, exc=OSError, *, fail_count=10 ** 9):
    """``tests/faults.fail_nth_read`` for the port's ``TxStore.read_block``:
    its Nth call (1-based) and the ``fail_count − 1`` after it raise."""
    calls = {"n": 0}
    real = TxStore.read_block

    def patched(self, i, out=None):
        calls["n"] += 1
        if n <= calls["n"] < n + fail_count:
            raise exc(f"injected failure on read #{calls['n']} (block {i})")
        return real(self, i, out=out)

    TxStore.read_block = patched
    try:
        yield lambda: calls["n"]
    finally:
        TxStore.read_block = real


# ---------------------------------------------------------------------------
# CRC32C — computed on views of the message, equal to the reference's
# ---------------------------------------------------------------------------


def test_crc32c_check_value():
    data = np.frombuffer(b"123456789", np.uint8)
    assert crc32c(data) == crc32c_ref(data) == 0xE3069283
    assert crc32c(b"123456789") == 0xE3069283


@pytest.mark.parametrize("n", [0, 1, 3, 7, 63, 64, 65, 127, 128, 129, 255, 1024, 4097,
                               65536 + 17, 1 << 20, 659968])
def test_crc32c_matches_reference(n):
    data = np.random.default_rng(n).integers(0, 256, size=n, dtype=np.uint8)
    assert crc32c(data) == ref_store.crc32c(data)
    if n <= 4097:
        assert crc32c(data) == crc32c_ref(data)


def test_crc32c_uint32_payload_and_sensitivity():
    arr = np.random.default_rng(0).integers(0, 1 << 32, size=(16, 3), dtype=np.uint32)
    c0 = crc32c(arr)
    assert c0 == crc32c_ref(arr.view(np.uint8).reshape(-1)) == ref_store.crc32c(arr)
    arr[7, 1] ^= np.uint32(1 << 13)  # single bit flip must change the CRC
    assert crc32c(arr) != c0


# ---------------------------------------------------------------------------
# Retry policy — deterministic schedule, injectable clock
# ---------------------------------------------------------------------------


def test_retry_survives_transient_fault_with_exact_schedule():
    slept = []
    pol = RetryPolicy(attempts=4, base_delay_s=0.01, backoff=3.0, max_delay_s=0.05,
                      sleep=slept.append, clock=lambda: 0.0)
    calls = {"n": 0}

    def flaky():
        calls["n"] += 1
        if calls["n"] < 3:
            raise OSError("transient")
        return "ok"

    assert pol.call(flaky, describe="read") == "ok"
    assert calls["n"] == 3
    assert slept == [0.01, 0.03]          # base·backoff^k, no sleep on success


def test_retry_delay_is_capped():
    pol = RetryPolicy(base_delay_s=0.01, backoff=10.0, max_delay_s=0.25)
    assert [pol.delay(k) for k in range(4)] == [0.01, 0.1, 0.25, 0.25]


def test_retry_exhaustion_wraps_last_error():
    from repro_torch.obs import metrics as obs_metrics

    reg = obs_metrics.registry()
    exhausted0 = reg.counter("store/retry/exhausted").value
    slept = []
    pol = RetryPolicy(attempts=3, base_delay_s=0.01, sleep=slept.append, clock=lambda: 0.0)
    with pytest.raises(RetriesExhausted, match="pull block 7.*3 attempts") as ei:
        pol.call(lambda: (_ for _ in ()).throw(OSError("gone")), describe="pull block 7")
    assert isinstance(ei.value.__cause__, OSError)
    assert len(slept) == 2                # attempts−1 sleeps, then give up
    assert reg.counter("store/retry/exhausted").value == exhausted0 + 1


def test_retry_never_retries_integrity_errors():
    slept = []
    pol = RetryPolicy(attempts=5, sleep=slept.append)

    def bad():
        raise ChecksumMismatchError("persistent fact about disk bytes")

    with pytest.raises(ChecksumMismatchError):
        pol.call(bad)
    assert slept == []                    # first throw propagates untouched


def test_retry_does_not_retry_device_errors():
    """A CUDA error is a ``RuntimeError``, not an ``OSError``: not retried."""
    slept, calls = [], {"n": 0}

    def copy():
        calls["n"] += 1
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    with pytest.raises(RuntimeError, match="CUDA error"):
        RetryPolicy(attempts=3, sleep=slept.append).call(copy)
    assert calls["n"] == 1 and slept == []


# ---------------------------------------------------------------------------
# BlockReader — worker-thread failures surface at the consumer, typed
# ---------------------------------------------------------------------------


def test_reader_survives_transient_read_fault(tmp_path):
    s = _store_from_dense(tmp_path, _random_dense(96, 16, seed=1), [32, 32, 32])
    slept = []
    rd = BlockReader(s, device=CPU, retry=RetryPolicy(attempts=3, base_delay_s=0.001,
                                                      sleep=slept.append))
    with fail_nth_read(2, OSError, fail_count=2):
        n_rows = sum(n for _, _, _, n in rd.device_blocks())
    assert n_rows == 96                   # stream completed despite the fault
    assert len(slept) == 2                # block 1 needed both retries
    assert rd.read_attempts == 5          # 3 clean reads + 2 failed attempts


def test_reader_persistent_fault_raises_with_block_context(tmp_path):
    s = _store_from_dense(tmp_path, _random_dense(96, 16, seed=2), [32, 32, 32])
    before = threading.active_count()
    rd = BlockReader(s, device=CPU, retry=RetryPolicy(attempts=2, base_delay_s=0.0,
                                                      sleep=lambda _: None))
    with fail_nth_read(2, OSError):
        with pytest.raises(RetriesExhausted, match=r"read block 1 .*block_0"):
            for _ in rd.device_blocks():
                pass
    assert threading.active_count() == before   # worker joined, not leaked


def test_reader_wraps_unexpected_worker_errors(tmp_path):
    s = _store_from_dense(tmp_path, _random_dense(64, 16, seed=3), [32, 32])
    rd = BlockReader(s, device=CPU, retry=NO_RETRY)
    with fail_nth_read(2, RuntimeError):     # not retryable, not typed
        with pytest.raises(BlockReadError, match=r"block 1 .*block_000001"):
            for _ in rd.device_blocks():
                pass


def test_reader_passes_integrity_errors_through_typed(tmp_path):
    s = _store_from_dense(tmp_path, _random_dense(64, 16, seed=4), [32, 32])
    corrupt_block(s.directory, 1, "bitflip")
    with pytest.raises(ChecksumMismatchError, match="block_000001"):
        for _ in BlockReader(TxStore.open(s.directory), device=CPU).device_blocks():
            pass


def test_reader_copy_error_propagates_unwrapped(tmp_path, monkeypatch):
    """An error in the copy to the device is raised as it is, never retried
    and never answered by another path."""
    s = _store_from_dense(tmp_path, _random_dense(64, 16, seed=5), [32, 32])
    rd = BlockReader(s, device=CPU)

    def broken(*args, **kwargs):
        raise RuntimeError("CUDA error: misaligned address")

    monkeypatch.setattr(BlockReader, "_copy", broken)
    with pytest.raises(RuntimeError, match="misaligned address"):
        list(rd.device_blocks())


# ---------------------------------------------------------------------------
# Corruption reaches the miner as a distinct, actionable error
# ---------------------------------------------------------------------------


MODES = [("bitflip", ChecksumMismatchError), ("truncate", TruncatedBlockError),
         ("delete", MissingBlockError), ("stale", StaleManifestError)]


@pytest.mark.parametrize("mode,exc", MODES)
def test_corruption_fails_mining_with_typed_error(tmp_path, mode, exc):
    s = _store_from_dense(tmp_path, _random_dense(128, 16, seed=5), [32, 32, 32, 32])
    corrupt_block(s.directory, 2, mode)
    s2 = TxStore.open(s.directory)        # manifest still loads fine
    with pytest.raises(exc, match="block_000002") as ei:
        fimi.run(s2, None, _fimi_params(), device=CPU, materialize=True, P=2)
    assert isinstance(ei.value, StoreIntegrityError)   # one catchable base


@pytest.mark.parametrize("mode", ["bitflip", "truncate", "delete", "stale", "garbage",
                                  "header"])
def test_read_block_raises_what_the_reference_raises(tmp_path, mode):
    """For each damaged file both packages raise the same error class."""
    s = _store_from_dense(tmp_path, _random_dense(64, 40, seed=6), [32, 32])
    path = os.path.join(s.directory, s.manifest.blocks[1].file)
    if mode == "garbage":                 # not an .npy at all
        with open(path, "wb") as f:
            f.write(b"not a numpy file" * 8)
    elif mode == "header":                # cut inside the header
        with open(path, "r+b") as f:
            f.truncate(20)
    else:
        corrupt_block(s.directory, 1, mode)
    errors = []
    for handle in (TxStore.open(s.directory), ref_store.TxStore.open(s.directory)):
        with pytest.raises(StoreIntegrityError if handle.__class__ is TxStore
                           else ref_store.StoreIntegrityError) as ei:
            handle.read_block(1)
        errors.append(type(ei.value).__name__)
    assert errors[0] == errors[1]
    np.testing.assert_array_equal(TxStore.open(s.directory).read_block(0),
                                  ref_store.TxStore.open(s.directory).read_block(0))


def test_verify_off_skips_checksum_only(tmp_path):
    s = _store_from_dense(tmp_path, _random_dense(64, 16, seed=6), [32, 32])
    corrupt_block(s.directory, 0, "bitflip")
    TxStore.open(s.directory, verify=False).read_block(0)   # geometry intact: readable
    with pytest.raises(ChecksumMismatchError):
        TxStore.open(s.directory).read_block(0)


# ---------------------------------------------------------------------------
# fsck — classification, repair, quarantine; the CLI exit contract
# ---------------------------------------------------------------------------


def test_fsck_classifies_every_damage_kind(tmp_path):
    s = _store_from_dense(tmp_path, _random_dense(160, 16, seed=7), [32] * 5)
    corrupt_block(s.directory, 0, "bitflip")
    corrupt_block(s.directory, 1, "truncate")
    corrupt_block(s.directory, 2, "delete")
    corrupt_block(s.directory, 3, "stale")
    orphan_block(s.directory, n_rows=4)
    rep = fsck(s.directory)               # read-only scan
    assert sorted(d.kind for d in rep.damages) == ["bit-flip", "missing", "orphan",
                                                   "stale-manifest", "truncated"]
    assert not rep.clean and all(d.action == "none" for d in rep.damages)
    ref = ref_store.fsck(s.directory)
    assert [(d.kind, d.path, d.block_index, d.action) for d in rep.damages] == \
        [(d.kind, d.path, d.block_index, d.action) for d in ref.damages]


def test_fsck_quarantine_salvages_survivors(tmp_path):
    dense = _random_dense(128, 16, seed=8)
    s = _store_from_dense(tmp_path, dense, [32, 32, 32, 32])
    corrupt_block(s.directory, 1, "bitflip")
    corrupt_block(s.directory, 3, "delete")
    rep = fsck(s.directory, quarantine=True)
    assert rep.clean and rep.n_blocks == 2 and rep.n_tx == 64
    assert os.listdir(os.path.join(s.directory, "quarantine")) == ["block_000001.npy"]
    st = TxStore.open(s.directory)
    want = np.concatenate([pack_bool_np(dense[0:32]), pack_bool_np(dense[64:96])])
    assert np.array_equal(st.read_all_packed(), want)   # exactly the undamaged payloads
    assert fsck(s.directory).damages == []


def test_fsck_cli_exit_codes(tmp_path, capsys, monkeypatch):
    from repro_torch.launch import fsck as cli

    s = _store_from_dense(tmp_path, _random_dense(64, 16, seed=9), [32, 32])

    def run(*argv):
        monkeypatch.setattr("sys.argv", ["fsck", *argv])
        with pytest.raises(SystemExit) as ei:
            cli.main()
        return ei.value.code or 0, capsys.readouterr().out

    code, out = run(s.directory)
    assert code == 0 and "clean" in out
    corrupt_block(s.directory, 0, "bitflip")
    assert run(s.directory)[0] == 1                    # damage found, nothing done
    assert run(s.directory, "--quarantine")[0] == 0    # damage handled
    assert run(s.directory)[0] == 0                    # now clean
    assert run(str(tmp_path / "nowhere"))[0] == 2      # not a store


# ---------------------------------------------------------------------------
# StoreWriter crash window — resume adopts or deletes residue, deterministic
# ---------------------------------------------------------------------------


def test_writer_resume_adopts_crash_residue(tmp_path):
    s = _store_from_dense(tmp_path, _random_dense(64, 12, seed=10), [32, 32])
    orphan_block(s.directory, n_rows=8)   # crash between np.save and the flush
    orphan_block(s.directory, n_rows=4)
    st = StoreWriter(s.directory, n_items=12, block_tx=32, resume=True).close()
    assert st.n_blocks == 4 and st.n_tx == 64 + 12
    assert st.manifest.item_counts[0] >= 12   # adopted rows counted exactly
    with open(os.path.join(s.directory, "manifest.json")) as f:
        m1 = json.load(f)
    StoreWriter(s.directory, n_items=12, block_tx=32, resume=True).close()
    with open(os.path.join(s.directory, "manifest.json")) as f:
        assert json.load(f) == m1         # a second resume finds nothing to do


def test_writer_resume_deletes_torn_and_gapped_residue(tmp_path):
    s = _store_from_dense(tmp_path, _random_dense(32, 12, seed=11), [32])
    torn = orphan_block(s.directory, n_rows=8, torn=True)
    gapped = orphan_block(s.directory, n_rows=8, index=7)
    st = StoreWriter(s.directory, n_items=12, block_tx=32, resume=True).close()
    assert st.n_blocks == 1 and st.n_tx == 32     # neither was adoptable
    assert not os.path.exists(torn) and not os.path.exists(gapped)


def test_writer_resume_refuses_other_geometry_and_unrepaired_damage(tmp_path):
    s = _store_from_dense(tmp_path, _random_dense(64, 12, seed=12), [32, 32])
    with pytest.raises(ValueError, match="resume"):
        StoreWriter(s.directory, n_items=16, block_tx=32, resume=True)
    corrupt_block(s.directory, 1, "delete")
    with pytest.raises(StoreIntegrityError, match="cannot resume"):
        StoreWriter(s.directory, n_items=12, block_tx=32, resume=True)

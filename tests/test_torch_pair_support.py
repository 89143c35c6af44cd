"""Kernels B6 and B7's plain versions (the all-pairs support sweep) against
the JAX package.

On the CPU both plain torch versions are held bit-equal to the Pallas
kernels run in interpret mode and to the reference's jnp oracles
(``kernels/ref.py``), on ragged I and W and with ``valid_tid`` masks that
zero whole and partial words.  ``ops.pair_supports`` on CPU tensors is
those plain versions, and DB-Repl-Min's profit matrix is unchanged on the
CPU.  The CUDA kernels run only on the card, against these plain versions,
in ``test_torch_kernels_cuda.py``.  Supports stay far below 2^24, where the
reference's MXU kernel (f32 accumulation) is exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import schedule as ref_schedule
from repro.kernels import pair_support as ref_ps
from repro.kernels import ref as ref_ref
from repro_torch.core import bitmap as bm
from repro_torch.core import schedule
from repro_torch.kernels import ops
from repro_torch.kernels import pair_support as ps

# ragged (I, W): one row, sub-tile, past the reference's VPU tile of 64 rows
# and its MXU tile of 128, W past its word blocks of 64 and 256
SHAPES = [(1, 1), (7, 3), (17, 33), (65, 9), (130, 5), (33, 257), (100, 64)]


def _words(shape, seed):
    return np.random.default_rng(seed).integers(0, 2**32, size=shape, dtype=np.uint32)


def _valid(w, kind, seed):
    """``all``: every bit; ``ragged``: whole words, zeroed words and a ragged
    last word; ``zero``: nothing valid."""
    if kind == "all":
        return np.full(w, 0xFFFFFFFF, np.uint32)
    if kind == "zero":
        return np.zeros(w, np.uint32)
    v = _words((w,), seed)
    v[::3] = 0xFFFFFFFF
    v[1::4] = 0
    v[-1] = (1 << 11) - 1
    return v


@pytest.mark.parametrize("valid_kind", ["all", "ragged", "zero"])
@pytest.mark.parametrize("i,w", SHAPES)
def test_plain_versions_match_pallas_interpret_and_ref(i, w, valid_kind):
    items = _words((i, w), seed=i * 31 + w)
    valid = _valid(w, valid_kind, seed=w + 3)
    ji, jv = jnp.asarray(items), jnp.asarray(valid)
    want_vpu = np.asarray(ref_ps.pair_supports_pallas(ji, jv, interpret=True))
    want_mxu = np.asarray(ref_ps.pair_supports_mxu_pallas(ji, jv, interpret=True))
    np.testing.assert_array_equal(want_vpu, np.asarray(ref_ref.pair_supports_ref(ji, jv)))
    np.testing.assert_array_equal(want_mxu, np.asarray(ref_ref.pair_supports_mxu_ref(ji, jv)))

    ti, tv = bm.from_reference(items), bm.from_reference(valid)
    got = ps.pair_supports_plain(ti, tv)
    got_mxu = ps.pair_supports_mxu_plain(ti, tv)
    for out in (got, got_mxu):
        assert out.dtype == torch.int32 and out.shape == (i, i)
    np.testing.assert_array_equal(got.numpy(), want_vpu)
    np.testing.assert_array_equal(got_mxu.numpy(), want_mxu)
    if valid_kind == "zero":
        assert not got.numpy().any()


@pytest.mark.parametrize("use_mxu", [False, True])
def test_ops_routes_cpu_tensors_to_the_plain_versions(use_mxu):
    items, valid = _words((23, 40), seed=1), _valid(40, "ragged", seed=2)
    want = np.asarray(ref_ref.pair_supports_ref(jnp.asarray(items), jnp.asarray(valid)))
    before = ops.kernel_launches()
    got = ops.pair_supports(bm.from_reference(items), bm.from_reference(valid),
                            use_mxu=use_mxu)
    assert ops.kernel_launches() == before          # no kernel on the CPU
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_chunks_rows_like_one_pass(monkeypatch):
    """The plain version's row chunks add up to the one-pass count."""
    items = bm.from_reference(_words((29, 11), 4))
    valid = bm.from_reference(_valid(11, "ragged", 5))
    whole = ps.pair_supports_plain(items, valid)
    monkeypatch.setattr(ps, "_PLAIN_CHUNK", 3 * 29 * 11)   # 3 rows a chunk
    assert torch.equal(ps.pair_supports_plain(items, valid), whole)


def test_empty_axes():
    for i, w in ((0, 4), (5, 0), (0, 0)):
        items, valid = torch.zeros((i, w), dtype=torch.int32), torch.zeros((w,), dtype=torch.int32)
        for fn in (ps.pair_supports_plain, ps.pair_supports_mxu_plain):
            out = fn(items, valid)
            assert out.shape == (i, i) and not out.any()


def test_cuda_wrappers_refuse_cpu_tensors():
    items, valid = bm.from_reference(_words((9, 5), 1)), bm.from_reference(_words((5,), 2))
    for fn in (ps.pair_supports_cuda, ps.pair_supports_mxu_cuda):
        with pytest.raises(ValueError):
            fn(items, valid)


@pytest.mark.parametrize("c,w", [(1, 64), (12, 64), (40, 33)])
def test_profit_matrix_unchanged_on_the_cpu(c, w):
    """DB-Repl-Min's profit matrix equals the reference's, diagonal zeroed."""
    tids = _words((c, w), seed=c + w)
    want = np.asarray(ref_schedule.pairwise_shared_transactions(jnp.asarray(tids)))
    got = schedule.pairwise_shared_transactions(bm.from_reference(tids))
    np.testing.assert_array_equal(got, want)
    assert not np.diag(got).any()

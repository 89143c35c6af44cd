"""The port's LM building blocks against the JAX package's, function by
function, on the CPU in f32: ``models/{layers,attention,mla,moe,mamba2}.py``.

Weights come from the reference's spec trees and ``init_params`` and are
carried across as numpy arrays; inputs are numpy draws from a seed; the JAX
side is ``jax.jit``-ed.  Every output is held to the reference's within
1e-5 x max |output|, and the integer ones (MoE drops and loads, the LPT
permutation) exactly.  MoE routing: ``torch.topk`` and ``lax.top_k`` may order
equal probabilities differently; random f32 router weights give no ties.
"""
import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import MLAConfig as RMLA
from repro.configs.base import MoEConfig as RMoE
from repro.configs.base import SSMConfig as RSSM
from repro.models import attention as rattn
from repro.models import layers as rlayers
from repro.models import mamba2 as rm2
from repro.models import mla as rmla
from repro.models import moe as rmoe
from repro_torch.configs.base import MLAConfig, MoEConfig, SSMConfig
from repro_torch.models import attention as attn
from repro_torch.models import layers
from repro_torch.models import mamba2 as m2
from repro_torch.models import mla
from repro_torch.models import moe
from repro_torch.models.convert import tree_from_jax
from repro_torch.models.layers import ParamSpec, init_params

REL = 1e-5
KEY = jax.random.PRNGKey(3)


def close(got, want, rel=REL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max())
    assert err <= rel * scale, f"max err {err} > {rel} x {scale}"


def rand(*shape, seed=0, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def T(a):
    return torch.from_numpy(np.array(a))


def weights(specs):
    """The reference's f32 init of ``specs``: (jax tree, port tree)."""
    p = rlayers.init_params(specs, KEY, dtype=jnp.float32)
    return p, tree_from_jax(jax.tree.map(np.asarray, p), "cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------


def test_norm_rope_mlps_and_cross_entropy():
    x, g = rand(2, 5, 16), rand(16, seed=1)
    close(layers.rms_norm(T(x), T(g), 1e-5), jax.jit(rlayers.rms_norm)(x, g, 1e-5))
    q = rand(2, 5, 3, 8, seed=2)
    pos = np.array([0, 3, 7, 8, 100], np.int32)
    close(layers.apply_rope(T(q), T(pos), 500_000.0),
          jax.jit(rlayers.apply_rope, static_argnums=2)(q, pos, 500_000.0))
    close(layers.rope_freqs(8, 10_000.0), rlayers.rope_freqs(8, 10_000.0))
    for kind in ("swiglu", "gelu"):
        p, pt = weights(rlayers.mlp_specs(16, 32, kind))
        close(layers.mlp_forward(T(x), pt), jax.jit(rlayers.mlp_forward)(x, p))
    logits = rand(3, 4, 11, seed=4)
    labels = np.random.default_rng(5).integers(0, 11, (3, 4)).astype(np.int32)
    mask = np.random.default_rng(6).random((3, 4)) < 0.5
    close(layers.cross_entropy(T(logits), T(labels)), rlayers.cross_entropy(logits, labels))
    close(layers.cross_entropy(T(logits), T(labels), T(mask)),
          rlayers.cross_entropy(logits, labels, mask))


def test_spec_trees_count_and_init_laws():
    """Counts equal the reference's; init draws follow the same laws
    (zeros, ones, N(0, 1)·scale with fan-in scale), from torch's generator."""
    specs = {"w": ParamSpec((64, 256), ("a", "b")), "s": ParamSpec((4, 32), ("a", "b"),
                                                                   scale=0.02),
             "z": {"b": ParamSpec((7,), ("a",), init="zeros"),
                   "o": ParamSpec((3, 5), ("a", "b"), init="ones")}}
    stacked = layers.stacked(specs, 3)
    rstacked = rlayers.stacked(jax.tree.map(
        lambda s: rlayers.ParamSpec(s.shape, s.axes, s.init, s.scale), specs,
        is_leaf=lambda s: isinstance(s, ParamSpec)), 3)
    assert layers.param_count(stacked) == rlayers.param_count(rstacked)
    got = init_params(stacked, torch.Generator().manual_seed(0), torch.float32)
    assert got["w"].shape == (3, 64, 256) and got["w"].dtype == torch.float32
    assert abs(float(got["w"].std()) - 1 / math.sqrt(64)) < 0.01
    assert abs(float(got["s"].std()) - 0.02) < 0.002
    assert not got["z"]["b"].any() and bool((got["z"]["o"] == 1).all())
    bf = init_params(specs, torch.Generator().manual_seed(0), torch.bfloat16)
    assert bf["w"].dtype == torch.bfloat16
    # one generator state, one draw: the same seed gives the same weights
    again = init_params(stacked, torch.Generator().manual_seed(0), torch.float32)
    assert torch.equal(again["w"], got["w"])


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("chunk", [None, 8])
def test_gqa_forward_dense_and_chunked(chunk):
    p, pt = weights(rattn.attn_specs(32, 4, 2, 8))
    x = rand(2, 32, 32, seed=7)
    want = jax.jit(lambda p, x: rattn.gqa_forward(p, x, 10_000.0, chunk=chunk))(p, x)
    close(attn.gqa_forward(pt, T(x), 10_000.0, chunk=chunk), want)
    # the chunked path is the dense one, up to f32 rounding
    close(attn.gqa_forward(pt, T(x), 10_000.0, chunk=None), want, rel=1e-5)


def test_attention_kernels_directly():
    q, k, v = rand(2, 16, 4, 8, seed=1), rand(2, 16, 2, 8, seed=2), rand(2, 16, 2, 6, seed=3)
    close(attn.chunked_causal_attention(T(q), T(k), T(v), 4),
          jax.jit(rattn.chunked_causal_attention, static_argnums=3)(q, k, v, 4))
    v8 = rand(2, 16, 2, 8, seed=4)
    close(attn.chunked_bidir_attention(T(q), T(k), T(v8), 4),
          jax.jit(rattn.chunked_bidir_attention, static_argnums=3)(q, k, v8, 4))
    pos = np.arange(16, dtype=np.int32)
    close(attn.sdpa_causal(T(q), T(k), T(v8), T(pos), k_valid_len=11),
          rattn.sdpa_causal(q, k, v8, pos, k_valid_len=jnp.asarray(11)))
    with pytest.raises(ValueError):
        attn.chunked_causal_attention(T(q), T(k), T(v), 5)


@pytest.mark.parametrize("chunk", [None, 8])
def test_bidir_and_cross_attention(chunk):
    p, pt = weights(rattn.attn_specs(32, 4, 4, 8))
    x, enc = rand(2, 16, 32, seed=8), rand(2, 24, 32, seed=9)
    close(attn.bidir_attention(pt, T(x), 10_000.0, chunk=chunk),
          jax.jit(lambda p, x: rattn.bidir_attention(p, x, 10_000.0, chunk=chunk))(p, x))
    close(attn.cross_attention(pt, T(x), T(enc)), jax.jit(rattn.cross_attention)(p, x, enc))


def test_gqa_decode_step_and_cache():
    p, pt = weights(rattn.attn_specs(32, 4, 2, 8))
    cache0 = {"k": rand(2, 12, 2, 8, seed=10), "v": rand(2, 12, 2, 8, seed=11)}
    x = rand(2, 1, 32, seed=12)
    want, wc = jax.jit(lambda p, c, x, pos: rattn.gqa_decode_step(p, c, x, pos, 10_000.0))(
        p, cache0, x, jnp.asarray(5, jnp.int32))
    cache = tree_from_jax(cache0, "cpu")
    got, gc = attn.gqa_decode_step(pt, cache, T(x), 5, 10_000.0)
    close(got, want)
    close(gc["k"], wc["k"])
    close(gc["v"], wc["v"])
    assert gc is cache      # written in place
    with pytest.raises(IndexError):   # the reference clamps; the port raises
        attn.gqa_decode_step(pt, cache, T(x), 12, 10_000.0)


# ---------------------------------------------------------------------------
# MLA
# ---------------------------------------------------------------------------

M_CFG = dict(q_lora_rank=24, kv_lora_rank=16, qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8)


@pytest.mark.parametrize("chunk", [None, 8])
def test_mla_forward_and_absorbed_decode(chunk):
    rm, m = RMLA(**M_CFG), MLAConfig(**M_CFG)
    p, pt = weights(rmla.mla_specs(32, 4, rm))
    x = rand(2, 16, 32, seed=13)
    close(mla.mla_forward(pt, T(x), m, chunk=chunk),
          jax.jit(lambda p, x: rmla.mla_forward(p, x, rm, chunk=chunk))(p, x))
    cache0 = {"c_kv": rand(2, 10, 16, seed=14), "k_rope": rand(2, 10, 4, seed=15)}
    x1 = rand(2, 1, 32, seed=16)
    want, wc = jax.jit(lambda p, c, x, pos: rmla.mla_decode_step(p, c, x, pos, rm))(
        p, cache0, x1, jnp.asarray(6, jnp.int32))
    got, gc = mla.mla_decode_step(pt, tree_from_jax(cache0, "cpu"), T(x1), 6, m)
    close(got, want)
    close(gc["c_kv"], wc["c_kv"])
    close(gc["k_rope"], wc["k_rope"])


# ---------------------------------------------------------------------------
# MoE
# ---------------------------------------------------------------------------


def _moe_pair(**kw):
    return RMoE(**kw), MoEConfig(**kw)


@pytest.mark.parametrize("kw", [
    dict(n_experts=8, top_k=2, expert_d_ff=16),                          # no drops
    dict(n_experts=8, top_k=2, expert_d_ff=16, capacity_factor=0.5),     # drops
    dict(n_experts=8, n_shared=2, top_k=3, expert_d_ff=16, capacity_factor=0.5,
         token_chunk=8),                                                  # chunked
])
def test_moe_forward_dispatch_drops_and_loads(kw):
    rm, m = _moe_pair(**kw)
    p, pt = weights(rmoe.moe_specs(32, rm))
    x = rand(2, 16, 32, seed=17)
    want, waux = jax.jit(lambda p, x: rmoe.moe_forward(p, x, rm))(p, x)
    got, aux = moe.moe_forward(pt, T(x), m)
    close(got, want)
    assert int(aux["dropped"]) == int(waux["dropped"])
    np.testing.assert_array_equal(aux["expert_load"].numpy(), np.asarray(waux["expert_load"]))
    close(aux["lb_loss"], waux["lb_loss"])
    if kw.get("capacity_factor", 1.25) < 1:
        assert int(aux["dropped"]) > 0


def test_lpt_expert_permutation_and_its_application():
    rm, m = _moe_pair(n_experts=8, top_k=2, expert_d_ff=16)
    load = np.random.default_rng(18).random(8) * 100
    for ranks in (1, 2, 4, 8):
        perm = moe.lpt_expert_permutation(load, ranks)
        np.testing.assert_array_equal(perm, rmoe.lpt_expert_permutation(load, ranks))
    perm = moe.lpt_expert_permutation(load, 4)
    p, pt = weights(rmoe.moe_specs(32, rm))
    x = rand(1, 8, 32, seed=19)
    want, _ = rmoe.moe_forward(rmoe.apply_expert_permutation(p, perm), x, rm,
                               expert_perm=jnp.asarray(perm))
    got, _ = moe.moe_forward(moe.apply_expert_permutation(pt, perm), T(x), m,
                             expert_perm=torch.from_numpy(perm))
    close(got, want)
    with pytest.raises(ValueError):
        moe.lpt_expert_permutation(load, 3)


# ---------------------------------------------------------------------------
# Mamba-2
# ---------------------------------------------------------------------------

S_CFG = dict(d_state=8, expand=2, head_dim=8, n_groups=2, conv_width=4, chunk=4)


def test_ssd_chunked_with_initial_state():
    x, dt = rand(2, 16, 4, 8, seed=20), np.abs(rand(2, 16, 4, seed=21)) * 0.5
    A = -np.abs(rand(4, seed=22))
    Bm, Cm = rand(2, 16, 2, 8, seed=23), rand(2, 16, 2, 8, seed=24)
    h0 = rand(2, 4, 8, 8, seed=25)
    fn = jax.jit(rm2.ssd_chunked, static_argnums=5)
    wy, wh = fn(x, dt, A, Bm, Cm, 4, h0)
    gy, gh = m2.ssd_chunked(T(x), T(dt), T(A), T(Bm), T(Cm), 4, T(h0))
    close(gy, wy)
    close(gh, wh)
    wy0, _ = fn(x, dt, A, Bm, Cm, 8)
    close(m2.ssd_chunked(T(x), T(dt), T(A), T(Bm), T(Cm), 8)[0], wy0)
    close(m2._segsum(T(dt[0, :5, 0])).clamp_min(-1e30),
          jnp.maximum(rm2._segsum(dt[0, :5, 0]), -1e30))


def test_mamba2_forward_and_decode_step():
    rs, s = RSSM(**S_CFG), SSMConfig(**S_CFG)
    p, pt = weights(rm2.mamba2_specs(16, rs))
    # non-trivial A_log, dt_bias, conv biases (the init leaves them at 0)
    for k, seed in (("A_log", 26), ("dt_bias", 27), ("conv_x_b", 28), ("conv_bc_b", 29)):
        p = {**p, k: jnp.asarray(rand(*p[k].shape, seed=seed, scale=0.3))}
    pt = tree_from_jax(jax.tree.map(np.asarray, p), "cpu")
    x = rand(2, 16, 16, seed=30)
    close(m2.mamba2_forward(pt, T(x), s),
          jax.jit(lambda p, x: rm2.mamba2_forward(p, x, rs))(p, x))
    cache0 = {"conv_x": rand(2, 3, 32, seed=31), "conv_bc": rand(2, 3, 32, seed=32),
              "ssm": rand(2, 4, 8, 8, seed=33)}
    x1 = rand(2, 1, 16, seed=34)
    want, wc = jax.jit(lambda p, c, x: rm2.mamba2_decode_step(p, c, x, rs))(p, cache0, x1)
    got, gc = m2.mamba2_decode_step(pt, tree_from_jax(cache0, "cpu"), T(x1), s)
    close(got, want)
    for k in cache0:
        close(gc[k], wc[k])
    with pytest.raises(ValueError):   # T not a multiple of the chunk
        m2.mamba2_forward(pt, T(rand(1, 6, 16)), s)


def test_configs_equal_reference_field_by_field():
    from repro.configs import registry as ref_registry
    from repro_torch.configs import registry

    assert registry.all_archs() == ref_registry.all_archs()
    for arch in registry.all_archs():
        for smoke in (False, True):
            assert dataclasses.asdict(registry.get_config(arch, smoke)) == \
                dataclasses.asdict(ref_registry.get_config(arch, smoke))
    from repro.configs import base as rbase
    from repro_torch.configs import base

    assert {k: dataclasses.asdict(v) for k, v in base.SHAPES.items()} == \
        {k: dataclasses.asdict(v) for k, v in rbase.SHAPES.items()}
    for arch in registry.all_archs():
        assert base.shapes_for(registry.get_config(arch)) == \
            rbase.shapes_for(ref_registry.get_config(arch))

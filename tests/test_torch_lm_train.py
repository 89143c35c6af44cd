"""The port's LM training half (``repro_torch.models.steps``,
``repro_torch.optim.adamw``, ``launch/train.py``) against the JAX package's,
on the CPU, in f32 (this file: the dense decoders and the VLM, AdamW, the
accumulation and the abstract tree; the MoE, SSM, hybrid and enc-dec
families are in ``test_torch_lm_train_{b,d}.py``, their whole steps and
remat in ``test_torch_lm_train_c.py``).

Weights are the reference's ``M.init``, carried across by
``convert.from_jax_params``.  Tolerances (``torch_lm_train_parity``): the
loss within 1e-5 nats; each leaf's gradient within 1e-3 of that leaf's max
|g|; AdamW's update on the same gradients within 1e-6 of each leaf's max;
after a whole step every parameter within ``2·lr`` of the reference's (the
first step's sign where |g| is rounding noise).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parity as parity
import torch_lm_train_parity as tp
from repro.configs import registry as ref_registry
from repro.models import model as RM
from repro.optim import adamw as ref_adamw
from repro_torch.configs import registry
from repro_torch.launch import train
from repro_torch.models import convert, steps
from repro_torch.models import model as M
from repro_torch.models.layers import leaves
from repro_torch.optim import adamw

ARCHS = ["llama3.2-3b", "granite-20b", "starcoder2-15b", "minicpm3-4b", "internvl2-26b"]
#: AdamW's own arithmetic on identical inputs, as a share of each leaf's max
ADAMW_REL = 1e-6


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_equal_reference(arch):
    assert tp.check_grads(arch) <= tp.grad_rel(arch)


@pytest.mark.parametrize("arch", sorted(registry.all_archs()))
def test_abstract_tree_equals_reference(arch):
    """``M.abstract`` of each full config: ``meta`` tensors at the
    reference's paths, shapes and dtype, nothing allocated."""
    cfg = registry.get_config(arch)
    tree = dict(leaves(M.abstract(cfg)))
    want = dict(leaves(RM.abstract(ref_registry.get_config(arch))))
    assert set(tree) == set(want)
    for path, t in tree.items():
        assert t.device.type == "meta"
        assert tuple(t.shape) == tuple(want[path].shape), path
        assert str(t.dtype).removeprefix("torch.") == str(want[path].dtype)
    assert sum(t.numel() for t in tree.values()) == M.n_params(cfg)


@pytest.mark.parametrize("step", [0, 1, 20, 60, 100, 150])
def test_lr_schedule_equals_reference(step):
    cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=100)
    got = float(adamw.lr_at(torch.tensor(step, dtype=torch.int32), cfg))
    want = float(ref_adamw.lr_at(jnp.asarray(step, jnp.int32), tp.ref_opt(cfg)))
    assert abs(got - want) <= ADAMW_REL * want, (got, want)


def _ref_grads(arch, seed=0):
    ref_cfg, params, cfg, model = tp.models(arch)
    b = tp.batch(cfg, seed)
    g = jax.jit(jax.grad(lambda p, bb: RM.loss_fn(ref_cfg, p, bb)))(params, b)
    return params, model, g


@pytest.mark.parametrize("state_dtype", ["float32", "bfloat16"])
def test_adamw_update_equals_reference(state_dtype):
    """Two ``update``s on the reference's gradients, carried across: the
    parameters, moments, step, grad norm and lr equal the reference's
    within 1e-6 of each leaf's max, the moments in ``state_dtype``."""
    params, model, g = _ref_grads("llama3.2-3b")
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10, state_dtype=state_dtype)
    rcfg = tp.ref_opt(cfg)
    grads = convert.tree_from_jax(parity.np_tree(g), "cpu")
    p = model.params()
    st = adamw.init(p, cfg)
    want_p, want_st = params, ref_adamw.init(params, rcfg)
    for k in (1, 2):
        want_p, want_st, want_m = ref_adamw.update(g, want_st, want_p, rcfg)
        p, st, m = adamw.update(grads, st, p, cfg)
        assert int(st.step) == int(want_st.step) == k and st.step.dtype == torch.int32
        for key in ("grad_norm", "lr"):
            assert abs(float(m[key]) - float(want_m[key])) <= ADAMW_REL * float(want_m[key])
        for got, want, what in ((p, want_p, "params"), (st.m, want_st.m, "m"),
                                (st.v, want_st.v, "v")):
            want = dict(leaves(parity.np_tree(want)))
            for path, t in leaves(got):
                assert str(t.dtype).removeprefix("torch.") == str(want[path].dtype)
                parity.close(t.detach().float().numpy(), want[path].astype(np.float32),
                             ADAMW_REL, f"step {k} {what} {path}")


def test_global_norm_equals_reference():
    _, _, g = _ref_grads("granite-20b")
    got = float(adamw.global_norm(convert.tree_from_jax(parity.np_tree(g), "cpu")))
    want = float(ref_adamw.global_norm(g))
    assert abs(got - want) <= ADAMW_REL * want


def test_chunked_update_equals_whole_leaf(monkeypatch):
    """The update in slices of a leaf's leading dim (``CHUNK`` elements at
    most) is the update of the whole leaf, bit for bit.  (The global norm's
    sum runs in another order when sliced: the gradients stay under the
    clip, so the scale is 1 either way.)"""
    gen = torch.Generator().manual_seed(0)
    p = {"stack": torch.randn((6, 5, 7), generator=gen), "flat": torch.randn(300, generator=gen)}
    g = {k: 0.01 * torch.randn(v.shape, generator=gen) for k, v in p.items()}
    cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1)
    whole = {k: v.clone() for k, v in p.items()}
    st_whole = adamw.init(whole, cfg)
    assert float(adamw.update(g, st_whole, whole, cfg)[2]["grad_norm"]) < cfg.grad_clip
    monkeypatch.setattr(adamw, "CHUNK", 70)
    assert len(adamw._chunks(p["stack"])) == 3 and len(adamw._chunks(p["flat"])) == 5
    st = adamw.init(p, cfg)
    adamw.update(g, st, p, cfg)
    for k in p:
        assert torch.equal(p[k], whole[k]) and torch.equal(st.m[k], st_whole.m[k])
        assert torch.equal(st.v[k], st_whole.v[k])


@pytest.mark.parametrize("arch", ["llama3.2-3b", "internvl2-26b"])
def test_train_step_equals_reference(arch):
    share = tp.check_train_step(arch, adamw.AdamWConfig(lr=1e-3, warmup_steps=1))
    assert share < 0.01, share


def test_accum2_equals_reference():
    """``accum=2``: the gradients are the f32 mean of the two microbatches'
    (the reference's scan), and the whole step equals the reference's
    ``make_train_step(accum=2)``."""
    ref_cfg, params, cfg, model = tp.models("llama3.2-3b")
    b = tp.batch(cfg, B=4)
    vg = jax.jit(jax.value_and_grad(lambda p, bb: RM.loss_fn(ref_cfg, p, bb)))
    halves = [vg(params, {k: v[i * 2:(i + 1) * 2] for k, v in b.items()}) for i in (0, 1)]
    want_loss = (float(halves[0][0]) + float(halves[1][0])) / 2
    want = jax.tree.map(lambda x, y: (x.astype(jnp.float32) + y) / 2, halves[0][1],
                        halves[1][1])
    loss, grads = steps.accumulated_grads(cfg, model.params(), parity.torch_batch(b), accum=2)
    assert abs(float(loss) - want_loss) <= tp.LOSS_TOL
    assert all(t.dtype == torch.float32 for _, t in leaves(grads))
    tp.close_grads(grads, dict(leaves(parity.np_tree(want))), what="accum 2")
    share = tp.check_train_step("llama3.2-3b", adamw.AdamWConfig(lr=1e-3, warmup_steps=1),
                                accum=2, B=4)
    assert share < 0.01, share


def test_grad_dtypes_follow_the_reference():
    """bf16 parameters: one microbatch's gradients are bf16 (the
    parameters' dtype, as ``jax.grad`` gives them), accumulated ones f32."""
    ref_cfg, params, cfg, model = tp.models("llama3.2-3b", param_dtype="bfloat16")
    b = tp.batch(cfg, B=4)
    _, want = jax.jit(jax.value_and_grad(lambda p, bb: RM.loss_fn(ref_cfg, p, bb)))(params, b)
    assert {str(a.dtype) for a in jax.tree.leaves(want)} == {"bfloat16"}
    tb = parity.torch_batch(b)
    _, g1 = steps.accumulated_grads(cfg, model.params(), tb, accum=1)
    _, g2 = steps.accumulated_grads(cfg, model.params(), tb, accum=2)
    assert {t.dtype for _, t in leaves(g1)} == {torch.bfloat16}
    assert {t.dtype for _, t in leaves(g2)} == {torch.float32}


def test_train_launcher_raises_without_cuda(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--smoke", "--steps", "1", "--batch", "2", "--seq", "16", "--ckpt-dir",
            str(tmp_path)]
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(argv)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(argv + ["--device", "cuda"])
    run = train.main(argv + ["--device", "cpu"])
    assert [r.step for r in run.records] == [0] and np.isfinite(run.records[0].loss)

"""Shared checks of the port's LM training half (``repro_torch.models.steps``,
``repro_torch.optim.adamw``) against the JAX package's, on the CPU, in f32.

The weights are the reference's ``M.init`` at a fixed key, carried across by
``convert.from_jax_params`` (``torch_lm_parity.models``); the batches are
drawn with numpy from a seed, a loss mask included.  The JAX side is
``jax.jit``-ed.  Used by ``test_torch_lm_train*.py``.
"""
import dataclasses

import jax
import numpy as np

import torch_lm_parity as parity
from repro.configs import registry as ref_registry
from repro.models import model as RM
from repro.models import steps as ref_steps
from repro.optim import adamw as ref_adamw
from repro_torch.configs import registry
from repro_torch.models import convert, steps
from repro_torch.models.layers import leaves
from repro_torch.optim import adamw

#: the loss, absolute (nats); the reference's and the port's f32 losses
#: differ by at most 2e-6 on these configs
LOSS_TOL = 1e-5
#: each leaf's gradient, as a share of that leaf's max |g| (worst measured:
#: 1.3e-4 outside whisper), and the global grad norm, relative (worst
#: measured 4.2e-5, internvl2)
GRAD_REL = 1e-3
NORM_REL = 1e-4
#: whisper's own: its encoder's attention is near one-hot under the
#: reference's init law, so f32 rounding moves its gradients.  The
#: reference's own gradients move by more than GRAD_REL of a leaf's max when
#: its frames change by 1e-7 relative
#: (``test_torch_lm_train_d.py::test_whisper_reference_gradients_are_ill_conditioned``);
#: the port's differ from them by about as much (1.4e-3, the grad norm
#: 1.1e-3, on this file's batch).
COND = {"whisper-small": {"grad": 1e-2, "norm": 1e-2}}


def grad_rel(arch: str) -> float:
    return COND.get(arch, {}).get("grad", GRAD_REL)


def norm_rel(arch: str) -> float:
    return COND.get(arch, {}).get("norm", NORM_REL)


def batch(cfg, seed: int = 0, B: int = parity.B):
    """``torch_lm_parity.inputs`` with ``B`` rows and a loss mask."""
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab, (B, parity.T)).astype(np.int32),
         "loss_mask": rng.random((B, parity.T - 1)) < 0.8}
    if cfg.family == "vlm":
        b["vision_embeds"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        b["frames"] = rng.standard_normal((B, cfg.enc_context, cfg.d_model)).astype(np.float32)
    return b


def models(arch: str, **changes):
    """``torch_lm_parity.models`` with the same ``dataclasses.replace`` on
    both configs (``moe=`` a dict of ``MoEConfig`` fields to change)."""
    ref_cfg = ref_registry.get_config(arch, smoke=True)
    cfg = registry.get_config(arch, smoke=True)
    moe = changes.pop("moe", None)
    if moe:
        ref_cfg = dataclasses.replace(ref_cfg, moe=dataclasses.replace(ref_cfg.moe, **moe))
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe))
    ref_cfg = dataclasses.replace(ref_cfg, **changes)
    cfg = dataclasses.replace(cfg, **changes)
    params = RM.init(ref_cfg, parity.KEY)
    return ref_cfg, params, cfg, convert.from_jax_params(cfg, parity.np_tree(params), "cpu")


def ref_value_and_grad(ref_cfg, params, b):
    loss, g = jax.jit(jax.value_and_grad(lambda p, bb: RM.loss_fn(ref_cfg, p, bb)))(params, b)
    return float(loss), dict(leaves(parity.np_tree(g)))


def close_grads(got, want, rel: float = GRAD_REL, what: str = ""):
    """Every leaf of ``got`` (a tree of tensors) against ``want`` (``{path:
    array}``); the worst share of a leaf's max |g|."""
    got = dict(leaves(got))
    assert set(got) == set(want), sorted(set(got) ^ set(want))
    return max(parity.close(got[k].detach().numpy(), want[k], rel, f"{what} grad {k}")
               for k in want)


def check_grads(arch: str, **changes):
    """The loss and every leaf's gradient against ``jax.value_and_grad`` of
    the reference's ``loss_fn`` (within ``grad_rel(arch)``); returns the
    worst share."""
    ref_cfg, params, cfg, model = models(arch, **changes)
    b = batch(cfg)
    want_loss, want = ref_value_and_grad(ref_cfg, params, b)
    loss, grads = steps.value_and_grad(cfg, model.params(), parity.torch_batch(b))
    assert abs(float(loss) - want_loss) <= LOSS_TOL, (arch, float(loss), want_loss)
    return close_grads(grads, want, grad_rel(arch), what=arch)


def ref_opt(opt_cfg: adamw.AdamWConfig) -> ref_adamw.AdamWConfig:
    """The port's AdamW config as the reference's."""
    return ref_adamw.AdamWConfig(**dataclasses.asdict(opt_cfg))


def check_train_step(arch: str, opt_cfg: adamw.AdamWConfig, accum: int = 1, B: int = parity.B,
                     **changes):
    """One whole step of both packages from the same weights and batch:
    loss within ``LOSS_TOL``, grad norm within ``norm_rel``, lr equal, and
    every parameter and moment after the step within ``2·lr`` of the
    reference's.  Adam's first step is ``lr·g/(|g| + eps)``, so where |g| is
    rounding noise its sign may flip: that is the bound.  Returns the share
    of parameter elements that differ by more than 1e-6."""
    ref_cfg, params, cfg, model = models(arch, **changes)
    b = batch(cfg, B=B)
    ropt = ref_opt(opt_cfg)
    step = jax.jit(ref_steps.make_train_step(ref_cfg, ropt, accum=accum))
    want_p, want_o, want_m = step(params, ref_adamw.init(params, ropt), b)
    p = model.params()
    got_p, got_o, got_m = steps.make_train_step(cfg, opt_cfg, accum=accum)(
        p, adamw.init(p, opt_cfg), parity.torch_batch(b))
    assert abs(float(got_m["loss"]) - float(want_m["loss"])) <= LOSS_TOL
    gn, want_gn = float(got_m["grad_norm"]), float(want_m["grad_norm"])
    assert abs(gn - want_gn) <= norm_rel(arch) * want_gn, (gn, want_gn)
    assert abs(float(got_m["lr"]) - float(want_m["lr"])) <= 1e-6 * float(want_m["lr"])
    assert int(got_o.step) == int(want_o.step) == 1
    lr = float(want_m["lr"])
    want_p = dict(leaves(parity.np_tree(want_p)))
    beyond, total = 0, 0
    for path, t in leaves(got_p):
        d = np.abs(t.detach().numpy().astype(np.float64) - want_p[path])
        assert d.max() <= 2 * lr * (1 + 1e-4), (arch, path, d.max(), lr)
        beyond += int((d > 1e-6).sum())
        total += d.size
    for name in ("m", "v"):
        want = dict(leaves(parity.np_tree(getattr(want_o, name))))
        for path, t in leaves(getattr(got_o, name)):
            # the first step's moments are the gradient's (m) and its square's (v)
            parity.close(t.numpy(), want[path], 2 * grad_rel(arch), f"{arch} {name} {path}")
    return beyond / total

"""The port's LM training half against the JAX package's, on the CPU, in
f32 (this file: the gradients of the MoE families when the capacity
dispatch drops routed pairs, and why whisper has bounds of its own; the
other gradients are in ``test_torch_lm_train{,_b}.py``).

Tolerances are ``torch_lm_train_parity``'s: the loss within 1e-5 nats,
each leaf's gradient within 1e-3 of its max |g|.
"""
import numpy as np
import pytest

import torch_lm_train_parity as tp
from repro_torch.models import moe as moe_mod

MOE_ARCHS = ["olmoe-1b-7b", "qwen2-moe-a2.7b", "jamba-1.5-large-398b"]


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_grads_with_capacity_drops_equal_reference(arch, monkeypatch):
    """At capacity factor 0.5 the dispatch drops routed pairs (the dump
    row, then ``index_add_``'s combine): the gradients still equal the
    reference's."""
    dropped = []
    forward = moe_mod.moe_forward

    def counting(*args, **kw):
        y, aux = forward(*args, **kw)
        dropped.append(int(aux["dropped"]))
        return y, aux

    monkeypatch.setattr(moe_mod, "moe_forward", counting)
    assert tp.check_grads(arch, moe={"capacity_factor": 0.5}) <= tp.GRAD_REL
    assert dropped and min(dropped) > 0, dropped


def test_whisper_reference_gradients_are_ill_conditioned():
    """Why whisper is held to ``COND`` and not ``GRAD_REL``: the
    reference's own f32 gradients, on the batch of ``check_grads``, move by
    more than ``GRAD_REL`` of a leaf's max (and their norm by more than
    ``NORM_REL``) when its frames change by 1e-7 relative, and stay within
    whisper's bounds."""
    ref_cfg, params, cfg, _ = tp.models("whisper-small")
    b = tp.batch(cfg)
    _, want = tp.ref_value_and_grad(ref_cfg, params, b)
    nudged = dict(b, frames=(b["frames"] * (1 + 1e-7)).astype(np.float32))
    _, moved = tp.ref_value_and_grad(ref_cfg, params, nudged)
    share = max(float(np.abs(moved[k] - want[k]).max() / np.abs(want[k]).max()) for k in want)
    norms = [np.sqrt(sum(float((g.astype(np.float64) ** 2).sum()) for g in t.values()))
             for t in (want, moved)]
    norm_move = abs(norms[1] - norms[0]) / norms[0]
    assert tp.GRAD_REL < share < tp.grad_rel("whisper-small"), share
    assert tp.NORM_REL < norm_move < tp.norm_rel("whisper-small"), norm_move

"""The port's LM training half, on the CPU, in f32 (this file: one whole
train step of the MoE, SSM, hybrid and enc-dec families against the JAX
package's, and remat; gradients are in ``test_torch_lm_train{,_b}.py``).

A whole step is held to ``torch_lm_train_parity.check_train_step``'s
bounds (every parameter within ``2·lr`` of the reference's, fewer than 1 %
of them beyond 1e-6).  Remat is checked within the port:
``remat="block"`` gives the gradients of ``remat="none"`` bit for bit, with
each checkpointed body run twice.
"""
import dataclasses

import pytest
import torch

import torch_lm_parity as parity
import torch_lm_train_parity as tp
from repro_torch.configs import registry
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import model as M
from repro_torch.models import steps
from repro_torch.models.layers import leaves
from repro_torch.optim import adamw


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "mamba2-1.3b", "jamba-1.5-large-398b",
                                  "whisper-small"])
def test_train_step_equals_reference(arch):
    share = tp.check_train_step(arch, adamw.AdamWConfig(lr=1e-3, warmup_steps=1))
    assert share < 0.01, share


#: the function each family runs once a checkpointed body (the hybrid: its
#: mamba sublayers; the enc-dec: the encoder's and the decoder's attention)
REMAT_COUNTED = {"llama3.2-3b": (M, "_decoder_block"), "olmoe-1b-7b": (M, "_decoder_block"),
                 "mamba2-1.3b": (M, "_ssm_block"),
                 "jamba-1.5-large-398b": (m2, "mamba2_forward"),
                 "whisper-small": (attn, "gqa_forward")}


@pytest.mark.parametrize("arch", sorted(REMAT_COUNTED))
def test_remat_block_grads_bit_equal_to_none(arch, monkeypatch):
    module, name = REMAT_COUNTED[arch]
    calls = []
    fn = getattr(module, name)

    def counting(*args, **kw):
        calls.append(1)
        return fn(*args, **kw)

    monkeypatch.setattr(module, name, counting)
    base = registry.get_config(arch, smoke=True)
    params = M.init(dataclasses.replace(base, remat="none"), 0, "cpu").params()
    b = parity.torch_batch(tp.batch(base))
    out = {}
    for remat in ("none", "block"):
        calls.clear()
        out[remat] = steps.value_and_grad(dataclasses.replace(base, remat=remat), params, b)
        out[remat + "_calls"] = len(calls)
    assert out["none_calls"] > 0 and out["block_calls"] == 2 * out["none_calls"]
    assert torch.equal(out["none"][0], out["block"][0])
    want = dict(leaves(out["none"][1]))
    for path, g in leaves(out["block"][1]):
        assert torch.equal(g, want[path]), path
    # without gradients nothing is checkpointed: one run of each body
    calls.clear()
    with torch.no_grad():
        M.loss_fn(dataclasses.replace(base, remat="block"), params, b)
    assert len(calls) == out["none_calls"]

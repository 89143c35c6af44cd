"""The port's LM training half against the JAX package's, on the CPU, in
f32 (this file: the gradients of the MoE, SSM, hybrid and enc-dec
families; the dense decoders, AdamW and accumulation are in
``test_torch_lm_train.py``, whole steps of these families and remat in
``test_torch_lm_train_c.py``, the MoE families under capacity overflow and
whisper's conditioning in ``test_torch_lm_train_d.py``).

Tolerances are ``torch_lm_train_parity``'s: the loss within 1e-5 nats,
each leaf's gradient within 1e-3 of its max |g| (whisper 1e-2: its
reference gradients are ill-conditioned in f32, see ``COND``).
"""
import pytest

import torch_lm_train_parity as tp

ARCHS = ["olmoe-1b-7b", "qwen2-moe-a2.7b", "mamba2-1.3b", "jamba-1.5-large-398b",
         "whisper-small"]


@pytest.mark.parametrize("arch", ARCHS)
def test_grads_equal_reference(arch):
    assert tp.check_grads(arch) <= tp.grad_rel(arch)

"""The port's LM substrate against the JAX package's, one architecture
family at a time (this file: the dense decoders and the VLM; the MoE, SSM,
hybrid and enc-dec families are in ``test_torch_lm_models_b.py``).

For each architecture at its ``smoke()`` config in f32, with the reference's
``M.init`` weights carried across by ``convert.from_jax_params``:
``forward`` logits (and the forward-only ``loss_fn``), and 8 steps of
``decode_step`` logits and caches, equal to the reference's within 1e-4 x
max |logit|; the port's decode against its own forward likewise.  For
every full config, the analytic and spec-tree parameter counts equal the
reference's as integers, nothing allocated.
"""
import pytest

import torch_lm_parity as parity

ARCHS = ["llama3.2-3b", "granite-20b", "starcoder2-15b", "minicpm3-4b", "internvl2-26b"]


@pytest.mark.parametrize("arch", ARCHS)
def test_forward_equals_reference(arch):
    parity.check_forward(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps_and_caches_equal_reference(arch):
    parity.check_decode(arch)


@pytest.mark.parametrize("arch", ARCHS)
def test_full_config_param_counts_equal_reference(arch):
    parity.check_n_params(arch)

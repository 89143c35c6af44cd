"""The sharded step on 4 gloo ranks equals the one-device step: olmoe-1b-7b
(MoE), mamba2-1.3b (SSM) and internvl2-26b (VLM) smoke configs (``test_torch_shard_step.py``
has the setting).  The MoE dispatch (``topk``, the one-hot running count of
the capacity slots, the scatter, the gather and ``index_add_`` combine)
runs on replicated tokens in each MoE layer, as one device runs it: its
slots are global.  The SSM's causal conv and chunked ``cumsum``/segment
sums run sharded.
"""
import pytest

import torch_shard_parity as sp

ARCHS = ("olmoe-1b-7b", "mamba2-1.3b", "internvl2-26b")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return sp.Run(tmp_path_factory.mktemp("shard_step_b"), ARCHS).finish()


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_one_device(run, arch):
    assert run.check(arch) <= sp.tp.grad_rel(arch)


def test_only_the_moe_dispatch_was_replicated(run):
    """Per MoE layer and pass: 2 layers, 2 microbatches twice (the gradients,
    then the train step), the prefill and two decode steps."""
    reps = run.replications()
    assert set(reps) == {"moe.topk", "moe.dispatch", "moe.combine"}
    assert len(set(reps.values())) == 1 and reps["moe.topk"] > 0

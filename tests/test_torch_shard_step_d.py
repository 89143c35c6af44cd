"""The sharded step on the multi-pod layout: 8 gloo ranks on a 2×2×2
``("pod", "data", "model")`` mesh equal the one-device step for
olmoe-1b-7b's smoke config (MoE).

Under the full config's layout (``sharding.step_layout`` of a mesh with a
``"pod"`` axis) the batch is sharded over ``("pod", "data")``, the FSDP
rule shards each ``embed`` dim over those two mesh dims, and the experts
and ``ffn`` dims over ``model``.  The train step at accum 2 splits a batch
dim sharded over two mesh dims (gathered first, ``microbatch.reshape``);
the MoE dispatch runs on replicated tokens.  ``torch_shard_parity`` holds
the gradients, prefill, decode (cache over ``("pod", "data")``) and train
step to the one-device step's bounds.
"""
import pytest

import torch_shard_parity as sp

ARCHS = ("olmoe-1b-7b",)
MESH = (2, 2, 2)


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return sp.Run(tmp_path_factory.mktemp("shard_step_d"), ARCHS, mesh=MESH).finish()


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_one_device_on_two_pods(run, arch):
    assert run.check(arch) <= sp.tp.grad_rel(arch)


def test_only_the_batch_split_and_the_moe_dispatch_were_replicated(run):
    reps = run.replications()
    assert set(reps) == {"microbatch.reshape", "moe.topk", "moe.dispatch", "moe.combine"}

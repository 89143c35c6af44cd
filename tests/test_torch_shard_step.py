"""The sharded step on 4 gloo ranks equals the one-device step: llama3.2-3b
(dense, GQA), minicpm3-4b (MLA) and whisper-small (encoder-decoder) smoke
configs.

Each rank (``torch_shard_rank.py``) holds the reference's weights as
DTensors on a 2×2 ``("data", "model")`` mesh under the dry run's layout
for the full config (``sharding.step_layout``: ``default_rules`` with
FSDP, ``batch_spec`` ``("data",)``, ``act_spec`` ``(("data",), None,
None)``) and runs a train step at accum 2, a prefill and two decode steps
with ``cache_shardings``; ``torch_shard_parity`` holds every result to the
one-device step's (bounds there) and each gradient's placements to its
parameter's.  whisper-small is under 1e9 parameters, so the dry run lays it
out as pure data parallelism: every parameter replicated, the batch over
both mesh axes.  Its microbatch reshape splits a dim sharded over two mesh
dims, which DTensor's view has no strategy for: the batch is gathered first
(``microbatch.reshape``), the only redistribution these configs need.
"""
import pytest

import torch_shard_parity as sp

ARCHS = ("llama3.2-3b", "minicpm3-4b", "whisper-small")


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    return sp.Run(tmp_path_factory.mktemp("shard_step"), ARCHS).finish()


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_one_device(run, arch):
    assert run.check(arch) <= sp.tp.grad_rel(arch)


def test_only_the_doubly_sharded_batch_reshape_was_replicated(run):
    reps = run.replications()
    assert set(reps) == {"microbatch.reshape"} and reps["microbatch.reshape"] > 0

"""A step the full-config sweep found failing on the production meshes
(jamba's in ``test_torch_dryrun_cells_{e,f}.py``), at the cell's policy: a
MoE ``train_4k`` step.  The routed tokens' gradient, flattened from a batch
and sequence sharded over two mesh dims, reached the replicated dispatch as
a strided shard, which DTensor gathers only from real data; on two pods the
forward's tokens, whose batch is sharded over ``pod`` and ``data``, did the
same.  Run on olmoe-1b-7b's smoke config with the cell's microbatch of 16
rows (256 at accum 16), two of them: the cell's 16 take 62 and 113 s here."""
import dataclasses

import pytest

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun


@pytest.mark.parametrize("mesh", ["single", "multi"])
def test_moe_train_step_on_the_production_mesh(mesh, monkeypatch):
    monkeypatch.delenv("REPRO_ZERO1", raising=False)
    cell = dryrun.plan("olmoe-1b-7b", "train_4k", mesh)
    assert (cell.shape.global_batch, cell.accum) == (256, 16)
    smoke = dataclasses.replace(dryrun.on_model(cell, get_config("olmoe-1b-7b", smoke=True)),
                                shape=ShapeConfig("train_4k", 4096, 32, "train"), accum=2)
    run = dryrun.dry_run(smoke)
    # a call a layer a microbatch, in the forward and in its recompute
    # (block remat); the batch gathered once for its split, whose 2
    # microbatches do not divide over the data ranks (16, 32)
    calls = 2 * 2 * smoke.cfg.n_layers
    assert run.replications == {"moe.topk": calls, "moe.dispatch": calls, "moe.combine": calls,
                                "microbatch.reshape": 1}
    rec = run.record
    assert rec["world"] == cell.world and rec["loops"]["accum"] == 2
    assert rec["memory"]["argument_bytes"] == dryrun.argument_bytes(smoke)["total"]
    assert rec["cost"]["flops_per_device"] > 0 and rec["collectives"]["count"] > 0
    assert run.unread == set()

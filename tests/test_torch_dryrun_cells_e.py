"""jamba's train step on two pods (``train_4k`` on 2×16×16): the gradient
of its Mamba sublayers' output came back with the sequence sharded over
``data`` and ``model``, and the view into SSD chunks before it could not
split that layout over the 256 ranks (DTensor computed a wrong local
shape); the output now takes its gradient in its forward's placements
(``dtensor.pinned``).  Run on one attention and one Mamba sublayer at full
width, with one microbatch of the cell's 16 rows (its 16 microbatches
repeat it)."""
import dataclasses

from repro_torch.configs.base import ShapeConfig
from repro_torch.launch import dryrun


def test_jamba_train_step_on_two_pods(monkeypatch):
    monkeypatch.delenv("REPRO_ZERO1", raising=False)
    cell = dryrun.plan("jamba-1.5-large-398b", "train_4k", "multi",
                       overrides={"n_layers": 2, "attn_every": 2})
    assert (cell.world, cell.shape.global_batch // cell.accum) == (512, 16)
    cell = dataclasses.replace(cell, shape=ShapeConfig("train_4k", 4096, 16, "train"), accum=1)
    run = dryrun.dry_run(cell)
    assert run.replications["mamba2.group_heads"] > 0
    rec = run.record
    assert rec["memory"]["argument_bytes"] == dryrun.argument_bytes(cell)["total"]
    assert rec["cost"]["flops_per_device"] > 0 and rec["collectives"]["count"] > 0
    assert run.unread == set()

"""The train step of a ``train_4k`` dry-run cell on the 16×16 fake world
at its policy (accum 8, batch 256 × 4096), run on llama3.2-3b's smoke
config: its microbatch split over 16 data ranks, which DTensor cannot keep
sharded (8 microbatches), gathers the batch first, and the step runs to its
end (``dryrun.on_model``); and a MoE prefill cell's token chunks, which do
not split over the data ranks either."""
import dataclasses

from repro_torch.configs.registry import get_config
from repro_torch.launch import dryrun


def test_smoke_train_step_at_accum_8_on_the_production_mesh(monkeypatch):
    monkeypatch.delenv("REPRO_ZERO1", raising=False)
    cell = dryrun.plan("llama3.2-3b", "train_4k", "single")
    assert (cell.accum, cell.world, cell.shape.global_batch) == (8, 256, 256)
    smoke = dryrun.on_model(cell, get_config("llama3.2-3b", smoke=True))
    assert dataclasses.replace(smoke, cfg=cell.cfg) == cell
    run = dryrun.dry_run(smoke)
    # the tokens gathered once for their split into 8 microbatches
    assert run.replications == {"microbatch.reshape": 1}
    rec = run.record
    assert rec["loops"] == {"accum": 8, "layer_scan_trips": 2, "attn_chunk": 1024}
    assert rec["cost"]["flops_per_device"] > 0 and rec["collectives"]["count"] > 0
    assert rec["memory"]["argument_bytes"] == dryrun.argument_bytes(smoke)["total"]
    assert run.unread == set()


def test_moe_token_chunks_on_the_production_mesh(monkeypatch):
    """A MoE ``prefill_32k`` cell's policy chunks its tokens 131,072 at a
    time (8192 · world/16): 32 × 32,768 tokens make 8 chunks, which do not
    split over 16 data ranks, so each layer gathers the tokens first
    (``moe.token_chunk``) before its replicated dispatch, chunk by chunk."""
    monkeypatch.delenv("REPRO_ZERO1", raising=False)
    cell = dryrun.plan("olmoe-1b-7b", "prefill_32k", "single")
    assert cell.cfg.moe.token_chunk == 8192 * 16
    run = dryrun.dry_run(dryrun.on_model(cell, get_config("olmoe-1b-7b", smoke=True)))
    layers = get_config("olmoe-1b-7b", smoke=True).n_layers
    assert run.replications == {"moe.token_chunk": layers, "moe.topk": 8 * layers,
                                "moe.dispatch": 8 * layers, "moe.combine": 8 * layers}

"""A step the full-config sweep found failing on the production mesh, at
the cell's policy: jamba's Mamba sublayers at full width (one super-block),
whose 128 heads, sharded 16 ways, do not split into its 8 groups, so the
heads are gathered first (``mamba2.group_heads``)."""
from repro_torch.launch import dryrun


def test_jamba_mamba_heads_group_on_the_production_mesh(monkeypatch):
    monkeypatch.delenv("REPRO_ZERO1", raising=False)
    cell = dryrun.plan("jamba-1.5-large-398b", "prefill_32k", "single",
                       overrides={"n_layers": 8})
    s = cell.cfg.ssm
    heads = s.expand * cell.cfg.d_model // s.head_dim
    assert (heads, s.n_groups, cell.mesh.shape["model"]) == (128, 8, 16)
    run = dryrun.dry_run(cell)
    # 7 Mamba sublayers, two grouped tensors each sharded over the heads
    assert run.replications["mamba2.group_heads"] == 14
    assert run.record["memory"]["argument_bytes"] == dryrun.argument_bytes(cell)["total"]
    assert run.record["collectives"]["count"] > 0

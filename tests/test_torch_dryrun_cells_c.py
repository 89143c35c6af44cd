"""Whole dry-run cells at full config (``torch_dryrun_cells``): olmoe-1b-7b
(MoE) ``decode_32k`` on two pods (512 ranks), its dispatch on replicated
tokens once a layer, and mamba2-1.3b ``long_500k`` (whose decode step does
not read ``pos``).  The record's keys are the reference's, its cell, policy
and argument bytes equal; collectives and cost are printed beside the
reference's."""
import pytest

import torch_dryrun_cells as dc
import torch_dryrun_ref

CELLS = [("olmoe-1b-7b", "decode_32k", "multi"), ("mamba2-1.3b", "long_500k", "single")]


@pytest.fixture(scope="module")
def ref():
    return torch_dryrun_ref.records(CELLS)


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_cell_record_matches_reference(ref, cell, monkeypatch):
    run = dc.check(cell, ref, monkeypatch)
    if cell[0] == "olmoe-1b-7b":
        assert run.replications == {"moe.topk": 16, "moe.dispatch": 16, "moe.combine": 16}
        assert run.record["world"] == 512

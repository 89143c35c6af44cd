"""Whole dry-run cells at full config (``torch_dryrun_cells``; two more in
``test_torch_dryrun_cells_c.py``): llama3.2-3b ``decode_32k`` on the single
pod (argument bytes 1,986,743,716) and whisper-small ``decode_32k`` (whose
step reads neither its encoder nor the cross K and V projections: the
arguments the reference's compiled step drops).  The record's keys are the
reference's, its cell, policy and argument bytes equal; collectives and
cost are printed beside the reference's."""
import pytest

import torch_dryrun_cells as dc
import torch_dryrun_ref

CELLS = [("llama3.2-3b", "decode_32k", "single"), ("whisper-small", "decode_32k", "single")]


@pytest.fixture(scope="module")
def ref():
    return torch_dryrun_ref.records(CELLS)


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_cell_record_matches_reference(ref, cell, monkeypatch):
    dc.check(cell, ref, monkeypatch)

"""Argument bytes a device equal to the reference's dry run, exactly, for
the hybrid's ``train_4k`` cell on the single pod (jamba-1.5-large-398b:
over 50e9 parameters, so bf16 AdamW state, accum 16, MoE token chunks of
131,072), in a file of its own: the reference compiles it in about 50 s
(``torch_dryrun_args``)."""
import pytest

import torch_dryrun_args as da

CELLS = [("jamba-1.5-large-398b", "train_4k", "single")]
ref = da.fixture(CELLS)


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_argument_bytes_equal_reference(ref, cell, monkeypatch):
    da.check(ref, cell, monkeypatch)

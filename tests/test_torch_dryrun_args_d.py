"""Argument bytes a device equal to the reference's dry run, exactly, for
the ``train_4k`` cell on the single pod of the dense, MLA and MoE families
(the others: ``test_torch_dryrun_args_e.py``, ``_f.py``): parameters, AdamW
state and the batch under the cell's policy (``torch_dryrun_args``).
llama3.2-3b: 538,739,588.
"""
import pytest

import torch_dryrun_args as da

CELLS = [(da.FAMILY_ARCHS[f], "train_4k", "single") for f in ("dense", "mla", "moe")]
ref = da.fixture(CELLS)


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_argument_bytes_equal_reference(ref, cell, monkeypatch):
    da.check(ref, cell, monkeypatch)

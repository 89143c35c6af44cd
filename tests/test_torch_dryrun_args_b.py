"""Argument bytes a device equal to the reference's dry run, exactly, for
every ``decode_32k`` cell on the two-pod 2×16×16 mesh (``torch_dryrun_args``)."""
import pytest

import torch_dryrun_args as da
from repro_torch.configs.registry import all_archs

CELLS = [(arch, "decode_32k", "multi") for arch in all_archs()]
ref = da.fixture(CELLS)


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_argument_bytes_equal_reference(ref, cell, monkeypatch):
    da.check(ref, cell, monkeypatch)

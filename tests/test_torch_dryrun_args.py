"""Argument bytes a device equal to the reference's dry run, exactly, for
every ``decode_32k`` cell on the single-pod 16×16 mesh (``torch_dryrun_args``).

llama3.2-3b: 107,695,488 B of parameters, 1,879,048,192 of cache, 32 of
tokens and 4 of ``pos`` make the reference's 1,986,743,716.  whisper-small's
decode step reads neither its encoder nor the cross attention's K and V
projections, and an SSM's decode step not ``pos``: XLA drops them from the
compiled step, and the port does not count them
(``dryrun.unread_arguments``).
"""
import pytest

import torch_dryrun_args as da
from repro_torch.configs.registry import all_archs
from repro_torch.launch import dryrun

CELLS = [(arch, "decode_32k", "single") for arch in all_archs()]
ref = da.fixture(CELLS)


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_argument_bytes_equal_reference(ref, cell, monkeypatch):
    da.check(ref, cell, monkeypatch)


def test_llama_decode_parts():
    assert dryrun.argument_bytes(dryrun.plan("llama3.2-3b", "decode_32k", "single")) == {
        "params": 107_695_488, "cache": 1_879_048_192, "tokens": 32, "pos": 4,
        "total": 1_986_743_716}

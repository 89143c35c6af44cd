"""Argument bytes a device equal to the reference's dry run, exactly
(``torch_dryrun_args``): every ``long_500k`` cell on both meshes (the
sub-quadratic models), one ``prefill_32k`` cell on the single pod for each
family, and a full-attention model's ``long_500k``, which both packages
skip."""
import pytest

import torch_dryrun_args as da
from repro_torch.configs.base import shapes_for
from repro_torch.configs.registry import all_archs, get_config
from repro_torch.launch import dryrun

LONG = [(arch, "long_500k", mesh) for arch in all_archs()
        if "long_500k" in shapes_for(get_config(arch)) for mesh in ("single", "multi")]
PREFILL = [(arch, "prefill_32k", "single") for arch in da.FAMILY_ARCHS.values()]
CELLS = LONG + PREFILL
ref = da.fixture(CELLS)


def test_the_long_cells_are_the_sub_quadratic_models():
    assert {c[0] for c in LONG} == {"mamba2-1.3b", "jamba-1.5-large-398b"}


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_argument_bytes_equal_reference(ref, cell, monkeypatch):
    da.check(ref, cell, monkeypatch)


def test_full_attention_long_cell_is_skipped():
    assert dryrun.plan("llama3.2-3b", "long_500k", "single") is None
    assert dryrun.run_cell("llama3.2-3b", "long_500k", "single") == {
        "skipped": "llama3.2-3b is full-attention; long_500k not lowered"}

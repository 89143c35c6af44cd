"""Argument bytes a device equal to the reference's dry run, exactly, for
the ``train_4k`` cell on the single pod of the SSM, encoder-decoder and VLM
families (``torch_dryrun_args``; whisper-small is under 1e9 parameters:
replicated, the batch over both mesh axes, accum 1); and two cells under
``REPRO_ZERO1``."""
import pytest

import torch_dryrun_args as da

CELLS = [(da.FAMILY_ARCHS[f], "train_4k", "single") for f in ("ssm", "encdec", "vlm")]
ref = da.fixture(CELLS)


@pytest.mark.parametrize("cell", CELLS, ids="/".join)
def test_argument_bytes_equal_reference(ref, cell, monkeypatch):
    da.check(ref, cell, monkeypatch)


#: under ``REPRO_ZERO1`` the parameters are TP-only and the AdamW state keeps
#: the FSDP rules (``sharding.step_layout(zero1=True)``)
ZERO1_CELLS = [("llama3.2-3b", "train_4k", "single"), ("qwen2-moe-a2.7b", "decode_32k", "multi")]
ref_zero1 = da.fixture(ZERO1_CELLS, zero1=True)


@pytest.mark.parametrize("cell", ZERO1_CELLS, ids="/".join)
def test_argument_bytes_equal_reference_under_zero1(ref_zero1, cell, monkeypatch):
    da.check(ref_zero1, cell, monkeypatch, zero1=True)

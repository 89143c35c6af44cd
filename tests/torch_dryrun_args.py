"""The port's argument bytes against the reference's, cell by cell
(``test_torch_dryrun_args*.py``): ``repro_torch.launch.dryrun.argument_bytes``
from the shapes alone (no step runs) equal to ``memory.argument_bytes`` of
the reference's record (XLA's ``memory_analysis``), and the cell's policy
(world, parameter count, ``loops``) equal to the reference's."""
import pytest

import torch_dryrun_ref
from repro_torch.launch import dryrun

FAMILY_ARCHS = {"dense": "llama3.2-3b", "mla": "minicpm3-4b", "moe": "olmoe-1b-7b",
                "ssm": "mamba2-1.3b", "hybrid": "jamba-1.5-large-398b",
                "encdec": "whisper-small", "vlm": "internvl2-26b"}


def fixture(cells, zero1=False):
    """A module fixture: the reference's records of ``cells``."""
    @pytest.fixture(scope="module")
    def ref():
        return torch_dryrun_ref.records(cells, zero1)

    return ref


def check(ref, cell, monkeypatch, zero1=False):
    if zero1:
        monkeypatch.setenv("REPRO_ZERO1", "1")
    else:
        monkeypatch.delenv("REPRO_ZERO1", raising=False)
    want = ref[cell]
    c = dryrun.plan(*cell)
    got = dryrun.argument_bytes(c)
    assert got["total"] == want["memory"]["argument_bytes"], (cell, got)
    assert (c.world, c.n_params, c.shape.kind, c.shape.seq_len, c.shape.global_batch) == \
        (want["world"], want["n_params"], want["kind"], want["seq_len"], want["global_batch"])
    assert {"accum": c.accum, "layer_scan_trips": dryrun.layer_scan_trips(c.cfg),
            "attn_chunk": c.attn_chunk} == want["loops"]

"""The dry run's FLOPs, and its launcher.

* On a fake world of 4 (a 2×2 ``("data", "model")`` mesh), llama3.2-3b's
  smoke config under its full config's layout (FSDP over ``data``, heads,
  ``ffn`` and vocab over ``model``, the batch over ``data``) shards every
  matmul 4 ways: ``flops_per_device × 4`` equals
  ``torch.utils.flop_counter.FlopCounterMode``'s count of the same step on
  plain tensors, for a train step (accum 2, chunked attention), a prefill
  and a decode step.
* ``python -m repro_torch.launch.dryrun`` writes the cell's record, with
  the reference's keys, into the directory ``REPRO_TORCH_DRYRUN_DIR`` names
  (here ``tmp_path``) and nowhere else; the sweep skips cells whose record
  exists.
"""
import dataclasses
import json

import pytest
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import ShapeConfig
from repro_torch.configs.registry import get_config
from repro_torch.distributed import sharding as shd
from repro_torch.launch import dryrun
from repro_torch.launch import mesh as mesh_mod

STEPS = {"train": ("train_4k", ShapeConfig("train", 64, 8, "train"), 2, 32),
         "prefill": ("prefill_32k", ShapeConfig("prefill", 64, 4, "prefill"), 1, 32),
         "decode": ("decode_32k", ShapeConfig("decode", 64, 4, "decode"), 1, None)}


def small_cell(kind):
    name, shape, accum, chunk = STEPS[kind]
    m = mesh_mod.debug_shape(2, 2)
    cell = dryrun.on_model(dryrun.plan("llama3.2-3b", name, "single"),
                           get_config("llama3.2-3b", smoke=True))
    return dataclasses.replace(cell, mesh=m, layout=shd.step_layout(cell.n_params, m),
                               shape=shape, accum=accum, attn_chunk=chunk)


@pytest.mark.parametrize("kind", sorted(STEPS))
def test_flops_per_device_times_world_equal_unsharded_count(kind, monkeypatch):
    monkeypatch.delenv("REPRO_ZERO1", raising=False)
    cell = small_cell(kind)
    run = dryrun.dry_run(cell)
    assert run.replications == {}      # every op sharded, none on replicated copies
    with FakeTensorMode():
        fn, made = dryrun.step_call(cell)
        with FlopCounterMode(display=False) as counter:
            fn(*made.values())
    want = counter.get_total_flops()
    assert want > 0
    assert run.record["cost"]["flops_per_device"] * 4 == want


def test_main_writes_the_record_under_its_results_dir(tmp_path, monkeypatch, capsys):
    monkeypatch.delenv("REPRO_ZERO1", raising=False)
    monkeypatch.setenv("REPRO_TORCH_DRYRUN_DIR", str(tmp_path))
    dryrun.main(["--arch", "whisper-small", "--shape", "decode_32k", "--mesh", "single"])
    out = tmp_path / "whisper-small__decode_32k__single.json"
    assert sorted(p.name for p in tmp_path.iterdir()) == [out.name]
    rec = json.loads(out.read_text())
    assert set(rec) == {"arch", "shape", "mesh", "world", "n_params", "kind", "seq_len",
                        "global_batch", "memory", "cost", "collectives", "timing",
                        "overrides", "loops"}
    assert rec["memory"]["argument_bytes"] == 890_297_892
    assert "collectives:" in capsys.readouterr().out
    # a sweep over existing records runs nothing
    for arch in ("whisper-small",):
        for shape in ("train_4k", "prefill_32k"):
            (tmp_path / f"{arch}__{shape}__single.json").write_text("{}")
    monkeypatch.setattr(dryrun, "all_archs", lambda: ["whisper-small"])
    dryrun.main(["--sweep"])
    assert capsys.readouterr().out.count("SKIP") == 3

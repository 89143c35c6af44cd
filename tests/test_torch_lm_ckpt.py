"""The port's checkpoint manager (``repro_torch.checkpoint.manager``) and
training launcher (``repro_torch.launch.train``) against the JAX
package's, on the CPU.

* The manager's own contract, as ``tests/test_checkpoint_train.py`` has it
  for the reference: round trip with bf16 leaves, retention and the latest
  step, a crash mid-save left as a stale ``.tmp`` (ignored, then removed),
  a shape mismatch raising ``ValueError``; and the port's own: a ``meta``
  template, a cast to the template's dtype, CUDA by default.
* The format is the reference's: a checkpoint of a model's parameters and
  AdamW state written by either package restores in the other byte for
  byte (bf16 leaves included), under the same npz keys and dtypes.
* The launchers: a directory written by the reference's ``launch/train
  --smoke --steps 6 --ckpt-every 2`` resumed by the port's ``--resume
  --device cpu`` runs on to the reference's own continuation of a copy of
  it, and the reverse; the checkpoints both write at step 6 agree within
  the bounds below.
"""
import dataclasses
import json
import shutil
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

import torch_lm_parity as parity
import torch_lm_train_parity as tp
from repro.checkpoint import manager as ref_manager
from repro.launch import train as ref_train
from repro.models import steps as ref_steps
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint.manager import CheckpointManager, flatten
from repro_torch.configs import registry
from repro_torch.launch import train
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models.layers import leaves, map_tree
from repro_torch.optim import adamw

LAUNCH = ["--smoke", "--batch", "4", "--seq", "32", "--ckpt-every", "2"]
#: a resumed run's checkpoint two steps on: each parameter within 2·lr a
#: step of the other package's (Adam's sign where |g| is rounding noise),
#: the moments within GRAD_REL of each leaf's max
STEPS_ON = 2


def _bits(a) -> np.ndarray:
    """An array's bytes as unsigned integers, bf16 included."""
    if isinstance(a, torch.Tensor):
        a = a.detach()
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16)
        return a.numpy()
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype == ml_dtypes.bfloat16 else a


def test_save_restore_roundtrip(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    state = {"w": torch.arange(12.0).reshape(3, 4), "b": torch.ones(5, dtype=torch.bfloat16) / 3,
             "n": [torch.tensor(7, dtype=torch.int32)]}
    mgr.save(3, state, extra={"data_step": 42})
    restored, extra = mgr.restore(state, device="cpu")
    assert extra["data_step"] == 42
    for k, v in flatten(state).items():
        got = flatten(restored)[k]
        assert got.dtype == v.dtype and torch.equal(got, v), k
    manifest = json.loads((tmp_path / "step_0000000003" / "manifest.json").read_text())
    assert manifest["keys"] == ["['b']", "['n']/[0]", "['w']"]
    assert manifest["dtypes"] == {"['b']": "bfloat16", "['n']/[0]": "int32", "['w']": "float32"}
    assert manifest["format"] == 1 and manifest["step"] == 3


def test_retention_and_latest(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=2)
    for s in (1, 2, 3, 4):
        mgr.save(s, {"x": torch.tensor([s])})
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_crash_mid_save_is_atomic(tmp_path):
    mgr = CheckpointManager(tmp_path, keep=3)
    mgr.save(1, {"x": torch.tensor([1.0])})
    tmp = tmp_path / "step_0000000002.tmp"    # a crash: a stale tmp dir left behind
    tmp.mkdir()
    (tmp / "garbage").write_text("boom")
    assert mgr.latest_step() == 1
    mgr.save(3, {"x": torch.tensor([3.0])})   # gc removes the stale tmp
    assert not tmp.exists()
    assert mgr.all_steps() == [1, 3]
    with pytest.raises(FileNotFoundError):
        CheckpointManager(tmp_path / "empty").restore({"x": torch.zeros(1)}, device="cpu")


def test_shape_mismatch_fails_loudly(tmp_path):
    mgr = CheckpointManager(tmp_path)
    mgr.save(1, {"x": torch.ones(3)})
    with pytest.raises(ValueError):
        mgr.restore({"x": torch.empty(4, device="meta")}, device="cpu")


def test_restore_onto_meta_template_casts_and_needs_cuda(tmp_path, monkeypatch):
    """A ``meta`` template (``M.abstract``) is filled from disk; a leaf is
    cast to the template's dtype; without ``device`` the restore asks for
    CUDA and raises where there is none."""
    cfg = registry.get_config("llama3.2-3b", smoke=True)    # f32 on disk
    params = M.init(cfg, 0, "cpu").params()
    mgr = CheckpointManager(tmp_path)
    mgr.save(5, {"params": params})
    template = {"params": M.abstract(dataclasses.replace(cfg, param_dtype="bfloat16"))}
    got, _ = mgr.restore(template, device="cpu")
    for path, t in leaves(got["params"]):
        assert t.dtype == torch.bfloat16 and t.device.type == "cpu"
        assert torch.equal(t, dict(leaves(params))[path].to(torch.bfloat16))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mgr.restore(template)


def _model_state(dtype: str):
    """The reference's llama smoke weights in ``dtype`` with one AdamW step
    taken, as a JAX tree and as the port's."""
    ref_cfg, params, cfg, model = tp.models("llama3.2-3b", param_dtype=dtype)
    opt_cfg = adamw.AdamWConfig(lr=1e-2, warmup_steps=1)
    b = tp.batch(cfg)
    step = jax.jit(ref_steps.make_train_step(ref_cfg, tp.ref_opt(opt_cfg)))
    params, opt, _ = step(params, ref_adamw.init(params, tp.ref_opt(opt_cfg)), b)
    ref_state = {"params": params, "opt": opt}
    port_state = {"params": convert.tree_from_jax(parity.np_tree(params), "cpu"),
                  "opt": adamw.AdamWState(
                      step=torch.tensor(int(opt.step), dtype=torch.int32),
                      m=convert.tree_from_jax(parity.np_tree(opt.m), "cpu"),
                      v=convert.tree_from_jax(parity.np_tree(opt.v), "cpu"))}
    return ref_state, port_state


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_checkpoints_cross_packages_byte_for_byte(tmp_path, dtype):
    ref_state, port_state = _model_state(dtype)
    CheckpointManager(tmp_path / "port").save(7, port_state, extra={"step": 7})
    ref_manager.CheckpointManager(tmp_path / "ref").save(7, ref_state, extra={"step": 7})
    manifests = [json.loads((tmp_path / d / "step_0000000007" / "manifest.json").read_text())
                 for d in ("port", "ref")]
    for key in ("keys", "dtypes", "extra", "format", "step"):
        assert manifests[0][key] == manifests[1][key], key
    assert "['opt']/.m/['embed']" in manifests[0]["keys"]
    assert manifests[0]["dtypes"]["['opt']/.step"] == "int32"
    assert manifests[0]["dtypes"]["['params']/['blocks']/['attn']/['wq']"] == dtype

    # the reference reads the port's checkpoint
    abstract = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), ref_state)
    got_ref, extra = ref_manager.CheckpointManager(tmp_path / "port").restore(abstract)
    assert extra == {"step": 7}
    # the port reads the reference's, onto a meta template of its own
    template = map_tree(lambda t: torch.empty(t.shape, dtype=t.dtype, device="meta"),
                        port_state["params"])
    template = {"params": template, "opt": adamw.init(template, adamw.AdamWConfig())}
    got_port, extra = CheckpointManager(tmp_path / "ref").restore(template, device="cpu")
    assert extra == {"step": 7}
    want = flatten(port_state)
    ref_flat = {"/".join(str(k) for k in path): leaf
                for path, leaf in jax.tree_util.tree_flatten_with_path(got_ref)[0]}
    assert set(ref_flat) == set(want) == set(flatten(got_port))
    for key, t in want.items():
        assert np.array_equal(_bits(ref_flat[key]), _bits(t)), key
        assert flatten(got_port)[key].dtype == t.dtype
        assert np.array_equal(_bits(flatten(got_port)[key]), _bits(t)), key


def _run_reference(monkeypatch, *argv):
    monkeypatch.setattr(sys, "argv", ["train", *LAUNCH, *argv])
    ref_train.main()


def _close_checkpoints(dir_a, dir_b, step: int, lr: float):
    """The checkpoints at ``step`` in two directories, read by the port."""
    mgrs = [CheckpointManager(d) for d in (dir_a, dir_b)]
    manifest = json.loads((dir_a / f"step_{step:010d}" / "manifest.json").read_text())
    cfg = registry.get_config("llama3.2-3b", smoke=True)
    abstract = M.abstract(cfg)
    template = {"params": abstract, "opt": adamw.init(abstract, adamw.AdamWConfig())}
    (a, ea), (b, eb) = (m.restore(template, step, device="cpu") for m in mgrs)
    assert ea == eb == manifest["extra"]
    assert int(a["opt"].step) == int(b["opt"].step) == step + 1
    for path, t in leaves(a["params"]):
        d = float((t - dict(leaves(b["params"]))[path]).abs().max())
        assert d <= 2 * lr * STEPS_ON * (1 + 1e-4), (path, d)
    for name in ("m", "v"):
        want = dict(leaves(getattr(b["opt"], name)))
        for path, t in leaves(getattr(a["opt"], name)):
            parity.close(t.numpy(), want[path].numpy(), tp.GRAD_REL, f"{name} {path}")
    return ea


def test_reference_launcher_dir_resumes_in_port(tmp_path, monkeypatch, capsys):
    ref_dir, copy = tmp_path / "ref", tmp_path / "copy"
    _run_reference(monkeypatch, "--steps", "6", "--ckpt-dir", str(ref_dir))
    assert CheckpointManager(ref_dir).all_steps() == [2, 4]
    shutil.copytree(ref_dir, copy)
    capsys.readouterr()
    run = train.main([*LAUNCH, "--steps", "8", "--ckpt-dir", str(ref_dir), "--resume",
                      "--device", "cpu"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and run.start == 5
    assert [r.step for r in run.records] == [5, 6, 7]
    _run_reference(monkeypatch, "--steps", "8", "--ckpt-dir", str(copy), "--resume")
    ref_out = capsys.readouterr().out
    assert "resumed from step 4" in ref_out
    want_loss = float(ref_out.split("step     7 loss")[1].split()[0])
    assert abs(run.records[-1].loss - want_loss) <= 1e-4   # printed to 4 decimals
    extra = _close_checkpoints(ref_dir, copy, 6, run.opt_cfg.lr)
    assert extra == {"step": 6, "pipeline": {"seed": 1, "step": 7}}


def test_port_launcher_dir_resumes_in_reference(tmp_path, monkeypatch, capsys):
    port_dir, copy = tmp_path / "port", tmp_path / "copy"
    first = train.main([*LAUNCH, "--steps", "6", "--ckpt-dir", str(port_dir), "--device", "cpu"])
    assert [r.step for r in first.records] == list(range(6))
    assert CheckpointManager(port_dir).all_steps() == [2, 4]
    shutil.copytree(port_dir, copy)
    _run_reference(monkeypatch, "--steps", "8", "--ckpt-dir", str(port_dir), "--resume")
    assert "resumed from step 4" in capsys.readouterr().out
    run = train.main([*LAUNCH, "--steps", "8", "--ckpt-dir", str(copy), "--resume",
                      "--device", "cpu"])
    _close_checkpoints(port_dir, copy, 6, run.opt_cfg.lr)

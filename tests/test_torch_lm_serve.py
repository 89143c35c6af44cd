"""The port's serving launcher (``repro_torch.launch.serve``) against the JAX
package's decode loop, on the CPU.

* Greedy generation by ``serve.generate`` equals a jitted JAX greedy loop over
  ``M.decode_step`` (the reference launcher's loop: prefill by stepping, then
  argmax) on the same weights and prompts, token for token, for six
  architectures at ``smoke()`` size in f32.
* The reference launcher's fault: its cache is f32 whatever the parameters'
  dtype, and a bf16 model's first decode step raises ``TypeError`` where it
  writes a KV cache (every family but ``ssm``).  The port's cache takes the
  parameters' dtype, and the same model at bf16 runs.  Its tokens are held
  to the f32 run's within the bf16 tolerance below.
* The launcher as a command imports nothing of JAX, and raises without CUDA
  unless ``--device cpu`` is given.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parity as parity
from repro.configs import registry as ref_registry
from repro.models import model as RM
from repro_torch.configs import registry
from repro_torch.launch import serve
from repro_torch.models import model as M
from repro_torch.models.layers import map_tree

ROOT = Path(__file__).resolve().parents[1]
B, P, G = 3, 6, 10

#: bf16 against f32, teacher-forced: each token the bf16 run chose scores
#: within this share of max |logit| of the f32 argmax on the same prefix,
#: and at least MIN_EXACT of them are that argmax.  Measured on these smoke
#: configs: 0.013 (mamba2) to 0.15 (olmoe), 89 % to 98 % exact.
BF16_TOL = 0.25
MIN_EXACT = 0.8


def reference_greedy(ref_cfg, params, prompts, gen, frames=None):
    """The reference launcher's loop, on the given weights and prompts."""
    Bn, Pn = prompts.shape
    cache = RM.init_cache(ref_cfg, Bn, Pn + gen, jnp.float32)
    if ref_cfg.family == "encdec":
        cache = RM.encode(ref_cfg, params, frames, cache)
    step = jax.jit(lambda p, c, t, pos: RM.decode_step(ref_cfg, p, c, t, pos))
    logits = None
    for t in range(Pn):
        logits, cache = step(params, cache, prompts[:, t:t + 1], jnp.asarray(t, jnp.int32))
    out = []
    tok = jnp.argmax(logits[:, -1:, : ref_cfg.vocab], axis=-1).astype(jnp.int32)
    for t in range(Pn, Pn + gen):
        out.append(np.asarray(tok)[:, 0])
        logits, cache = step(params, cache, tok, jnp.asarray(t, jnp.int32))
        tok = jnp.argmax(logits[:, -1:, : ref_cfg.vocab], axis=-1).astype(jnp.int32)
    return np.stack(out, axis=1)


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    prompts = rng.integers(0, cfg.vocab, (B, P)).astype(np.int32)
    frames = None
    if cfg.family == "encdec":
        frames = rng.standard_normal((B, cfg.enc_context, cfg.d_model)).astype(np.float32)
    return prompts, frames


@pytest.mark.parametrize("arch", ["llama3.2-3b", "minicpm3-4b", "mamba2-1.3b",
                                  "qwen2-moe-a2.7b", "jamba-1.5-large-398b", "whisper-small"])
def test_greedy_generation_equals_reference(arch):
    ref_cfg, params, cfg, model = parity.models(arch)
    prompts, frames = _inputs(cfg)
    want = reference_greedy(ref_cfg, params, prompts, G, frames)
    got = serve.generate(cfg, model.params(), torch.from_numpy(prompts), G,
                         frames=None if frames is None else torch.from_numpy(frames))
    np.testing.assert_array_equal(got.tokens.numpy(), want)
    assert got.prompt_len == P and got.tokens_per_s > 0


@pytest.mark.parametrize("arch", ["llama3.2-3b", "olmoe-1b-7b", "mamba2-1.3b"])
def test_bf16_serving_runs_where_the_reference_launcher_raises(arch):
    ref_cfg = dataclasses.replace(ref_registry.get_config(arch, smoke=True),
                                  param_dtype="bfloat16")
    params = RM.init(ref_cfg, parity.KEY)
    cache = RM.init_cache(ref_cfg, B, P + G, jnp.float32)   # serve.py's cache
    if ref_cfg.family != "ssm":   # a KV cache: the write of a bf16 K into f32 raises
        with pytest.raises(TypeError, match="dynamic_update_slice"):
            RM.decode_step(ref_cfg, params, cache, jnp.zeros((B, 1), jnp.int32),
                           jnp.asarray(0, jnp.int32))

    cfg = registry.get_config(arch, smoke=True)
    cfg16 = dataclasses.replace(cfg, param_dtype="bfloat16")
    p32 = M.init(cfg, 0, "cpu").params()
    p16 = map_tree(lambda a: a.to(torch.bfloat16), p32)
    prompts = torch.from_numpy(_inputs(cfg)[0]).long()
    run = serve.generate(cfg16, p16, prompts, G)
    assert run.tokens.shape == (B, G) and int(run.tokens.max()) < cfg.vocab
    # the f32 model, teacher-forced on the bf16 run's sequence
    seq = torch.cat([prompts, run.tokens], dim=1)
    with torch.no_grad():
        lf = M.forward(cfg, p32, {"tokens": seq})[..., : cfg.vocab]
    pred = lf[:, P - 1: P - 1 + G]
    chosen = pred.gather(-1, run.tokens[..., None])[..., 0]
    gap = (pred.max(dim=-1).values - chosen) / lf.abs().max()
    assert float(gap.max()) <= BF16_TOL
    assert float((gap == 0).float().mean()) >= MIN_EXACT


def test_sampling_at_a_temperature_follows_its_seed():
    cfg = registry.get_config("llama3.2-3b", smoke=True)
    params = M.init(cfg, 0, "cpu").params()
    prompts = torch.from_numpy(_inputs(cfg)[0]).long()
    runs = [serve.generate(cfg, params, prompts, G, temperature=1.0, seed=s).tokens
            for s in (3, 3, 4)]
    assert torch.equal(runs[0], runs[1]) and not torch.equal(runs[0], runs[2])
    assert int(runs[0].min()) >= 0 and int(runs[0].max()) < cfg.vocab
    greedy = serve.generate(cfg, params, prompts, G).tokens
    # the first token is the prompt's argmax at any temperature
    assert torch.equal(runs[0][:, 0], greedy[:, 0])


def test_serve_caches_in_the_parameters_dtype_and_raises_past_its_end():
    cfg = dataclasses.replace(registry.get_config("llama3.2-3b", smoke=True),
                              param_dtype="bfloat16")
    params = M.init(cfg, 0, "cpu").params()
    assert params["embed"].dtype == torch.bfloat16
    cache = M.init_cache(cfg, 1, 4, params["embed"].dtype, "cpu")
    assert cache["k"].dtype == torch.bfloat16
    tok = torch.zeros((1, 1), dtype=torch.long)
    M.decode_step(cfg, params, cache, tok, 3)
    with pytest.raises(IndexError):
        M.decode_step(cfg, params, cache, tok, 4)


def test_launcher_runs_without_jax_and_needs_a_device(monkeypatch):
    code = (
        "import json, runpy, sys\n"
        "sys.argv = ['serve', '--arch', 'whisper-small', '--smoke', '--device', 'cpu',"
        " '--gen', '4', '--prompt-len', '4']\n"
        "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
        "sys.argv = ['serve', '--smoke', '--device', 'cpu', '--gen', '4']\n"
        "runpy.run_module('repro_torch.launch.serve', run_name='__main__')\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'repro'))\n"
        "print(json.dumps(bad))\n"
    )
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          env=env, cwd=ROOT, timeout=120)
    assert done.returncode == 0, done.stderr[-3000:]
    lines = done.stdout.strip().splitlines()
    assert "arch=whisper-smoke generated (4, 4) tokens" in done.stdout
    assert "arch=llama3.2-3b-smoke generated (4, 4) tokens" in done.stdout
    assert json.loads(lines[-1]) == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--smoke"])

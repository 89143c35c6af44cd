"""Shared checks of the port's LM substrate (``repro_torch.models``) against
the JAX package's (``repro.models``), on the CPU, in f32.

The weights are the reference's ``M.init`` at a fixed key, carried across by
``convert.from_jax_params``; the inputs are drawn with numpy from a seed.
The JAX side is ``jax.jit``-ed.  Used by ``test_torch_lm_models*.py``.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from repro.configs import registry as ref_registry
from repro.models import model as RM
from repro_torch.configs import registry
from repro_torch.models import convert
from repro_torch.models import model as M
from repro_torch.models.layers import leaves

KEY = jax.random.PRNGKey(0)
B, T = 2, 8
#: f32 tolerance, as a share of the largest |logit| (or |cache value|)
REL = 1e-4


def np_tree(tree):
    return jax.tree.map(lambda a: np.asarray(a), tree)


def models(arch: str):
    """``(reference config, its params, port config, port model)``."""
    ref_cfg = ref_registry.get_config(arch, smoke=True)
    cfg = registry.get_config(arch, smoke=True)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
    params = RM.init(ref_cfg, KEY)
    return ref_cfg, params, cfg, convert.from_jax_params(cfg, np_tree(params), "cpu")


def inputs(cfg, seed: int = 0):
    """A batch of numpy arrays: tokens, and the stubs' embeddings."""
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, cfg.enc_context, cfg.d_model)).astype(
            np.float32)
    return batch


def close(got, want, rel: float = REL, what: str = ""):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max() if want.size else 0.0
    assert err <= rel * scale, f"{what}: max err {err} > {rel} x {scale}"
    return err / scale


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def check_forward(arch: str):
    ref_cfg, params, cfg, model = models(arch)
    batch = inputs(cfg)
    want = jax.jit(lambda p, b: RM.forward(ref_cfg, p, b))(params, batch)
    with torch.no_grad():
        got = M.forward(cfg, model.params(), torch_batch(batch))
        loss = M.loss_fn(cfg, model.params(), torch_batch(batch))
    close(got.numpy(), want, what=f"{arch} forward")
    close(loss.numpy(), jax.jit(lambda p, b: RM.loss_fn(ref_cfg, p, b))(params, batch),
          what=f"{arch} loss")


def check_decode(arch: str):
    """8 decode steps from an empty f32 cache (after ``encode`` for encdec):
    logits at every step and the caches after the last, against the
    reference; then the port's decode against its own forward."""
    ref_cfg, params, cfg, model = models(arch)
    batch = inputs(cfg, seed=1)
    tokens = batch["tokens"]
    ref_cache = RM.init_cache(ref_cfg, B, 16, jnp.float32)
    cache = M.init_cache(cfg, B, 16, torch.float32, "cpu")
    p = model.params()
    if cfg.family == "encdec":
        ref_cache = jax.jit(lambda pp, f, c: RM.encode(ref_cfg, pp, f, c))(
            params, batch["frames"], ref_cache)
        cache = M.encode(cfg, p, torch.from_numpy(batch["frames"]), cache)
    step = jax.jit(lambda pp, c, t, pos: RM.decode_step(ref_cfg, pp, c, t, pos))
    outs = []
    with torch.no_grad():
        for t in range(T):
            want, ref_cache = step(params, ref_cache, tokens[:, t:t + 1],
                                   jnp.asarray(t, jnp.int32))
            got, cache = M.decode_step(cfg, p, cache, torch.from_numpy(tokens[:, t:t + 1]), t)
            close(got.numpy()[..., : cfg.vocab], np.asarray(want)[..., : cfg.vocab],
                  what=f"{arch} decode step {t}")
            outs.append(got)
    ref_leaves = jax.tree_util.tree_flatten_with_path(ref_cache)[0]
    got_cache = dict(leaves(cache))
    assert len(ref_leaves) == len(got_cache)
    for path, want in ref_leaves:
        key = tuple(str(getattr(k, "key", k)) for k in path)
        close(got_cache[key].numpy(), want, what=f"{arch} cache {key}")
    if cfg.family != "vlm":   # the VLM's decode starts from a prefilled cache
        with torch.no_grad():
            full = M.forward(cfg, p, torch_batch(batch))
        close(torch.cat(outs, dim=1).numpy()[..., : cfg.vocab],
              full.numpy()[..., : cfg.vocab], what=f"{arch} decode against forward")


def check_n_params(arch: str):
    """The full config's counts, analytic and by spec tree, without allocating."""
    ref_cfg = ref_registry.get_config(arch)
    cfg = registry.get_config(arch)
    want = RM.n_params(ref_cfg)
    assert isinstance(want, int)
    assert M.n_params(cfg) == want
    assert cfg.n_params() == ref_cfg.n_params()

"""Unified LM: five families behind one functional interface.

The port of the JAX package's ``models/model.py``:

  * ``dense`` / ``moe`` / ``vlm`` / ``audio`` — decoder LM (GQA or MLA
    attention, dense MLP or MoE FFN) over a stack of layers;
  * ``ssm``     — Mamba-2 (SSD) stack;
  * ``hybrid``  — Jamba-style period-``attn_every`` super-blocks (1 attention
    + N-1 mamba sublayers, MoE on alternate sublayers);
  * ``encdec``  — Whisper-style encoder–decoder (frontend stubbed: the caller
    provides frame embeddings).

Interface (functions of (config, params, ...), ``params`` the nested dict of
tensors in the reference's tree layout, layer stacks ``[L, ...]``):
``specs(cfg)`` → ParamSpec tree; ``init(cfg, seed, device)`` → :class:`LM`
(whose ``params()`` is that tree); ``forward(cfg, params, batch)`` → logits;
``init_cache(cfg, batch, max_len, dtype, device)``;
``decode_step(cfg, params, cache, tokens, pos)`` → (logits, cache).

Where the reference scans over the stacked layers, the port loops over them
in Python: ``forward`` unbinds each stacked leaf once (so the backward pass
stacks the layers' gradients in one op), decode indexes a layer at a time.
Decode caches are updated in place (under ``no_grad``) and returned.
With ``cfg.remat == "block"`` and gradients enabled, each block runs under
``torch.utils.checkpoint`` (non-reentrant), as the reference's
``jax.checkpoint`` of the scan body; the hybrid super-block checkpoints
each sublayer instead.  ``abstract(cfg)`` is the parameter tree as ``meta``
tensors, a restore template that allocates nothing; ``axes(cfg)`` its
logical axes.  DTensor parameters (``distributed.sharding``) run the same
code under DTensor's dispatch, with ``act_spec`` the reference's sharding
constraint on the activations; the token lookup, the products and the cache
writes take the port's own DTensor rules (``distributed.dtensor``).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import device as device_mod
from repro_torch.configs.base import ModelConfig
from repro_torch.distributed.dtensor import constrain, embedding, is_dtensor, write_at
from repro_torch.models import attention as attn
from repro_torch.models import mamba2 as m2
from repro_torch.models import mla as mla_mod
from repro_torch.models import moe as moe_mod
from repro_torch.models.layers import (
    ParamSpec,
    abstract_params,
    axes_tree,
    cross_entropy,
    einsum,
    init_params,
    leaves,
    map_tree,
    mlp_forward,
    mlp_specs,
    param_count,
    rms_norm,
    stacked,
    torch_dtype,
)


# ---------------------------------------------------------------------------
# Spec trees
# ---------------------------------------------------------------------------


def _mixer_specs(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.mla is not None:
        return mla_mod.mla_specs(cfg.d_model, cfg.n_heads, cfg.mla)
    return attn.attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd)


def _ffn_specs(cfg: ModelConfig) -> Dict[str, Any]:
    if cfg.moe and cfg.moe.n_experts:
        return moe_mod.moe_specs(cfg.d_model, cfg.moe)
    return mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp_type)


def _norm(cfg: ModelConfig) -> ParamSpec:
    return ParamSpec((cfg.d_model,), ("embed",), init="ones")


def _decoder_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln1": _norm(cfg), "attn": _mixer_specs(cfg), "ln2": _norm(cfg),
            "mlp": _ffn_specs(cfg)}


def _ssm_block_specs(cfg: ModelConfig) -> Dict[str, Any]:
    return {"ln": _norm(cfg), "mixer": m2.mamba2_specs(cfg.d_model, cfg.ssm)}


def _hybrid_superblock_specs(cfg: ModelConfig) -> Dict[str, Any]:
    period = cfg.attn_every
    n_moe = period // 2
    n_dense = period - n_moe
    return {
        "attn_ln": _norm(cfg),
        "attn": attn.attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd),
        "mamba_ln": stacked({"g": _norm(cfg)}, period - 1)["g"],
        "mamba": stacked(m2.mamba2_specs(cfg.d_model, cfg.ssm), period - 1),
        "mlp_ln": stacked({"g": _norm(cfg)}, n_dense)["g"],
        "mlp": stacked(mlp_specs(cfg.d_model, cfg.d_ff), n_dense),
        "moe_ln": stacked({"g": _norm(cfg)}, n_moe)["g"],
        "moe": stacked(moe_mod.moe_specs(cfg.d_model, cfg.moe), n_moe),
    }


def _encdec_block_specs(cfg: ModelConfig, cross: bool) -> Dict[str, Any]:
    s = {
        "ln1": _norm(cfg),
        "attn": attn.attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd),
        "ln2": _norm(cfg),
        "mlp": mlp_specs(cfg.d_model, cfg.d_ff, cfg.mlp_type),
    }
    if cross:
        s["ln_x"] = _norm(cfg)
        s["xattn"] = attn.attn_specs(cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd)
    return s


def specs(cfg: ModelConfig) -> Dict[str, Any]:
    V, d = cfg.vocab_padded, cfg.d_model
    tree: Dict[str, Any] = {
        "embed": ParamSpec((V, d), ("vocab", "embed"), scale=0.02),
        "final_norm": ParamSpec((d,), ("embed",), init="ones"),
    }
    if not cfg.tie_embeddings:
        tree["lm_head"] = ParamSpec((d, V), ("embed", "vocab"))
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        tree["blocks"] = stacked(_decoder_block_specs(cfg), cfg.n_layers)
    elif cfg.family == "ssm":
        tree["blocks"] = stacked(_ssm_block_specs(cfg), cfg.n_layers)
    elif cfg.family == "hybrid":
        if cfg.n_layers % cfg.attn_every:
            raise ValueError(f"{cfg.n_layers} layers are not whole super-blocks of "
                             f"{cfg.attn_every}")
        tree["blocks"] = stacked(_hybrid_superblock_specs(cfg), cfg.n_layers // cfg.attn_every)
    elif cfg.family == "encdec":
        tree["enc_blocks"] = stacked(_encdec_block_specs(cfg, cross=False), cfg.n_enc_layers)
        tree["enc_norm"] = ParamSpec((d,), ("embed",), init="ones")
        tree["blocks"] = stacked(_encdec_block_specs(cfg, cross=True), cfg.n_layers)
    else:
        raise ValueError(cfg.family)
    return tree


def n_params(cfg: ModelConfig) -> int:
    """The spec tree's parameter count, nothing allocated."""
    return param_count(specs(cfg))


def abstract(cfg: ModelConfig):
    """The parameter tree as ``meta`` tensors in ``cfg.param_dtype``."""
    return abstract_params(specs(cfg), dtype=torch_dtype(cfg.param_dtype))


def axes(cfg: ModelConfig):
    """The logical-axis tree of the parameters (``distributed.sharding``)."""
    return axes_tree(specs(cfg))


class ParamTree(nn.Module):
    """A nested dict of tensors as modules and parameters, one level a module:
    ``state_dict`` keys are the reference's tree paths (``blocks.attn.wq``).
    The parameters take gradients; serving runs under ``no_grad``."""

    def __init__(self, tree: Dict[str, Any]):
        super().__init__()
        for k, v in tree.items():
            if isinstance(v, dict):
                self.add_module(k, ParamTree(v))
            else:
                self.register_parameter(k, nn.Parameter(v))

    def tree(self) -> Dict[str, Any]:
        out: Dict[str, Any] = {k: p for k, p in self._parameters.items()}
        out.update({k: m.tree() for k, m in self._modules.items()})
        return out


class LM(nn.Module):
    """A model of one config: its parameters (:class:`ParamTree`) and the
    functional entry points bound to them."""

    def __init__(self, cfg: ModelConfig, params: Dict[str, Any]):
        super().__init__()
        self.cfg = cfg
        self.weights = ParamTree(params)

    def params(self) -> Dict[str, Any]:
        return self.weights.tree()

    def n_params(self) -> int:
        return sum(p.numel() for p in self.parameters())

    def forward(self, batch: Dict[str, torch.Tensor], chunk=None) -> torch.Tensor:
        return forward(self.cfg, self.params(), batch, chunk)


def init(cfg: ModelConfig, seed: int = 0, device: str | torch.device | None = None) -> LM:
    """The model of ``cfg`` at the reference's init laws, drawn from a
    generator seeded by ``seed`` on ``device`` (CUDA unless the caller names
    another), in ``cfg.param_dtype``: one leaf at a time, in f32 then cast."""
    dev = device_mod.resolve(device)
    params = init_params(specs(cfg), device_mod.generator(dev, seed, 0),
                         dtype=torch_dtype(cfg.param_dtype), device=dev)
    return LM(cfg, params)


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------


def _lookup(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """The token embeddings: ``table[ids]``; on a DTensor table, the
    vocab-parallel lookup of ``distributed.dtensor.embedding``."""
    return embedding(table, ids) if is_dtensor(table) else table[ids]


def _layer(blocks, i: int):
    """Layer ``i`` of a stacked tree."""
    return map_tree(lambda a: a[i], blocks)


def _n_stacked(blocks) -> int:
    return next(leaves(blocks))[1].shape[0]


def _decoder_block(cfg: ModelConfig, p, x, chunk):
    h = rms_norm(x, p["ln1"], cfg.norm_eps)
    if cfg.mla is not None:
        x = x + mla_mod.mla_forward(p["attn"], h, cfg.mla, chunk=chunk)
    else:
        x = x + attn.gqa_forward(p["attn"], h, cfg.rope_theta, chunk=chunk)
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    if cfg.moe and cfg.moe.n_experts:
        y, _aux = moe_mod.moe_forward(p["mlp"], h, cfg.moe)
        x = x + y
    else:
        x = x + mlp_forward(h, p["mlp"])
    return x


def _ssm_block(cfg: ModelConfig, p, x):
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    return x + m2.mamba2_forward(p["mixer"], h, cfg.ssm)


def _hybrid_moe(cfg: ModelConfig, sub, ln, h):
    return moe_mod.moe_forward(sub, rms_norm(h, ln, cfg.norm_eps), cfg.moe)[0]


def _hybrid_mlp(cfg: ModelConfig, sub, ln, h):
    return mlp_forward(rms_norm(h, ln, cfg.norm_eps), sub)


def _hybrid_ffn(x, i: int, di: int, oi: int, at, moe_fn, mlp_fn):
    """The FFN sublayer after mixer ``i`` of a super-block: MoE after odd
    mixers, an MLP after even ones.  ``at(kind, j)`` gives the ``j``-th
    ``"moe"``/``"mlp"`` sublayer's parameters and norm; ``moe_fn``/``mlp_fn``
    are ``_hybrid_moe``/``_hybrid_mlp`` (under remat on the forward path)."""
    if i % 2 == 1:
        return x + moe_fn(*at("moe", oi), x), di, oi + 1
    return x + mlp_fn(*at("mlp", di), x), di + 1, oi


def _remat(cfg: ModelConfig, fn):
    """``fn`` under a non-reentrant checkpoint when ``cfg.remat == "block"``
    and gradients are on: its activations are recomputed in the backward."""
    if cfg.remat != "block" or not torch.is_grad_enabled():
        return fn
    return lambda *args: checkpoint(fn, *args, use_reentrant=False)


def _unbind(blocks) -> List[Dict[str, Any]]:
    """The layers of a stacked tree, each leaf unbound once: views whose
    gradients the backward stacks in one op (indexing a layer at a time
    would zero-fill a gradient the size of the stack for every layer)."""
    parts = map_tree(lambda a: a.unbind(0), blocks)
    return [map_tree(lambda t: t[i], parts) for i in range(_n_stacked(blocks))]


def _hybrid_superblock(cfg: ModelConfig, p, x, chunk):
    """One super-block; with remat each SUBLAYER is checkpointed, as in the
    reference (a superblock-level checkpoint would keep every mamba
    sublayer's residuals alive at once)."""
    eps = cfg.norm_eps

    def attn_sub(pa, ln, h):
        return attn.gqa_forward(pa, rms_norm(h, ln, eps), cfg.rope_theta, chunk=chunk)

    def mamba_sub(sub, ln, h):
        return m2.mamba2_forward(sub, rms_norm(h, ln, eps), cfg.ssm)

    attn_sub, mamba_sub = _remat(cfg, attn_sub), _remat(cfg, mamba_sub)
    moe_fn, mlp_fn = (_remat(cfg, functools.partial(f, cfg)) for f in (_hybrid_moe, _hybrid_mlp))
    parts = {k: _unbind(p[k]) for k in ("mamba", "mlp", "moe")}
    lns = {k: p[k + "_ln"].unbind(0) for k in ("mamba", "mlp", "moe")}
    di, oi = 0, 0
    for i in range(cfg.attn_every):
        if i == 0:
            x = x + attn_sub(p["attn"], p["attn_ln"], x)
        else:
            x = x + mamba_sub(parts["mamba"][i - 1], lns["mamba"][i - 1], x)
        x, di, oi = _hybrid_ffn(x, i, di, oi, lambda k, j: (parts[k][j], lns[k][j]),
                                moe_fn, mlp_fn)
    return x


def _run_stack(blocks, x, body, act_spec=None):
    """``body`` over the layers of ``blocks`` (the caller applies remat),
    each block's output constrained to ``act_spec``."""
    for p in _unbind(blocks):
        x = constrain(body(p, x), act_spec)
    return x


def _encoder(cfg: ModelConfig, params, frames, chunk=None, act_spec=None):
    def body(p, h):
        a = rms_norm(h, p["ln1"], cfg.norm_eps)
        h = h + attn.bidir_attention(p["attn"], a, cfg.rope_theta, chunk=chunk)
        a = rms_norm(h, p["ln2"], cfg.norm_eps)
        return h + mlp_forward(a, p["mlp"])

    x = _run_stack(params["enc_blocks"], frames, _remat(cfg, body), act_spec)
    return rms_norm(x, params["enc_norm"], cfg.norm_eps)


def hidden_states(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
                  chunk: Optional[int] = None, act_spec=None) -> torch.Tensor:
    """Embed inputs and run the stack; returns final hidden [B, T, d].
    ``act_spec`` (a ``PartitionSpec`` of [B, T, d]) constrains the
    embedding's output and every block's, where the activations are
    DTensors, as the reference's ``with_sharding_constraint``."""
    x = _lookup(params["embed"], batch["tokens"])
    if cfg.family == "vlm":
        x = torch.cat([batch["vision_embeds"].to(x.dtype), x], dim=1)
    x = constrain(x, act_spec)
    if cfg.family == "encdec":
        enc = _encoder(cfg, params, batch["frames"].to(x.dtype), chunk, act_spec)

        def body(p, h):
            a = rms_norm(h, p["ln1"], cfg.norm_eps)
            h = h + attn.gqa_forward(p["attn"], a, cfg.rope_theta, chunk=chunk)
            a = rms_norm(h, p["ln_x"], cfg.norm_eps)
            h = h + attn.cross_attention(p["xattn"], a, enc)
            a = rms_norm(h, p["ln2"], cfg.norm_eps)
            return h + mlp_forward(a, p["mlp"])

        x = _run_stack(params["blocks"], x, _remat(cfg, body), act_spec)
    elif cfg.family == "ssm":
        x = _run_stack(params["blocks"], x, _remat(cfg, lambda p, h: _ssm_block(cfg, p, h)),
                       act_spec)
    elif cfg.family == "hybrid":
        # each sublayer is checkpointed inside the super-block
        x = _run_stack(params["blocks"], x, lambda p, h: _hybrid_superblock(cfg, p, h, chunk),
                       act_spec)
    else:
        x = _run_stack(params["blocks"], x,
                       _remat(cfg, lambda p, h: _decoder_block(cfg, p, h, chunk)), act_spec)
    return rms_norm(x, params["final_norm"], cfg.norm_eps)


def logits_of(cfg: ModelConfig, params, hidden: torch.Tensor) -> torch.Tensor:
    if cfg.tie_embeddings:
        return einsum("btd,vd->btv", hidden, params["embed"])
    return einsum("btd,dv->btv", hidden, params["lm_head"])


def forward(cfg: ModelConfig, params, batch: Dict[str, torch.Tensor],
            chunk=None, act_spec=None) -> torch.Tensor:
    return logits_of(cfg, params, hidden_states(cfg, params, batch, chunk, act_spec))


def mask_vocab_pad(cfg: ModelConfig, logits: torch.Tensor) -> torch.Tensor:
    """Kill the padded vocab tail (see ModelConfig.pad_vocab_to)."""
    if cfg.vocab_padded == cfg.vocab:
        return logits
    v = torch.arange(cfg.vocab_padded, device=logits.device) < cfg.vocab
    return torch.where(v, logits, torch.tensor(-1e30, dtype=logits.dtype,
                                               device=logits.device))


def loss_fn(cfg: ModelConfig, params, batch, chunk=None, act_spec=None) -> torch.Tensor:
    """Next-token NLL.  VLM: loss on text positions only."""
    logits = mask_vocab_pad(cfg, forward(cfg, params, batch, chunk, act_spec))
    tokens = batch["tokens"]
    if cfg.family == "vlm":
        logits = logits[:, batch["vision_embeds"].shape[1]:]
    labels = tokens[:, 1:]
    return cross_entropy(logits[:, :-1], labels, batch.get("loss_mask"))


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------


def _stack_cache(one: Dict[str, torch.Tensor], *lead: int) -> Dict[str, torch.Tensor]:
    """A cache of ``one``'s shapes for each index of ``lead`` (zeros)."""
    return {k: torch.zeros(lead + tuple(a.shape), dtype=a.dtype, device=a.device)
            for k, a in one.items()}


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None,
               device: str | torch.device | None = None):
    """Zeroed decode state on ``device`` (CUDA unless the caller names
    another; ``"meta"`` allocates nothing); ``dtype`` defaults to
    ``cfg.compute_dtype``, as in the reference (the serving launcher passes
    the parameters' dtype)."""
    dtype = torch_dtype(dtype or cfg.compute_dtype)
    if device is None or torch.device(device).type != "meta":
        device = device_mod.resolve(device)
    if cfg.family in ("dense", "moe", "vlm", "audio"):
        if cfg.mla is not None:
            one = mla_mod.mla_init_cache(batch, max_len, cfg.mla, dtype, device)
        else:
            one = attn.gqa_init_cache(batch, max_len, cfg.n_kv_heads, cfg.hd, dtype, device)
        return _stack_cache(one, cfg.n_layers)
    if cfg.family == "ssm":
        return _stack_cache(m2.mamba2_init_cache(batch, cfg.d_model, cfg.ssm, dtype, device),
                            cfg.n_layers)
    if cfg.family == "hybrid":
        nb = cfg.n_layers // cfg.attn_every
        a_c = attn.gqa_init_cache(batch, max_len, cfg.n_kv_heads, cfg.hd, dtype, device)
        m_c = m2.mamba2_init_cache(batch, cfg.d_model, cfg.ssm, dtype, device)
        return {"attn": _stack_cache(a_c, nb),
                "mamba": _stack_cache(m_c, nb, cfg.attn_every - 1)}
    if cfg.family == "encdec":
        self_c = attn.gqa_init_cache(batch, max_len, cfg.n_kv_heads, cfg.hd, dtype, device)
        cross = (cfg.n_layers, batch, cfg.enc_context, cfg.n_kv_heads, cfg.hd)
        return {
            "self": _stack_cache(self_c, cfg.n_layers),
            # cross K/V per layer, filled by `encode`
            "cross_k": torch.zeros(cross, dtype=dtype, device=device),
            "cross_v": torch.zeros(cross, dtype=dtype, device=device),
        }
    raise ValueError(cfg.family)


@torch.no_grad()
def encode(cfg: ModelConfig, params, frames: torch.Tensor, cache):
    """encdec: run the encoder, put per-layer cross K/V into the cache."""
    enc = _encoder(cfg, params, frames)
    ks = einsum("btd,ldhk->lbthk", enc, params["blocks"]["xattn"]["wk"])
    vs = einsum("btd,ldhk->lbthk", enc, params["blocks"]["xattn"]["wv"])
    write_at(cache["cross_k"], {}, ks)
    write_at(cache["cross_v"], {}, vs)
    return cache


def _layer_cache(cache, i: int):
    """Layer ``i``'s views of a stacked cache: writes land in the stack."""
    return {k: a[i] for k, a in cache.items()}


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, cache, tokens: torch.Tensor,
                pos: int) -> Tuple[torch.Tensor, Any]:
    """One token a sequence: ``tokens`` [B, 1] at position ``pos`` → masked
    logits [B, 1, V_padded] and the cache, updated in place (no gradients:
    the parameters' own do not flow through a cache written in place)."""
    x = _lookup(params["embed"], tokens)
    blocks = params["blocks"]
    L = _n_stacked(blocks)

    if cfg.family in ("dense", "moe", "vlm", "audio"):
        for i in range(L):
            p, c = _layer(blocks, i), _layer_cache(cache, i)
            a = rms_norm(x, p["ln1"], cfg.norm_eps)
            if cfg.mla is not None:
                y, _ = mla_mod.mla_decode_step(p["attn"], c, a, pos, cfg.mla)
            else:
                y, _ = attn.gqa_decode_step(p["attn"], c, a, pos, cfg.rope_theta)
            x = x + y
            a = rms_norm(x, p["ln2"], cfg.norm_eps)
            if cfg.moe and cfg.moe.n_experts:
                y, _ = moe_mod.moe_forward(p["mlp"], a, cfg.moe)
                x = x + y
            else:
                x = x + mlp_forward(a, p["mlp"])
    elif cfg.family == "ssm":
        for i in range(L):
            p = _layer(blocks, i)
            a = rms_norm(x, p["ln"], cfg.norm_eps)
            y, _ = m2.mamba2_decode_step(p["mixer"], _layer_cache(cache, i), a, cfg.ssm)
            x = x + y
    elif cfg.family == "hybrid":
        for b in range(L):
            p = _layer(blocks, b)
            di, oi = 0, 0
            for i in range(cfg.attn_every):
                if i == 0:
                    a = rms_norm(x, p["attn_ln"], cfg.norm_eps)
                    y, _ = attn.gqa_decode_step(p["attn"], _layer_cache(cache["attn"], b), a,
                                                pos, cfg.rope_theta)
                else:
                    # the mamba sublayer's state, written in place in the stack
                    sub_c = {k: v[b, i - 1] for k, v in cache["mamba"].items()}
                    a = rms_norm(x, p["mamba_ln"][i - 1], cfg.norm_eps)
                    y, _ = m2.mamba2_decode_step(_layer(p["mamba"], i - 1), sub_c, a, cfg.ssm)
                    # a DTensor sharded on the two stacked dims is read as a
                    # copy, so the new state is written back (on a plain
                    # tensor the read is a view, and copying it onto itself
                    # does nothing)
                    for k, v in cache["mamba"].items():
                        write_at(v, {0: b, 1: i - 1}, sub_c[k])
                x = x + y
                x, di, oi = _hybrid_ffn(
                    x, i, di, oi, lambda k, j: (_layer(p[k], j), p[k + "_ln"][j]),
                    functools.partial(_hybrid_moe, cfg), functools.partial(_hybrid_mlp, cfg))
    elif cfg.family == "encdec":
        for i in range(L):
            p = _layer(blocks, i)
            xk, xv = cache["cross_k"][i], cache["cross_v"][i]
            a = rms_norm(x, p["ln1"], cfg.norm_eps)
            y, _ = attn.gqa_decode_step(p["attn"], _layer_cache(cache["self"], i), a, pos,
                                        cfg.rope_theta)
            x = x + y
            a = rms_norm(x, p["ln_x"], cfg.norm_eps)
            q = einsum("btd,dhk->bthk", a, p["xattn"]["wq"])
            KV = xk.shape[2]
            qg = attn._group(q, KV)
            s = einsum("btkgh,bskh->bkgts", qg, xk).float() * (q.shape[-1] ** -0.5)
            pr = torch.softmax(s, dim=-1).to(x.dtype)
            ctx = einsum("bkgts,bskh->btkgh", pr, xv).reshape(*q.shape)
            x = x + einsum("bthk,hkd->btd", ctx, p["xattn"]["wo"])
            a = rms_norm(x, p["ln2"], cfg.norm_eps)
            x = x + mlp_forward(a, p["mlp"])
    else:
        raise ValueError(cfg.family)

    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return mask_vocab_pad(cfg, logits_of(cfg, params, x)), cache

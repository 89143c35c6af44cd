"""Model/shape/run configuration for the LM substrate.

The port's own copy of the JAX package's ``configs/base.py``: the same
dataclasses, fields and defaults, and the same analytic parameter count, so
every config compares field by field with the reference's.

One :class:`ModelConfig` instance per assigned architecture lives in
``repro_torch.configs.<id>``; each also exposes ``smoke()`` — a reduced
same-family config for CPU smoke tests.  ``repro_torch.configs.registry``
maps ``--arch`` ids to modules.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 0            # routed experts
    n_shared: int = 0             # always-on shared experts
    top_k: int = 0
    expert_d_ff: int = 0          # per-expert FFN hidden
    every: int = 1                # MoE applied on layers where l % every == 0
    capacity_factor: float = 1.25
    lpt_placement: bool = True    # paper-bridge: LPT expert→EP-rank assignment
    ep_axis: object = None        # mesh axis for expert parallelism (set by the
                                  # launcher when n_experts divides the axis)
    token_chunk: int = 0          # >0: dispatch in token chunks (bounds the
                                  # [E·C, d] buffers regardless of sharding)


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    q_lora_rank: int = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


@dataclasses.dataclass(frozen=True)
class SSMConfig:
    d_state: int = 128
    expand: int = 2
    head_dim: int = 64
    n_groups: int = 1
    conv_width: int = 4
    chunk: int = 256


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str = "model"
    family: str = "dense"         # dense | moe | ssm | hybrid | encdec | vlm | audio
    n_layers: int = 4
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: int = 4
    d_ff: int = 1024
    vocab: int = 1024
    mlp_type: str = "swiglu"   # swiglu (3 mats) | gelu (2 mats)
    head_dim: Optional[int] = None   # default d_model // n_heads
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    tie_embeddings: bool = False
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: int = 1           # hybrid: attention on layers l % attn_every == 0
    n_enc_layers: int = 0         # encdec: encoder depth (frontend stub feeds it)
    enc_context: int = 1500       # encdec: #frames the encoder sees in decode
    vision_tokens: int = 256      # vlm: #patch-embedding tokens from the stub
    sub_quadratic: bool = False   # may lower long_500k
    # numerics / memory policy
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    remat: str = "block"          # none | block  (checkpoint each scan block)
    pad_vocab_to: int = 128       # TPU lane alignment + mesh divisibility; the
                                  # padded tail is masked out of loss/decoding

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def vocab_padded(self) -> int:
        m = self.pad_vocab_to
        return ((self.vocab + m - 1) // m) * m

    def n_params(self) -> int:
        """Analytic parameter count (matches the spec trees; used for 6ND)."""
        d, V = self.d_model, self.vocab
        emb = V * d * (1 if self.tie_embeddings else 2)
        total = emb
        for l in range(self.n_layers):
            total += self._layer_params(l)
        if self.family == "encdec":
            for l in range(self.n_enc_layers):
                total += self._enc_layer_params()
        total += d  # final norm
        return total

    def _attn_params(self) -> int:
        d, hd = self.d_model, self.hd
        if self.mla is not None:
            m = self.mla
            qk = m.qk_nope_dim + m.qk_rope_dim
            return (
                d * m.q_lora_rank + m.q_lora_rank * self.n_heads * qk
                + d * (m.kv_lora_rank + m.qk_rope_dim)
                + m.kv_lora_rank * self.n_heads * (m.qk_nope_dim + m.v_head_dim)
                + self.n_heads * m.v_head_dim * d
                + m.q_lora_rank + m.kv_lora_rank
            )
        return (
            d * self.n_heads * hd
            + 2 * d * self.n_kv_heads * hd
            + self.n_heads * hd * d
        )

    def _mlp_params(self, layer: int) -> int:
        d = self.d_model
        k = 2 if self.mlp_type == "gelu" else 3
        if self.moe and self.moe.n_experts and (layer % self.moe.every == 0):
            m = self.moe
            per = 3 * d * m.expert_d_ff
            return (m.n_experts + m.n_shared) * per + d * m.n_experts
        return k * d * self.d_ff

    def _ssm_params(self) -> int:
        s = self.ssm
        d = self.d_model
        di = s.expand * d
        H = di // s.head_dim
        conv_dim = di + 2 * s.n_groups * s.d_state
        return (
            d * (2 * di + 2 * s.n_groups * s.d_state + H)
            + conv_dim * s.conv_width
            + 2 * H
            + di * d
            + d
        )

    def _layer_params(self, l: int) -> int:
        d = self.d_model
        if self.family == "ssm":
            return self._ssm_params() + d
        if self.family == "hybrid":
            is_attn = (l % self.attn_every) == 0
            core = self._attn_params() if is_attn else self._ssm_params()
            return core + self._mlp_params(l) + 2 * d
        mlp = self._mlp_params(l)
        extra = 0
        if self.family == "encdec":
            extra = self._attn_params() + d  # cross attention + its norm
        return self._attn_params() + mlp + 2 * d + extra

    def _enc_layer_params(self) -> int:
        k = 2 if self.mlp_type == "gelu" else 3
        return self._attn_params() + k * self.d_model * self.d_ff + 2 * self.d_model


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}


def shapes_for(cfg: ModelConfig) -> Tuple[str, ...]:
    """The dry-run cells this architecture runs (long_500k: sub-quadratic only)."""
    out = ["train_4k", "prefill_32k", "decode_32k"]
    if cfg.sub_quadratic:
        out.append("long_500k")
    return tuple(out)

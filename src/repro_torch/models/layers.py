"""Shared building blocks: ParamSpec trees, norms, RoPE, MLP.

The port of the JAX package's ``models/layers.py``.  Every model module
builds a nested dict of :class:`ParamSpec` (shape + logical axes + init
law); from that one tree come the initialised parameters
(:func:`init_params`), their ``meta`` template (:func:`abstract_params`),
the logical-axis tree (:func:`axes_tree`) and the analytic count
(:func:`param_count`); the last three allocate nothing.  The leaves are
visited in the reference's order (``jax.tree``
flattens a dict by sorted key), one ``torch.Generator`` draws them, so the
init laws are the reference's and the draws the port's own.

:func:`einsum` is ``torch.einsum`` under JAX's dtype promotion: its operands
are cast to their common type first (bf16 with f32 gives f32), where
``torch.einsum`` would raise.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.distributed import dtensor


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]   # logical axis name per dim (None = replicated)
    init: str = "normal"              # normal | zeros | ones
    scale: Optional[float] = None     # default: 1/sqrt(fan_in = shape[-2] or [-1])

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def torch_dtype(name: str | torch.dtype) -> torch.dtype:
    """A config's dtype name (``"bfloat16"``) as a torch dtype."""
    return name if isinstance(name, torch.dtype) else DTYPES[name]


def leaves(tree, path: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """``(path, leaf)`` of a nested dict, in ``jax.tree``'s order (sorted keys)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves(tree[k], path + (k,))
    else:
        yield path, tree


def tree_of(items) -> Dict:
    """The nested dict of ``(path, leaf)`` pairs (as ``leaves`` yields them)."""
    out: Dict = {}
    for path, leaf in items:
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = leaf
    return out


def map_tree(fn, tree):
    """``fn`` applied to every leaf of a nested dict."""
    if isinstance(tree, dict):
        return {k: map_tree(fn, v) for k, v in tree.items()}
    return fn(tree)


def _leaf_init(spec: ParamSpec, generator: torch.Generator, dtype: torch.dtype,
               device: torch.device) -> torch.Tensor:
    if spec.init == "zeros":
        return torch.zeros(spec.shape, dtype=dtype, device=device)
    if spec.init == "ones":
        return torch.ones(spec.shape, dtype=dtype, device=device)
    fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
    scale = spec.scale if spec.scale is not None else 1.0 / math.sqrt(max(fan_in, 1))
    # drawn in f32 and cast leaf by leaf: the peak stays near the model's size
    w = torch.randn(spec.shape, generator=generator, dtype=torch.float32, device=device)
    return w.mul_(scale).to(dtype)


def init_params(specs, generator: torch.Generator, dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device = "cpu"):
    """The tree of ``specs`` with every leaf initialised on ``device``:
    normal leaves ``N(0, 1)·scale`` drawn in f32 from ``generator`` (which
    lives on ``device``), then cast to ``dtype``."""
    device = torch.device(device)
    return tree_of((path, _leaf_init(spec, generator, dtype, device))
                   for path, spec in leaves(specs))


def abstract_params(specs, dtype: torch.dtype = torch.bfloat16):
    """The tree of ``specs`` as ``meta`` tensors of ``dtype``: shapes and
    dtypes, nothing allocated."""
    return map_tree(lambda s: torch.empty(s.shape, dtype=dtype, device="meta"), specs)


def axes_tree(specs):
    """The logical-axis tree of a spec tree (one tuple of names a leaf),
    which ``distributed.sharding`` maps onto mesh axes."""
    return map_tree(lambda s: s.axes, specs)


def param_count(specs) -> int:
    return int(sum(math.prod(s.shape) for _, s in leaves(specs)))


def stacked(spec_dict: Dict[str, Any], n: int, axis_name: str = "layers"):
    """Prepend a stacking dim (the layer stack) to every spec in a tree."""
    return map_tree(lambda s: ParamSpec((n,) + s.shape, (axis_name,) + s.axes, s.init,
                                        s.scale), spec_dict)


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------


def einsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` with the operands promoted to one dtype first, as
    ``jnp.einsum`` promotes them; on DTensors, ``distributed.dtensor.einsum``."""
    dt = xs[0].dtype
    for x in xs[1:]:
        dt = torch.promote_types(dt, x.dtype)
    if any(dtensor.is_dtensor(x) for x in xs):
        return dtensor.einsum(eq, *(x.to(dt) for x in xs))
    return torch.einsum(eq, *(x.to(dt) for x in xs))


def rms_norm(x: torch.Tensor, gamma: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """Normalised in f32, cast back to ``x``'s dtype, then ``* gamma``."""
    dt = x.dtype
    xf = x.float()
    var = (xf * xf).mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)).to(dt) * gamma


def rope_freqs(hd: int, theta: float, device=None, dtype=torch.float32) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=dtype, device=device) / hd))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [..., T, H, hd]; positions: broadcastable to [..., T].  The angles
    in f32."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, x.device)                    # [hd/2]
    ang = positions[..., None].float() * freqs                  # [..., T, hd/2]
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x[..., : hd // 2], x[..., hd // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    """SwiGLU MLP: down( silu(x·gate) ⊙ (x·up) )."""
    g = einsum("...d,df->...f", x, w_gate)
    u = einsum("...d,df->...f", x, w_up)
    return einsum("...f,fd->...d", F.silu(g) * u, w_down)


def mlp_specs(d: int, d_ff: int, kind: str = "swiglu") -> Dict[str, ParamSpec]:
    if kind == "gelu":
        return {
            "up": ParamSpec((d, d_ff), ("embed", "ffn")),
            "down": ParamSpec((d_ff, d), ("ffn", "embed")),
        }
    return {
        "gate": ParamSpec((d, d_ff), ("embed", "ffn")),
        "up": ParamSpec((d, d_ff), ("embed", "ffn")),
        "down": ParamSpec((d_ff, d), ("ffn", "embed")),
    }


def mlp_forward(x: torch.Tensor, p) -> torch.Tensor:
    """Dispatch on the param dict: SwiGLU if a gate matrix is present, else
    the tanh-approximated GELU (``jax.nn.gelu``'s default)."""
    if "gate" in p:
        return swiglu(x, p["gate"], p["up"], p["down"])
    h = F.gelu(einsum("...d,df->...f", x, p["up"]), approximate="tanh")
    return einsum("...f,fd->...d", h, p["down"])


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask=None) -> torch.Tensor:
    """Mean token NLL; logits [..., V] (softmax in f32), labels int [...]."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    # the difference is taken before the last dim is dropped: over a vocab
    # sharded as a DTensor, the gather's pending masked sum must meet the
    # shape it was taken at
    gold = torch.gather(logits, -1, labels[..., None].long())
    nll = (logz[..., None] - gold)[..., 0]
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)

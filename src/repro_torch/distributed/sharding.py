"""Logical-axis → mesh-axis sharding rules (MaxText-style), as DTensor
placements on a ``DeviceMesh``.

The port of the JAX package's ``distributed/sharding.py``.  Every parameter
carries logical axis names from its ParamSpec; rules map them to mesh axes.
A mapping is *dropped* (replicated) when the dim is not divisible by the
mesh-axis product or the mesh axis was already consumed by an earlier dim of
the same param — so one rule table serves every architecture (24-head llama
can't split 16-way TP on heads: heads drop, ffn still shards).

The spec of a tensor is the reference's per-tensor-dim ``PartitionSpec``,
kept as the port's own :class:`PartitionSpec`: a tuple with one entry a
dim, each a mesh-axis name, ``None`` or a tuple of names, trailing ``None``s
trimmed.  The rule functions read only the mesh's axis sizes, so they take a
``DeviceMesh`` with named dims or a shape-only
:class:`~repro_torch.launch.mesh.MeshShape` alike.  :func:`placements` turns
a spec into DTensor placements, one a mesh dim: ``Shard(d)`` on each mesh
dim named for tensor dim ``d``, ``Replicate()`` elsewhere.  A tuple of axes
on one dim (``("pod", "data")``) shards that dim over both mesh dims, major
to minor in the mesh's order, as JAX lays out a multi-axis spec: the axes of
a tuple must come in the mesh's order.  :func:`local_block` gives the index
ranges a mesh coordinate holds, without a process group.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch

from repro_torch.models.layers import map_tree

Rules = Dict[str, Optional[Tuple[str, ...]]]


class PartitionSpec(tuple):
    """One entry a tensor dim: a mesh-axis name, ``None`` (replicated) or a
    tuple of names (sharded over their product, major to minor)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


PS = PartitionSpec


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (a ``DeviceMesh`` or a ``MeshShape``), as the
    reference's ``jax.sharding.NamedSharding``."""

    mesh: Any
    spec: PartitionSpec

    @property
    def placements(self) -> tuple:
        return placements(self.spec, self.mesh)


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names, in its dims' order."""
    names = getattr(mesh, "mesh_dim_names", None)
    if names is None and not hasattr(mesh, "axis_names"):
        raise ValueError("a device mesh for the sharding rules needs named dims")
    return tuple(names if names is not None else mesh.axis_names)


def mesh_sizes(mesh) -> Dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or a ``MeshShape``."""
    names = axis_names(mesh)
    if hasattr(mesh, "mesh_dim_names"):
        return {n: int(mesh.size(i)) for i, n in enumerate(names)}
    return {n: int(mesh.shape[n]) for n in names}


def default_rules(multi_pod: bool, fsdp: bool = True) -> Rules:
    """Baseline rule table.  TP over "model"; FSDP of the d_model ("embed")
    param dim over the data axes (ZeRO-3-style, all-gathered per step)."""
    data_axes = ("pod", "data") if multi_pod else ("data",)
    return {
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "ffn": ("model",),
        "experts": ("model",),
        "embed": data_axes if fsdp else None,
        "layers": None,
        "head_dim": None,
        "q_lora": None,
        "kv_lora": None,
    }


def _axis_size(sizes: Dict[str, int], axes: Sequence[str]) -> int:
    return math.prod(sizes[a] for a in axes)


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]], mesh,
             rules: Rules) -> PartitionSpec:
    """PartitionSpec for one param; drops non-divisible / conflicting axes."""
    sizes = mesh_sizes(mesh)
    used: set = set()
    entries: List[Any] = []
    for dim, name in zip(shape, logical):
        target = rules.get(name) if name else None
        if target:
            target = tuple(a for a in target if a not in used)
        if not target or dim % _axis_size(sizes, target) != 0:
            entries.append(None)
            continue
        used.update(target)
        entries.append(target if len(target) > 1 else target[0])
    while entries and entries[-1] is None:   # canonical form
        entries.pop()
    return PS(*entries)


def tree_shardings(abstract_tree, axes_tree, mesh, rules: Rules):
    """A :class:`NamedSharding` tree matching a parameter tree (tensors,
    ``meta`` ones included) and its logical-axis tree (``model.axes``)."""
    def walk(a, ax):
        if isinstance(a, dict):
            return {k: walk(a[k], ax[k]) for k in a}
        return NamedSharding(mesh, spec_for(tuple(a.shape), ax, mesh, rules))

    return walk(abstract_tree, axes_tree)


def batch_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in axis_names(mesh) else ("data",)


def data_spec(mesh, batch: int, ndim: int) -> PartitionSpec:
    """Spec for a [B, ...] batch array: B over the data axes when divisible."""
    sizes = mesh_sizes(mesh)
    ax = batch_axes(mesh)
    if batch % _axis_size(sizes, ax) == 0:
        lead = ax if len(ax) > 1 else ax[0]
        return PS(lead, *([None] * (ndim - 1)))
    if batch % sizes["data"] == 0:   # fall back: "data" alone
        return PS("data", *([None] * (ndim - 1)))
    return PS(*([None] * ndim))


def cache_spec_for_leaf(shape: Tuple[int, ...], mesh) -> PartitionSpec:
    """Heuristic decode-cache sharding.

    Leaves look like [L, B, S, KV, hd] (attention K/V), [L, B, S, r] (MLA
    latent), [L, B, H, P, N] (SSM state), [L, B, w, conv] (conv state), or the
    same with an extra hybrid sub-layer dim.  Policy: shard the batch dim over
    "data" when divisible, else the longest remaining dim; shard a heads-like
    middle dim over "model" when divisible, else the sequence dim.
    """
    if len(shape) < 2:
        return PS()
    sizes = mesh_sizes(mesh)
    entries: List[Any] = [None] * len(shape)
    b_dim = 1                   # the batch: dim 1 by construction
    used_data = False
    has_pod = "pod" in sizes
    d_axes = ("pod", "data") if has_pod else ("data",)
    d_size = _axis_size(sizes, d_axes)
    if shape[b_dim] % d_size == 0 and shape[b_dim] > 1:
        entries[b_dim] = d_axes if has_pod else "data"
        used_data = True
    elif shape[b_dim] % sizes["data"] == 0 and shape[b_dim] > 1:
        entries[b_dim] = "data"
        used_data = True
    # model axis: prefer a later dim divisible by model size, largest first
    cand = sorted(range(b_dim + 1, len(shape)), key=lambda i: -shape[i])
    for i in cand:
        if entries[i] is None and shape[i] > 1 and shape[i] % sizes["model"] == 0:
            entries[i] = "model"
            break
    if not used_data:
        for i in cand:
            if entries[i] is None and shape[i] > 1 and shape[i] % sizes["data"] == 0:
                entries[i] = "data"
                break
    while entries and entries[-1] is None:
        entries.pop()
    return PS(*entries)


def cache_shardings(cache_abstract, mesh):
    """A :class:`NamedSharding` tree of a decode cache's tree."""
    return map_tree(lambda a: NamedSharding(mesh, cache_spec_for_leaf(tuple(a.shape), mesh)),
                    cache_abstract)


def replicated(mesh) -> NamedSharding:
    return NamedSharding(mesh, PS())


@dataclasses.dataclass(frozen=True)
class StepLayout:
    """How a dry-run cell lays a model's step out on a mesh."""

    rules: Rules
    batch_axes: Tuple[str, ...]     # the step's ``batch_spec``
    act_spec: PartitionSpec         # [B, T, d] activations
    state_dtype: str                # AdamW moments
    opt_rules: Rules = None         # AdamW moments (None: ``rules``)
    accum_dtype: str = "float32"    # the microbatches' gradient sum

    def __post_init__(self):
        if self.opt_rules is None:
            object.__setattr__(self, "opt_rules", self.rules)


def step_layout(n_params: int, mesh, zero1: bool = False) -> StepLayout:
    """The reference dry run's layout for a model of ``n_params`` parameters
    (``src/repro/launch/dryrun.py:62-92, 124-130``): under 1e9 parameters
    pure data parallelism (every rule ``None``, the batch over every mesh
    axis); else ``default_rules`` with FSDP and the batch over the data
    axes; over 50e9 the AdamW state and the accumulator in bf16.  With
    ``zero1`` (the reference's ``REPRO_ZERO1``, for models of neither
    extreme) the parameters are TP-only and the moments keep the FSDP rules."""
    multi = "pod" in axis_names(mesh)
    small, big = n_params < 1e9, n_params > 50e9
    rules = default_rules(multi_pod=multi)
    opt_rules = rules
    if zero1 and not small and not big:
        rules = default_rules(multi_pod=multi, fsdp=False)
    if small:
        rules = opt_rules = {k: None for k in rules}
    b_axes = ("pod", "data") if multi else ("data",)
    if small:
        b_axes = b_axes + ("model",)
    dt = "bfloat16" if big else "float32"
    return StepLayout(rules, b_axes, PS(b_axes, None, None), dt, opt_rules, dt)


def batch_spec_for(mesh, layout: StepLayout, shape: Sequence[int]) -> PartitionSpec:
    """A batch array's spec in a dry-run cell: its leading dim over the
    layout's batch axes when they divide it, else :func:`data_spec`."""
    if shape[0] % _axis_size(mesh_sizes(mesh), layout.batch_axes) == 0:
        return PS(layout.batch_axes, *([None] * (len(shape) - 1)))
    return data_spec(mesh, shape[0], len(shape))


# ---------------------------------------------------------------------------
# DTensor placements
# ---------------------------------------------------------------------------


def _entry_axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: one a mesh dim,
    ``Shard(d)`` where the mesh dim is named for tensor dim ``d``,
    ``Replicate()`` elsewhere.  Raises on an unknown axis, an axis named
    twice, or a tuple whose axes are not in the mesh's order."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out: List[Any] = [Replicate()] * len(names)
    seen: set = set()
    for d, entry in enumerate(spec):
        axes = _entry_axes(entry)
        dims = []
        for a in axes:
            if a not in names or a in seen:
                raise ValueError(f"spec {spec}: axis {a!r} unknown or used twice on {names}")
            seen.add(a)
            dims.append(names.index(a))
        if dims != sorted(dims):
            raise ValueError(f"spec {spec}: the axes {axes} of dim {d} are not in the mesh's "
                             f"order {names}")
        for i in dims:
            out[i] = Shard(d)
    return tuple(out)


def local_block(shape: Sequence[int], spec: Sequence, mesh,
                coord: Sequence[int]) -> Tuple[Tuple[int, int], ...]:
    """The ``(start, stop)`` index range of each dim that mesh coordinate
    ``coord`` holds of a tensor of ``shape`` under ``spec``: each sharded dim
    split evenly over its axes' product, the first axis major."""
    sizes = mesh_sizes(mesh)
    names = axis_names(mesh)
    out = []
    for d, n in enumerate(shape):
        axes = _entry_axes(spec[d]) if d < len(spec) else ()
        parts = _axis_size(sizes, axes)
        if n % parts:
            raise ValueError(f"dim {d} of {tuple(shape)} does not split into {parts}")
        idx = 0
        for a in axes:
            idx = idx * sizes[a] + coord[names.index(a)]
        size = n // parts
        out.append((idx * size, (idx + 1) * size))
    return tuple(out)


def local_shape(shape: Sequence[int], spec: Sequence, mesh) -> Tuple[int, ...]:
    """The shape of one rank's block (every block alike: the splits are even)."""
    return tuple(b - a for a, b in local_block(shape, spec, mesh, [0] * len(axis_names(mesh))))


def bytes_per_rank(tree, shardings) -> int:
    """The bytes one rank holds of a tree of tensors (``meta`` ones do) under
    a :class:`NamedSharding` tree of the same layout."""
    total = 0

    def walk(a, s):
        nonlocal total
        if isinstance(a, dict):
            for k in a:
                walk(a[k], s[k])
            return
        total += math.prod(local_shape(tuple(a.shape), s.spec, s.mesh)) * a.element_size()

    walk(tree, shardings)
    return total


def distribute(t: torch.Tensor, sharding: NamedSharding, requires_grad: Optional[bool] = None):
    """``t`` (the same full tensor on every rank) as a DTensor under
    ``sharding``, whose mesh must be a ``DeviceMesh``.  Its local shard
    never shares ``t``'s memory (a replicated one would: the in-place
    optimizer would then write into ``t``)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    # every rank holds ``t``: each keeps its shard, nothing is sent
    out = distribute_tensor(t.detach(), sharding.mesh, sharding.placements,
                            src_data_rank=None)
    local = out.to_local()
    if local.numel() and local.untyped_storage().data_ptr() == t.untyped_storage().data_ptr():
        out = DTensor.from_local(local.clone(), out.device_mesh, out.placements,
                                 run_check=False, shape=out.shape, stride=out.stride())
    want = t.requires_grad if requires_grad is None else requires_grad
    return out.requires_grad_(want) if out.is_floating_point() else out


def distribute_like(tree, shardings):
    """A tree of tensors as DTensors under a :class:`NamedSharding` tree of
    the same layout (:func:`tree_shardings`, :func:`cache_shardings`)."""
    if isinstance(tree, dict):
        return {k: distribute_like(tree[k], shardings[k]) for k in tree}
    return distribute(tree, shardings)


def distribute_tree(params, mesh, rules: Rules, axes):
    """A parameter tree as DTensors on ``mesh`` (a ``DeviceMesh``) under
    ``rules``, with the logical axes ``axes`` (``model.axes(cfg)``)."""
    return distribute_like(params, tree_shardings(params, axes, mesh, rules))

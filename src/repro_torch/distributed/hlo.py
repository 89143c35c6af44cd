"""The collective inventory of a step and its wire-byte accounting.

The port of the JAX package's ``distributed/hlo.py``.  The reference reads
its collectives out of the scheduled HLO text of a compiled step; the port
has no HLO, so the HLO-text parser (``parse_collectives``, ``_COLL_RE``,
``_group_size``) and ``normalize_cost_analysis`` (the shape of XLA's
``cost_analysis()``) have no counterpart.  Instead :class:`CollectiveRecorder`
sees each collective as DTensor issues it: a ``TorchDispatchMode`` that
records every functional collective (``_c10d_functional.all_gather_into_tensor``,
``reduce_scatter_tensor``, ``all_reduce``, ``all_to_all_single`` and their
``_coalesced`` forms, and DTensor's own ``_dtensor.shard_dim_alltoall``)
with its result's bytes, its group's size (resolved from the group name the
op carries) and the op's name in the reference's spelling.  It works on
real tensors over gloo or NCCL and on ``FakeTensorMode`` tensors over a fake
process group alike: it reads shapes, never data.

What carries over unchanged: the :class:`Collective` record,
:func:`wire_bytes_per_device` (ring algorithms):

  all-gather:          (g-1)/g · result_bytes
  all-reduce:        2·(g-1)/g · result_bytes
  reduce-scatter:      (g-1)/g · operand_bytes  = (g-1) · result_bytes
  all-to-all:          (g-1)/g · result_bytes
  collective-permute:            result_bytes

and :func:`collective_summary`, which takes the recorded collectives where
the reference takes HLO text.  DTensor issues no collective-permute.

:func:`alltoall_on_cpu_meshes` makes DTensor change a tensor's sharded dim
with the one all-to-all it issues on a CUDA mesh, where on a CPU mesh it
all-gathers and slices (gloo has no all-to-all): a dry run on a fake group
of CPU ranks then records the collectives of the card's mesh.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

#: functional collective → the reference's op name
_OPS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
    "shard_dim_alltoall": "all-to-all",
}
_NAMESPACES = ("_c10d_functional", "_dtensor")


@dataclasses.dataclass
class Collective:
    op: str
    bytes_result: int
    group_size: int
    line: str


def wire_bytes_per_device(c: Collective) -> float:
    g = max(c.group_size, 1)
    frac = (g - 1) / g
    if c.op == "all-reduce":
        return 2.0 * frac * c.bytes_result
    if c.op == "all-gather":
        return frac * c.bytes_result
    if c.op == "reduce-scatter":
        return (g - 1) * c.bytes_result
    if c.op == "all-to-all":
        return frac * c.bytes_result
    if c.op == "collective-permute":
        return float(c.bytes_result)
    return 0.0


def collective_summary(colls: Iterable[Collective]) -> Dict[str, float]:
    """``{"total_wire_bytes_per_device", "count", <op>: wire bytes}`` of the
    recorded collectives."""
    colls = list(colls)
    by_op: Dict[str, float] = {}
    total = 0.0
    for c in colls:
        w = wire_bytes_per_device(c)
        by_op[c.op] = by_op.get(c.op, 0.0) + w
        total += w
    return {"total_wire_bytes_per_device": total, "count": len(colls), **by_op}


def tensor_bytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_size(name) -> int:
    from torch.distributed.distributed_c10d import _resolve_process_group

    return _resolve_process_group(name).size() if isinstance(name, str) else name.size()


def collective_of(func, args, kwargs, out) -> Collective | None:
    """The :class:`Collective` that op ``func`` made of ``out``, or None when
    ``func`` is no collective."""
    if func.namespace not in _NAMESPACES:
        return None
    name = func._opname
    op = _OPS.get(name)
    if op is None:
        return None
    group = kwargs.get("group_name", args[-1])
    results = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
    inputs = [t for t in tree_leaves(args[0]) if isinstance(t, torch.Tensor)]
    size = _group_size(group)
    shapes = ", ".join(f"{str(a.dtype).removeprefix('torch.')}{list(a.shape)}->{list(r.shape)}"
                       for a, r in zip(inputs, results))
    return Collective(op, sum(tensor_bytes(r) for r in results), size,
                      f"{op} {shapes} group {size}")


class CollectiveRecorder(TorchDispatchMode):
    """Records every collective issued under it (module docstring) in
    ``collectives``.  Ops on DTensors are passed on to DTensor's dispatch,
    so the recorder sees the local ops and collectives each one becomes."""

    def __init__(self):
        super().__init__()
        self.collectives: List[Collective] = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if _has_subclass(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        c = collective_of(func, args, kwargs, out)
        if c is not None:
            self.collectives.append(c)
        return out

    def summary(self) -> Dict[str, float]:
        return collective_summary(self.collectives)


def _has_subclass(types) -> bool:
    """True when an operand is a tensor subclass other than a fake tensor
    (a DTensor): its own dispatch runs first."""
    from torch._subclasses.fake_tensor import FakeTensor

    return any(t is not torch.Tensor and not issubclass(t, FakeTensor)
               and t is not torch.nn.Parameter for t in types)


@contextlib.contextmanager
def alltoall_on_cpu_meshes():
    """Within the block, DTensor moves a shard from one tensor dim to
    another with ``_dtensor.shard_dim_alltoall`` on every mesh, as it does
    on a CUDA mesh (module docstring).  Only for fake process groups: gloo
    has no all-to-all."""
    from torch.distributed.tensor import placement_types

    original = placement_types.shard_dim_alltoall

    def alltoall(input, gather_dim, shard_dim, mesh, mesh_dim):
        name = mesh.get_group(mesh_dim).group_name
        return torch.ops._dtensor.shard_dim_alltoall(input, gather_dim, shard_dim, name)

    placement_types.shard_dim_alltoall = alltoall
    try:
        yield
    finally:
        placement_types.shard_dim_alltoall = original

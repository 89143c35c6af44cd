"""What the model does where its tensors are DTensors.

The LM substrate runs on plain tensors, one device; given DTensor
parameters (``distributed.sharding.distribute_tree``) every op of it is
dispatched by DTensor's sharding propagation, as GSPMD partitions the
reference.  Three things here:

  * :func:`constrain` — the reference's ``with_sharding_constraint``: a
    DTensor redistributed to a spec's placements; a plain tensor, or no
    spec, passes unchanged, so the one-device path is untouched.
  * :func:`einsum` — the model's products on DTensors, by a rule of the
    port's own rather than DTensor's lowering to ``bmm`` (whose views of a
    sharded dim torch 2.11 refuses, and whose strategy search cost torch
    2.13 about 0.5 s of host a new shape on a 2-D mesh): each mesh dim
    shards the index letter that the first operand sharded on it names
    (else the next operand's); every operand is redistributed to shard
    that letter where it has it and to replicate that mesh dim where it
    has not; the einsum runs on the local shards; the output is sharded
    where the letter survives and a pending sum (``Partial``) where it is
    contracted.  The gradients follow by autograd through ``to_local``
    (an operand replicated on a mesh dim that shards a letter it lacks gets
    a pending-sum gradient there) and ``from_local``.
  * :func:`embedding` — the token lookup ``table[ids]`` on DTensors, as a
    vocab-parallel lookup: a mesh dim that shards the ids replicates the
    table (the FSDP gather), one that shards the vocab looks up the rows in
    its range and leaves a pending sum, one that shards the width keeps it.
    (DTensor's own lookup and its backward, an ``index_put`` into the
    table's gradient, have no strategy on torch 2.11.)
  * :func:`along` — an op that acts along one dim only (``cumsum``), run on
    each rank's local shard: torch 2.11 has no strategy for the ``flip``
    of its backward.
  * :func:`replicated_call` — an op with no DTensor sharding strategy (or
    whose strategy would change what it computes, as the MoE dispatch's
    global capacity slots): its DTensor arguments are redistributed to
    ``Replicate()``, the op runs on the full local tensors exactly as on one
    device, and its floating outputs come back as replicated DTensors (its
    integer outputs as plain tensors, the same on every rank).  Each such
    call is counted under its name (:func:`replications`).
  * :func:`write_at` — an in-place write of a decode cache (a slot, a
    layer, or the whole leaf): on a DTensor cache each rank writes its own
    shard's part, whatever dims the cache is sharded on.
  * :func:`sharded_context` — ``implicit_replication`` when a tree holds a
    DTensor: the plain tensors the model makes (positions, masks, RoPE
    frequencies) take part as replicated.

Nothing here imports ``torch.distributed.tensor`` until a DTensor exists.
"""
from __future__ import annotations

import collections
import contextlib
import math
import sys
from typing import Any, Callable, Dict

import torch

_REPLICATED: Dict[str, int] = collections.Counter()


def is_dtensor(x) -> bool:
    mod = sys.modules.get("torch.distributed.tensor")
    return mod is not None and isinstance(x, mod.DTensor)


def any_dtensor(tree) -> bool:
    if isinstance(tree, dict):
        return any(any_dtensor(v) for v in tree.values())
    if isinstance(tree, (list, tuple)):
        return any(any_dtensor(v) for v in tree)
    return is_dtensor(tree)


def full(x: torch.Tensor) -> torch.Tensor:
    """A DTensor gathered to the plain full tensor (a collective: every
    rank of its mesh calls it); a plain tensor as it is."""
    return x.full_tensor() if is_dtensor(x) else x


def constrain(x: torch.Tensor, spec) -> torch.Tensor:
    """``x`` redistributed to ``spec``'s placements on its own mesh when it
    is a DTensor and ``spec`` is given; else ``x``."""
    if spec is None or not is_dtensor(x):
        return x
    from repro_torch.distributed.sharding import placements

    want = placements(spec, x.device_mesh)
    return x if tuple(x.placements) == want else x.redistribute(x.device_mesh, want)


def _letters(eq: str, shapes):
    """The operands' and the output's index letters, ``...`` spelled out."""
    ins, out = eq.replace(" ", "").split("->")
    ins = ins.split(",")
    spare = iter(c for c in "ABCDEFGHIJKLMNOPQRSTUVWXYZ" if c not in eq)
    ell = ""
    if any("..." in i for i in ins):
        n = max(len(s) - (len(i) - 3) for i, s in zip(ins, shapes) if "..." in i)
        ell = "".join(next(spare) for _ in range(n))
    full = []
    for i, s in zip(ins, shapes):
        if "..." in i:
            k = len(s) - (len(i) - 3)
            i = i.replace("...", ell[len(ell) - k:])
        full.append(i)
    return full, out.replace("...", ell)


def einsum(eq: str, *xs: torch.Tensor) -> torch.Tensor:
    """``torch.einsum`` where an operand is a DTensor (module docstring);
    the operands share one dtype."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = next(x.device_mesh for x in xs if is_dtensor(x))
    rep = [Replicate()] * mesh.ndim
    xs = [x if is_dtensor(x) else DTensor.from_local(x, mesh, rep, run_check=False)
          for x in xs]
    xs = [x.redistribute(mesh, [Replicate() if p.is_partial() else p for p in x.placements])
          if any(p.is_partial() for p in x.placements) else x for x in xs]
    ins, out = _letters(eq, [tuple(x.shape) for x in xs])
    plan: list = [None] * mesh.ndim
    for i in range(mesh.ndim):
        for x, letters in zip(xs, ins):
            if x.placements[i].is_shard():
                plan[i] = letters[x.placements[i].dim]
                break
    size = {c: n for x, letters in zip(xs, ins) for c, n in zip(letters, x.shape)}
    local = []
    for x, letters in zip(xs, ins):
        want = [Shard(letters.index(c)) if c is not None and c in letters else Replicate()
                for c in plan]
        if tuple(x.placements) != tuple(want):
            x = x.redistribute(mesh, want)
        grad = [Replicate() if c is None else Shard(letters.index(c)) if c in letters
                else Partial() for c in plan]
        local.append(x.to_local(grad_placements=grad))
    # contiguous: the DTensor below claims the contiguous global strides
    y = torch.einsum(eq, *local).contiguous()
    placements = [Replicate() if c is None else Shard(out.index(c)) if c in out else Partial()
                  for c in plan]
    shape = tuple(size[c] for c in out)
    stride, acc = [], 1
    for n in reversed(shape):
        stride.append(acc)
        acc *= n
    return DTensor.from_local(y, mesh, placements, run_check=False, shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def _shard_range(n: int, placements, dim: int, mesh) -> tuple:
    """``(start, stop)`` of dim ``dim`` (length ``n``) on this rank: even
    blocks over the mesh dims that shard it, major to minor."""
    coord = mesh.get_coordinate()
    parts, at = 1, 0
    for i, pl in enumerate(placements):
        if pl.is_shard(dim):
            parts *= mesh.size(i)
            at = at * mesh.size(i) + coord[i]
    size = n // parts
    return at * size, (at + 1) * size


def embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` for a DTensor ``table`` [V, d] (module docstring)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    mesh = table.device_mesh
    if not is_dtensor(ids):
        ids = DTensor.from_local(ids, mesh, [Replicate()] * mesh.ndim, run_check=False)
    want, grad, out = [], [], []
    for i in range(mesh.ndim):
        ip, tp = ids.placements[i], table.placements[i]
        if ip.is_shard():
            want.append(Replicate())
            grad.append(Partial())
            out.append(Shard(ip.dim))
        elif tp.is_shard(0):
            want.append(tp)
            grad.append(tp)
            out.append(Partial())
        elif tp.is_shard(1):
            want.append(tp)
            grad.append(tp)
            out.append(Shard(ids.ndim))
        else:
            want.append(Replicate())
            grad.append(Replicate())
            out.append(Replicate())
    if tuple(table.placements) != tuple(want):
        table = table.redistribute(mesh, want)
    lo, hi = _shard_range(table.shape[0], want, 0, mesh)
    local_ids = ids.to_local()
    rows = table.to_local(grad_placements=grad)
    if (lo, hi) == (0, table.shape[0]):
        y = rows[local_ids]
    else:
        keep = (local_ids >= lo) & (local_ids < hi)
        y = rows[torch.where(keep, local_ids - lo, 0)] * keep[..., None].to(rows.dtype)
    shape = tuple(ids.shape) + (table.shape[1],)
    return DTensor.from_local(y.contiguous(), mesh, out, run_check=False,
                              shape=torch.Size(shape),
                              stride=(*(math.prod(shape[k + 1:]) for k in range(len(shape))),))


def replicated_call(name: str, fn: Callable, *args):
    """``fn(*args)``; where an argument is a DTensor, on replicated copies
    (see the module docstring), the call counted under ``name``."""
    dts = [a for a in args if is_dtensor(a)]
    if not dts:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate

    mesh = dts[0].device_mesh
    rep = [Replicate()] * mesh.ndim
    local = [a.redistribute(mesh, rep).to_local() if is_dtensor(a) else a for a in args]
    _REPLICATED[name] += 1
    out = fn(*local)

    def wrap(t):
        if isinstance(t, torch.Tensor) and t.is_floating_point():
            return DTensor.from_local(t, mesh, rep, run_check=False)
        return t

    return tuple(wrap(t) for t in out) if isinstance(out, tuple) else wrap(out)


def along(fn: Callable, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``fn(x)`` for an op that keeps ``x``'s shape and mixes elements along
    dim ``dim`` only; on a DTensor that does not shard ``dim``, run on the
    local shard (the output, and the gradient, in ``x``'s placements)."""
    if not is_dtensor(x):
        return fn(x)
    from torch.distributed.tensor import DTensor

    if any(pl.is_shard(dim % x.ndim) for pl in x.placements):
        raise ValueError(f"dim {dim} is sharded: {x.placements}")
    return DTensor.from_local(fn(x.to_local()), x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def pinned(x: torch.Tensor) -> torch.Tensor:
    """``x``, whose gradient is redistributed to ``x``'s placements before
    it flows back (so a view before it meets the gradient in its forward's
    layout); a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor

    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())


def gather_dim(name: str, x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` with dim ``dim`` replicated where a DTensor shards it, the
    redistribution counted under ``name``; else ``x``.  For views DTensor
    has no strategy for: splitting a sharded dim unevenly (``split_dim``),
    or (torch 2.11) flattening a sharded dim into the one before it."""
    if not is_dtensor(x) or not any(pl.is_shard(dim) for pl in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    _REPLICATED[name] += 1
    return x.redistribute(x.device_mesh,
                          [Replicate() if pl.is_shard(dim) else pl for pl in x.placements])


def reduced(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every pending sum (``Partial``) reduced to ``Replicate``:
    before an op that is not linear, whose input DTensor would otherwise
    reduce-scatter onto a dim of its choosing (possibly one that does not
    split evenly); a plain tensor as it is."""
    if not is_dtensor(x) or not any(pl.is_partial() for pl in x.placements):
        return x
    from torch.distributed.tensor import Replicate

    return x.redistribute(x.device_mesh,
                          [Replicate() if pl.is_partial() else pl for pl in x.placements])


def split_dim(name: str, x: torch.Tensor, dim: int, parts: int) -> torch.Tensor:
    """``x`` with dim ``dim`` (size N) viewed as ``(parts, N // parts)``.
    Where a DTensor shards that dim over two mesh dims, or over one whose
    size does not divide ``parts`` (DTensor keeps a shard through the split
    only on the new outer dim, evenly, or on the inner one when the outer
    is 1), the dim is gathered first, counted under ``name``: a constraint
    after it then takes each rank's part without moving data."""
    if is_dtensor(x) and parts > 1:
        dims = [i for i, pl in enumerate(x.placements) if pl.is_shard(dim)]
        if len(dims) > 1 or (dims and parts % x.device_mesh.size(dims[0])):
            x = gather_dim(name, x, dim)
    shape = tuple(x.shape)
    return x.reshape(shape[:dim] + (parts, shape[dim] // parts) + shape[dim + 1:])


def write_at(dst: torch.Tensor, index: Dict[int, int], src: torch.Tensor) -> None:
    """``dst[index] = src`` in place, ``index`` ``{dim: position}`` (empty:
    the whole of ``dst``).  On a plain tensor, a ``select`` per dim and a
    ``copy_``.  On a DTensor, ``src`` is redistributed to ``dst``'s
    placements less the indexed dims, and each rank whose shard holds the
    position writes its part into its local shard."""
    if not is_dtensor(dst):
        view = dst
        for dim in sorted(index, reverse=True):
            view = view.select(dim, index[dim])
        view.copy_(src)
        return
    from torch.distributed.tensor import DTensor, Replicate, Shard

    mesh = dst.device_mesh
    if any(pl.is_partial() for pl in dst.placements):
        raise ValueError(f"a write into a DTensor with a pending sum: {dst.placements}")
    want = []
    for pl in dst.placements:
        if not pl.is_shard():
            want.append(Replicate())
        elif pl.dim in index:
            want.append(Replicate())
        else:
            want.append(Shard(pl.dim - sum(1 for d in index if d < pl.dim)))
    if not is_dtensor(src):
        src = DTensor.from_local(src, mesh, [Replicate()] * mesh.ndim, run_check=False)
    src_local = src.redistribute(mesh, want).to_local()
    view = dst.to_local()
    for dim in sorted(index, reverse=True):
        lo, hi = _shard_range(dst.shape[dim], dst.placements, dim, mesh)
        if not lo <= index[dim] < hi:
            return                  # another rank's shard holds it
        view = view.select(dim, index[dim] - lo)
    view.copy_(src_local)


def replications() -> Dict[str, int]:
    """``{op name: calls}`` of :func:`replicated_call` on DTensors so far."""
    return dict(_REPLICATED)


def sharded_context(tree) -> Any:
    """``implicit_replication()`` when ``tree`` holds a DTensor, else a
    context that does nothing."""
    if not any_dtensor(tree):
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication

    return implicit_replication()

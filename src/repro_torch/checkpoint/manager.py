"""Fault-tolerant checkpointing: atomic npz shards + manifest, restore by
template.

The port of the JAX package's ``checkpoint/manager.py``, in its on-disk
format, so that a checkpoint written by either package restores in the
other:

  * ``step_{N:010d}/`` holds ``host0.npz`` and ``manifest.json`` (``step``,
    ``time``, ``keys``, ``dtypes``, ``extra``, ``format: 1``);
  * the npz keys are the reference's tree-path strings joined with ``/``:
    a dict key is spelled ``['k']``, a ``NamedTuple`` field ``.f`` and a
    list index ``[i]`` (``"['opt']/.m/['embed']"``);
  * bf16 and fp8 leaves are stored as ``uint16``/``uint8`` views with their
    real dtype in ``dtypes`` (numpy's npz cannot hold them); the port views
    them through torch, without ``ml_dtypes``;
  * **atomic**: a save writes ``step_N.tmp/`` then ``os.replace``s it, so a
    crash mid-save never corrupts the latest checkpoint; stale ``.tmp``
    directories are removed at the next save;
  * **retention**: the newest ``keep`` checkpoints stay;
  * **sharded states**: a state holding DTensors is saved by every rank of
    its group together: each leaf gathered, the checkpoint written by rank
    0 alone in the same format (``save``).

``restore(template, step, device, shardings)`` takes a tree of tensors
(``meta`` tensors from ``models.model.abstract`` do: nothing is allocated
for them) and returns the same tree read from disk, each leaf checked
against the template's shape (``ValueError``), cast to its dtype and put on
``device`` (CUDA unless the caller names another), where the reference
takes ``ShapeDtypeStruct``s.  With ``shardings`` (the reference's re-shard
onto a mesh) each leaf becomes a DTensor: a tree of the same layout of
``distributed.sharding.NamedSharding``s, each a spec on a ``DeviceMesh``
(``tree_shardings``; ``replicated(mesh)`` for the step), a ``None`` leaf
staying a plain tensor.  Every rank reads the whole array and keeps its
shard, as the reference's ``device_put``; the format on disk is the same.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Callable, Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import device as device_mod
from repro_torch.distributed.dtensor import full, is_dtensor

#: dtypes numpy cannot hold: stored as unsigned views of their width, and
#: read back through a view torch takes from numpy
_EXOTIC = {"bfloat16": torch.bfloat16, "float8_e4m3fn": torch.float8_e4m3fn,
           "float8_e5m2": torch.float8_e5m2}
_STORED = {2: np.uint16, 1: np.uint8}
_READ = {2: (np.int16, torch.int16), 1: (np.uint8, torch.uint8)}


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def map_with_path(fn: Callable[[str, Any], Any], tree, path: str = ""):
    """``fn(key, leaf)`` for every leaf, the tree rebuilt around the results;
    ``key`` is the reference's path string (``jax.tree_util`` keys joined
    with ``/``).  Dicts, ``NamedTuple``s, lists and tuples are nodes."""
    def sub(spelled):
        return f"{path}/{spelled}" if path else spelled

    if isinstance(tree, dict):
        return {k: map_with_path(fn, tree[k], sub(f"[{k!r}]")) for k in sorted(tree)}
    if _is_namedtuple(tree):
        return type(tree)(*(map_with_path(fn, getattr(tree, f), sub(f".{f}"))
                            for f in tree._fields))
    if isinstance(tree, (list, tuple)):
        return type(tree)(map_with_path(fn, v, sub(f"[{i}]")) for i, v in enumerate(tree))
    return fn(path, tree)


def flatten(tree) -> Dict[str, Any]:
    """``{path string: leaf}`` of a tree."""
    out: Dict[str, Any] = {}

    def put(key, leaf):
        out[key] = leaf

    map_with_path(put, tree)
    return out


def _to_numpy(leaf) -> Tuple[np.ndarray, str]:
    """A leaf as the array stored in the npz, and its real dtype's name."""
    if not isinstance(leaf, torch.Tensor):
        a = np.asarray(leaf)
        return a, str(a.dtype)
    t = leaf.detach().cpu()
    name = str(t.dtype).removeprefix("torch.")
    if name in _EXOTIC:
        size = t.element_size()
        return t.contiguous().view(_READ[size][1]).numpy().view(_STORED[size]), name
    return t.numpy(), name


def _to_tensor(arr: np.ndarray, saved: str) -> torch.Tensor:
    """The stored array as a tensor of its real dtype ``saved``."""
    if saved in _EXOTIC:
        dt = _EXOTIC[saved]
        return torch.from_numpy(np.ascontiguousarray(arr).view(_READ[dt.itemsize][0])).view(dt)
    return torch.from_numpy(arr)


class CheckpointManager:
    def __init__(self, directory: str | os.PathLike, keep: int = 3):
        self.dir = Path(directory)
        self.dir.mkdir(parents=True, exist_ok=True)
        self.keep = keep

    # -- save -----------------------------------------------------------------
    def save(self, step: int, state: Dict[str, Any], extra: Optional[Dict] = None) -> Path:
        """state: a tree of tensors (params/opt/...); extra: JSON-serializable.

        A state holding DTensors (a sharded step's) is a collective: every
        rank of the group calls ``save``, each DTensor leaf is gathered on
        every rank, rank 0 alone writes the checkpoint, and every rank
        returns once it is in place (and raises if rank 0 failed)."""
        flat = flatten(state)
        if not any(is_dtensor(v) for v in flat.values()):
            return self._write(step, flat, extra)
        import torch.distributed as dist

        flat = {k: full(v) for k, v in flat.items()}
        final, error = self.dir / f"step_{step:010d}", None
        if dist.get_rank() == 0:
            try:
                self._write(step, flat, extra)
            except Exception as e:   # told to every rank below, then raised
                error = f"{type(e).__name__}: {e}"
        said = [error]
        dist.broadcast_object_list(said, src=0)
        if said[0] is not None:
            raise RuntimeError(f"checkpoint step {step} not written by rank 0: {said[0]}")
        return final

    def _write(self, step: int, flat: Dict[str, Any], extra: Optional[Dict]) -> Path:
        tmp = self.dir / f"step_{step:010d}.tmp"
        final = self.dir / f"step_{step:010d}"
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        arrays, dtypes = {}, {}
        for k, v in flat.items():
            arrays[k], dtypes[k] = _to_numpy(v)
        np.savez(tmp / "host0.npz", **arrays)
        manifest = {
            "step": step,
            "time": time.time(),
            "keys": sorted(arrays.keys()),
            "dtypes": dtypes,
            "extra": extra or {},
            "format": 1,
        }
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        os.replace(tmp, final)  # atomic on POSIX
        self._gc()
        return final

    def _gc(self):
        steps = sorted(self.all_steps())
        for s in steps[: -self.keep] if self.keep else []:
            shutil.rmtree(self.dir / f"step_{s:010d}", ignore_errors=True)
        # remove stale tmp dirs from crashed saves
        for t in self.dir.glob("*.tmp"):
            shutil.rmtree(t, ignore_errors=True)

    # -- restore ---------------------------------------------------------------
    def all_steps(self):
        out = []
        for p in self.dir.glob("step_*"):
            if p.suffix == ".tmp" or not (p / "manifest.json").exists():
                continue
            out.append(int(p.name.split("_")[1]))
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template, step: Optional[int] = None,
                device: str | torch.device | None = None,
                shardings=None) -> Tuple[Any, Dict]:
        """The tree of ``template`` read from checkpoint ``step`` (the latest
        when ``None``) onto ``device``, and the manifest's ``extra``.  A
        leaf whose saved shape differs from the template's raises
        ``ValueError``; a leaf of another dtype is cast to the template's.
        ``shardings``: a tree like ``template`` of ``NamedSharding``s onto
        which each leaf is distributed (module docstring)."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        dev = device_mod.resolve(device)
        path = self.dir / f"step_{step:010d}"
        manifest = json.loads((path / "manifest.json").read_text())
        dtypes = manifest.get("dtypes", {})
        flat_shard = flatten(shardings) if shardings is not None else {}
        with np.load(path / "host0.npz") as data:
            def load(key, tmpl):
                arr = data[key]
                t = _to_tensor(arr, dtypes.get(key, str(arr.dtype)))
                if tuple(t.shape) != tuple(tmpl.shape):
                    raise ValueError(f"{key}: shape {tuple(t.shape)} != {tuple(tmpl.shape)}")
                t = t.to(device=dev, dtype=tmpl.dtype)
                sharding = flat_shard.get(key)
                if sharding is None:
                    return t
                from repro_torch.distributed.sharding import distribute

                return distribute(t, sharding, requires_grad=False)

            state = map_with_path(load, template)
        return state, manifest["extra"]

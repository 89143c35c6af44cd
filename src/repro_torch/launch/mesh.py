"""Production and debug meshes for the LM substrate.

The port of the JAX package's ``launch/mesh.py``.  A FUNCTION, not a module
constant: importing this module touches no process group.

  * :func:`make_production_mesh` — 16×16 ``("data", "model")`` (256 ranks, a
    pod) or 2×16×16 ``("pod", "data", "model")`` (512 ranks);
  * :func:`make_debug_mesh` — ``data × model`` for the tests on gloo ranks.

Both are ``DeviceMesh``es (``init_device_mesh``) on the process group that
is up, whose world must be the mesh's size: 256 or 512 ranks for the
production meshes (a fake process group of that world serves a dry run).
:class:`MeshShape` (:func:`production_shape`, :func:`debug_shape`) is the
same layout without a process group: the sharding rules
(``distributed.sharding``) read only its axis sizes.

The reference's ``make_miner_mesh`` (a 1-D ``("miners",)`` mesh for the
mining launchers) and ``launch/host_devices.py`` (host devices forked before
JAX starts) have their counterpart in ``launch/ranks.py``: a miner is a rank
of a ``torch.distributed`` group, which needs no mesh and no forked devices.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple



@dataclasses.dataclass(frozen=True)
class MeshShape:
    """A mesh's named axes and sizes, major to minor, with no devices: what
    ``spec_for`` and the other rules read (``shape[name]``, ``axis_names``)."""

    axis_names: Tuple[str, ...]
    sizes: Tuple[int, ...]

    @property
    def shape(self) -> Dict[str, int]:
        return dict(zip(self.axis_names, self.sizes))

    @property
    def size(self) -> int:
        n = 1
        for s in self.sizes:
            n *= s
        return n


def production_shape(*, multi_pod: bool = False) -> MeshShape:
    """16×16 = 256 ranks a pod; 2 pods = 512 with a leading "pod" axis."""
    if multi_pod:
        return MeshShape(("pod", "data", "model"), (2, 16, 16))
    return MeshShape(("data", "model"), (16, 16))


def debug_shape(data: int = 2, model: int = 2, pod: int | None = None) -> MeshShape:
    """``data × model``, or ``pod × data × model`` with ``pod``."""
    if pod is not None:
        return MeshShape(("pod", "data", "model"), (pod, data, model))
    return MeshShape(("data", "model"), (data, model))


def device_mesh(shape: MeshShape, device_type: str | None = None):
    """``shape`` as a ``DeviceMesh`` on the process group that is up (its
    world must be ``shape.size``); ``device_type`` defaults to the group's
    (``cuda`` under NCCL, ``cpu`` otherwise)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    if not dist.is_initialized():
        raise RuntimeError(f"a {shape.sizes} mesh needs a process group of world "
                           f"{shape.size}; none is up")
    if dist.get_world_size() != shape.size:
        raise ValueError(f"a {shape.sizes} mesh needs a world of {shape.size}, the process "
                         f"group has {dist.get_world_size()}")
    if device_type is None:
        device_type = "cuda" if dist.get_backend() == "nccl" else "cpu"
    return init_device_mesh(device_type, shape.sizes, mesh_dim_names=shape.axis_names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str | None = None):
    """The production ``DeviceMesh``: 16×16 or 2×16×16."""
    return device_mesh(production_shape(multi_pod=multi_pod), device_type)


def make_debug_mesh(data: int = 2, model: int = 2, device_type: str | None = None):
    """A small ``("data", "model")`` ``DeviceMesh`` (world ``data·model``)."""
    return device_mesh(debug_shape(data, model), device_type)

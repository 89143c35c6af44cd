"""Rank processes for ``--devices N``: one miner a rank of a
``torch.distributed`` group.

The port's counterpart of the JAX package's ``launch/host_devices.py`` (which
forks host devices before JAX starts) and ``launch/mesh.py`` (the miner
mesh).  A launcher given ``--devices N`` with N ≥ P runs as P rank processes
on loopback, one miner each (:class:`~repro_torch.core.phases.DistCollectives`);
with N < P, or N = 0, the local backend runs, P miners stacked on one device,
as the reference's launchers fall back to ``vmap`` when fewer than P devices
exist.

  * :func:`from_flags` is what a launcher calls with its ``--devices``:
    nothing to do (None); or, outside a rank, spawn the P ranks of the
    launcher and exit with their code; or, in a rank, join the group and
    return its collectives.
  * :func:`spawn` starts the ranks, each with ``RANK``, ``WORLD_SIZE``,
    ``LOCAL_RANK``, ``MASTER_ADDR`` and ``MASTER_PORT`` set as ``torchrun``
    sets them; rank 0's output is the launcher's, the other ranks' standard
    output is discarded.  If a rank fails, the others are killed and the
    exit code is the failed rank's: nothing waits on a dead peer.
  * In a rank (:func:`in_rank`: that environment, from :func:`spawn` or from
    ``torchrun``), :func:`collectives` joins the group.  The backend follows
    the device, as the kernel dispatch does: NCCL on CUDA, rank r on
    ``cuda:LOCAL_RANK``; gloo on the CPU.  Nothing falls back: NCCL failing to
    start raises, and so does asking for more CUDA devices than there are.
"""
from __future__ import annotations

import datetime
import os
import socket
import subprocess
import sys
import time
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch import device as device_mod
from repro_torch.core import phases

#: how long a collective may wait on a peer before the group gives up
GROUP_TIMEOUT_S = 600


def in_rank() -> bool:
    """True in a rank process (``RANK`` and ``WORLD_SIZE`` set)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def wants_ranks(devices: int, P: int) -> bool:
    """``--devices N`` asks for one rank a miner when N ≥ P (and N > 0)."""
    return devices > 0 and devices >= P


def check_devices(devices: int, device: str | torch.device | None) -> None:
    """Raise when ``--devices N`` asks for more CUDA devices than there are."""
    dev = device_mod.resolve(device)
    if dev.type == "cuda" and devices > torch.cuda.device_count():
        raise RuntimeError(f"--devices {devices} asks for more CUDA devices than the "
                           f"{torch.cuda.device_count()} there are")


def _free_port() -> int:
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn(cmd: Sequence[str], world: int, *, timeout: Optional[float] = None,
          env: Optional[dict] = None) -> int:
    """Run ``cmd`` as ``world`` ranks on loopback; their exit code.

    ``env`` (default: this process's environment) gets the rank variables.
    0 when every rank exits 0.  The first rank to fail (or the time limit,
    exit code 124) ends the run: the ranks still alive are killed.
    """
    port = _free_port()
    procs: List[subprocess.Popen] = []
    t0 = time.monotonic()
    try:
        for r in range(world):
            rank_env = dict(os.environ if env is None else env, RANK=str(r),
                            WORLD_SIZE=str(world), LOCAL_RANK=str(r),
                            MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
            procs.append(subprocess.Popen(
                list(cmd), env=rank_env, stdout=None if r == 0 else subprocess.DEVNULL))
        while True:
            codes = [p.poll() for p in procs]
            failed = [c for c in codes if c not in (None, 0)]
            if failed:
                return failed[0]
            if all(c == 0 for c in codes):
                return 0
            if timeout is not None and time.monotonic() - t0 > timeout:
                return 124
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()


def collectives(P: int, device: str | torch.device | None) -> phases.DistCollectives:
    """Join the rank group of this process (one miner a rank, P ranks).

    NCCL for ``device`` CUDA, on ``cuda:LOCAL_RANK``; gloo for the CPU.
    Raises when the environment's world is not P or the device is missing.
    """
    import torch.distributed as dist

    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    if world != P:
        raise ValueError(f"{world} ranks for P={P} miners: one miner a rank")
    dev = device_mod.resolve(device)
    # env:// reads MASTER_ADDR and MASTER_PORT, and under torchrun joins its
    # agent's store instead of starting one
    init = dict(init_method="env://", world_size=world, rank=rank,
                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", rank))
        if local >= torch.cuda.device_count():
            raise RuntimeError(f"rank {rank} wants cuda:{local}, but there are "
                               f"{torch.cuda.device_count()} CUDA devices")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        # device_id starts NCCL now, so a failure raises here
        dist.init_process_group("nccl", device_id=dev, **init)
    else:
        dist.init_process_group("gloo", **init)
    return phases.DistCollectives(P, dev)


def from_flags(module: str, argv: Optional[Sequence[str]], devices: int, P: int,
               device: str | torch.device | None,
               prepare: Optional[Callable[[List[str]], List[str]]] = None,
               ) -> Optional[phases.DistCollectives]:
    """What ``--devices N`` asks of the launcher ``module`` run with ``argv``
    (None: ``sys.argv[1:]``).

    None when N < P or N = 0: the P miners share one device.  Outside a
    rank, spawn P ranks of the launcher and exit with their code; with
    ``prepare`` the ranks run with ``prepare(argv)`` instead, which may do
    once what the ranks must not each do (make the on-disk store they all
    read).  In a rank, join the group and return its collectives; every
    rank but 0 prints nothing (``torchrun`` would show them all).
    """
    if not wants_ranks(devices, P):
        return None
    if not in_rank():
        check_devices(devices, device)
        argv = list(sys.argv[1:] if argv is None else argv)
        if prepare is not None:
            argv = prepare(argv)
        sys.stdout.flush()
        raise SystemExit(spawn([sys.executable, "-m", module, *argv], P))
    coll = collectives(P, device)
    if coll.rank != 0:
        sys.stdout = open(os.devnull, "w")
    return coll


def finish() -> None:
    """Leave the rank group."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()

"""Device resolution for the port's entry points.

The card is the default.  The CPU is used only when the caller asks for it;
without CUDA and without that request, an entry point raises instead of
falling back.
"""
from __future__ import annotations

import numpy as np
import torch


def resolve(device: str | torch.device | None = None) -> torch.device:
    """The device to run on: ``cuda`` unless the caller names another.

    Raises ``RuntimeError`` when CUDA is asked for (or defaulted to) and is
    not available.
    """
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' (--device cpu) to run "
            "on the CPU"
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def synchronize(device: torch.device) -> None:
    """Wait for the device's queued work (a no-op on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def generator(device: torch.device, seed: int, *stream: int) -> torch.Generator:
    """A generator on ``device`` for one stream of a run's draws, derived from
    the run seed (one stream per miner, or per use; a stream may take more
    than one number, such as a use and a step)."""
    state = np.random.SeedSequence([seed & 0xFFFFFFFF, *stream]).generate_state(1)[0]
    return torch.Generator(device=device).manual_seed(int(state))

#!/usr/bin/env python3
"""Where a training step of llama3.2-3b at full config spends its time on
the card.

  python3 probes/lm_train_profile.py [--steps 2] [--warmup 2]   # one card

The training launcher's step (``steps.make_train_step``: bf16 parameters,
f32 AdamW state, block remat, batch 8 x seq 128, accum 1) on the
launcher's first batches, ``--warmup`` steps untimed, then ``--steps``
steps under ``torch.profiler``: each step's wall (host clock, device
synchronised), the device's busy time and share of the wall (the union of
the kernels' intervals), and the device time by kind of kernel: matrix
products (``gemm``/``cutlass``/``sm90`` in the name), the optimizer's and
the model's elementwise and reduction kernels, copies and fills.  One JSON
object, then the card's ``nvidia-smi`` line.
"""
from __future__ import annotations

import argparse
import collections
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def kind(name: str) -> str:
    n = name.lower()
    if any(k in n for k in ("gemm", "cutlass", "sm90_xmma", "cublas", "nvjet")):
        return "matmul"
    if "memcpy" in n or "memset" in n or "copy" in n or "fill" in n:
        return "copy_fill"
    if "reduce" in n or "norm" in n or "softmax" in n or "sum" in n:
        return "reduce"
    if "elementwise" in n or "vectorized" in n or "unrolled" in n:
        return "elementwise"
    return "other"


def busy_ms(intervals) -> float:
    """The length of the union of ``(start, end)`` intervals, in ms."""
    total, end = 0.0, None
    for s, e in sorted(intervals):
        if end is None or s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total / 1e3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--warmup", type=int, default=2)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm_pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.models import steps
    from repro_torch.optim import adamw

    if not torch.cuda.is_available():
        sys.exit("lm_train_profile: CUDA is not available")
    dev = torch.device("cuda")
    cfg = get_config("llama3.2-3b")
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=200)
    params = M.init(cfg, 0, dev).params()
    opt = adamw.init(params, opt_cfg)
    step_fn = steps.make_train_step(cfg, opt_cfg)
    pipe = SyntheticLM(cfg.vocab, 128, 8, seed=1)
    for i in range(args.warmup):
        params, opt, _ = step_fn(params, opt, train.make_batch(cfg, pipe.next_batch(), i, 0, dev))
    torch.cuda.synchronize()
    walls = []
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(args.steps):
            ts = time.perf_counter()
            batch = train.make_batch(cfg, pipe.next_batch(), args.warmup + i, 0, dev)
            params, opt, m = step_fn(params, opt, batch)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - ts)
        wall = time.perf_counter() - t0
    by_kind = collections.Counter()
    launches = collections.Counter()
    intervals = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            k = kind(ev.name)
            by_kind[k] += (ev.time_range.end - ev.time_range.start) / 1e3
            launches[k] += 1
            intervals.append((ev.time_range.start, ev.time_range.end))
    busy = busy_ms(intervals)
    top = sorted(((e.device_time_total / 1e3, e.count, e.key) for e in prof.key_averages()
                  if e.device_time_total > 0), reverse=True)[:12]
    print(json.dumps({"steps": args.steps, "step_walls_s": walls, "wall_s": wall,
                      "device_busy_ms": busy, "busy_share": busy / (wall * 1e3),
                      "device_ms_by_kind": dict(by_kind), "kernels_by_kind": dict(launches),
                      "top_kernels_ms_count": top,
                      "peak_mem_bytes": torch.cuda.max_memory_allocated()}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The gradient norm of llama3.2-3b's training loss against depth, at the
config's full width, in f32 and in bf16.

  python3 probes/lm_grad_depth.py [--depths 1,2,4,8,16,28]   # one card

For each depth the config is cut to that many layers, its weights drawn
from seed 0 (the reference's init laws) in each dtype, and one batch of the
training launcher's stream (``SyntheticLM`` at seed 1, batch 8 x seq 128)
goes through ``steps.value_and_grad`` with block remat.  It prints one JSON
object a depth and dtype: the loss, the global grad norm, the three largest
leaf norms, the step's wall, and last the card's ``nvidia-smi`` line.  TF32
is off, so f32 is f32.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--depths", default="1,2,4,8,16,28")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm_pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.models import steps
    from repro_torch.models.layers import leaves
    from repro_torch.optim import adamw

    if not torch.cuda.is_available():
        sys.exit("lm_grad_depth: CUDA is not available")
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    base = get_config("llama3.2-3b")
    b = SyntheticLM(base.vocab, 128, 8, seed=1).batch_at(0)
    for depth in (int(d) for d in args.depths.split(",")):
        for dtype in ("float32", "bfloat16"):
            cfg = dataclasses.replace(base, n_layers=depth, param_dtype=dtype)
            params = M.init(cfg, 0, dev).params()
            batch = train.make_batch(cfg, b, 0, 0, dev)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            loss, grads = steps.value_and_grad(cfg, params, batch)
            norm = float(adamw.global_norm(grads))
            wall = time.perf_counter() - t0
            per_leaf = sorted(((float(g.float().norm()), "/".join(p)) for p, g in leaves(grads)),
                              reverse=True)[:3]
            print(json.dumps({"depth": depth, "dtype": dtype, "loss": float(loss),
                              "grad_norm": norm, "largest_leaves": per_leaf, "wall_s": wall}),
                  flush=True)
            del params, grads
            torch.cuda.empty_cache()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip(), flush=True)


if __name__ == "__main__":
    main()

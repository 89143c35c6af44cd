"""Training launcher of the LM substrate: config → data → train loop →
checkpoints.

  python -m repro_torch.launch.train --arch llama3.2-3b --smoke --steps 200 --device cpu
  python -m repro_torch.launch.train --arch llama3.2-3b --steps 6    # full config, the card

The JAX package's ``launch/train.py``, its flags and loop: AdamW with 20
warmup steps over ``--steps``, the ``SyntheticLM`` stream at seed 1, an
atomic checkpoint every ``--ckpt-every`` steps (the newest two kept) with
the pipeline's cursor in its manifest, and with ``--resume`` a restart from
the latest complete checkpoint.  The checkpoint format is the reference's,
so either package resumes the other's directory.  It runs on the card
unless ``--device cpu`` is given; without CUDA and without that flag it
raises.  ``--seed`` draws the initial weights (the port's generator, the
reference's init laws).

By design: a VLM's batches carry zero ``vision_embeds``, as in the
reference; an enc-dec model's ``frames`` come from a torch generator seeded
by ``(seed, step)`` where the reference folds ``step`` into its threefry
key.  A resumed run restores onto the ``meta`` template of the config
instead of initialising weights first.

:func:`train` is the loop, callable with a config; it returns each step's
loss, grad norm, learning rate and wall.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time
from typing import Callable, List, Optional, Sequence

import torch

from repro_torch import device as device_mod
from repro_torch.checkpoint.manager import CheckpointManager
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.registry import all_archs, get_config
from repro_torch.data.lm_pipeline import SyntheticLM
from repro_torch.models import model as M
from repro_torch.models import steps as steps_mod
from repro_torch.optim import adamw

#: the generator stream of the enc-dec frames (``device.generator``)
FRAMES_STREAM = 3


@dataclasses.dataclass
class StepRecord:
    step: int
    loss: float
    grad_norm: float
    lr: float
    wall_s: float       # the train step, device synchronised


@dataclasses.dataclass
class TrainRun:
    cfg: ModelConfig
    opt_cfg: adamw.AdamWConfig
    n_params: int
    start: int          # the first step run (after a resume, the one after the checkpoint)
    records: List[StepRecord]
    params: dict
    opt: adamw.AdamWState


def make_batch(cfg: ModelConfig, b, step: int, seed: int, device: torch.device):
    """A pipeline batch (numpy) as the step's tensors on ``device``, with the
    stubbed frontends' inputs."""
    out = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
    B = b["tokens"].shape[0]
    if cfg.family == "vlm":
        out["vision_embeds"] = torch.zeros((B, cfg.vision_tokens, cfg.d_model),
                                           dtype=torch.float32, device=device)
    if cfg.family == "encdec":
        g = device_mod.generator(device, seed, FRAMES_STREAM, step)
        out["frames"] = torch.randn((B, cfg.enc_context, cfg.d_model), generator=g,
                                    device=device)
    return out


def train(cfg: ModelConfig, *, steps: int = 200, batch: int = 8, seq: int = 128,
          accum: int = 1, lr: float = 1e-3, ckpt_dir: Optional[str] = None,
          ckpt_every: int = 50, resume: bool = False, seed: int = 0,
          device: str | torch.device | None = None,
          log: Callable[[str], None] = print) -> TrainRun:
    """The launcher's loop; no checkpoints when ``ckpt_dir`` is ``None``."""
    dev = device_mod.resolve(device)
    opt_cfg = adamw.AdamWConfig(lr=lr, warmup_steps=20, total_steps=steps)
    n = M.n_params(cfg)
    n_dev = torch.cuda.device_count() if dev.type == "cuda" else 1
    log(f"arch={cfg.name} params={n / 1e6:.1f}M devices={n_dev}")

    pipe = SyntheticLM(cfg.vocab, seq, batch, seed=1)
    mgr = CheckpointManager(ckpt_dir, keep=2) if ckpt_dir is not None else None
    start = 0
    if resume and mgr is not None and mgr.latest_step() is not None:
        abstract = M.abstract(cfg)
        template = {"params": abstract, "opt": adamw.init(abstract, opt_cfg)}
        state, extra = mgr.restore(template, device=dev)
        params, opt = state["params"], state["opt"]
        pipe.load_state_dict(extra["pipeline"])
        start = extra["step"] + 1
        log(f"resumed from step {extra['step']}")
    else:
        params = M.init(cfg, seed, dev).params()
        opt = adamw.init(params, opt_cfg)

    step_fn = steps_mod.make_train_step(cfg, opt_cfg, accum=accum)
    records: List[StepRecord] = []
    t0 = time.perf_counter()
    tokens_done = 0
    for step in range(start, steps):
        b = pipe.next_batch()
        bt = make_batch(cfg, b, step, seed, dev)
        ts = time.perf_counter()
        params, opt, metrics = step_fn(params, opt, bt)
        device_mod.synchronize(dev)
        wall = time.perf_counter() - ts
        rec = StepRecord(step, float(metrics["loss"]), float(metrics["grad_norm"]),
                         float(metrics["lr"]), wall)
        records.append(rec)
        tokens_done += b["tokens"].size
        if step % 10 == 0 or step == steps - 1:
            dt = time.perf_counter() - t0
            log(f"step {step:5d} loss {rec.loss:7.4f} gnorm {rec.grad_norm:8.3f} "
                f"lr {rec.lr:.2e} tok/s {tokens_done / max(dt, 1e-9):,.0f}")
        if mgr is not None and step % ckpt_every == 0 and step > start:
            mgr.save(step, {"params": params, "opt": opt},
                     extra={"step": step, "pipeline": pipe.state_dict()})
    log("done")
    return TrainRun(cfg, opt_cfg, n, start, records, params, opt)


def main(argv: Optional[Sequence[str]] = None) -> TrainRun:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3.2-3b", choices=all_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--accum", type=int, default=1)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    cfg = get_config(args.arch, smoke=args.smoke)
    return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq, accum=args.accum,
                 lr=args.lr, ckpt_dir=args.ckpt_dir, ckpt_every=args.ckpt_every,
                 resume=args.resume, seed=args.seed, device=args.device,
                 log=lambda line: print(line, flush=True))


if __name__ == "__main__":
    main()

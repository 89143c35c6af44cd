#!/usr/bin/env python3
"""The sharded LM step on a real 2×2 ``("data", "model")`` mesh of four
ranks, against the one-device step on the same weights, for seven smoke
configs (one a kind of block).

  python3 probes/lm_shard_mesh.py [--device cuda|cpu] [--archs A,B,...]

Outside a rank it spawns four ranks (``launch/ranks.spawn``: NCCL on four
cards, one each; gloo on the CPU) and prints rank 0's JSON line.  In each
rank, for each smoke config in f32: the parameters from seed 0 (the same on
every rank), the batch of 8 × 8 from numpy; the one-device gradients
(``accumulated_grads``, accum 2), prefill of 4 rows and two decode steps on
plain tensors; then the same with the parameters distributed under the dry
run's layout of the full config (``sharding.step_layout``; ``batch_spec``,
``act_spec``, ``cache_shardings``), gathered and compared: the loss within
1e-5, each leaf's gradient within 1e-3 of its max |g| (whisper 1e-2), the
logits and the cache within 1e-4 of their max, each gradient in its
parameter's placements; last, one train step (AdamW, lr 1e-3, accum 2) on
both, to ``tests/torch_lm_train_parity``'s bounds: the loss, the grad norm
within 1e-4 relative (whisper 1e-2), lr equal, the parameters within 2 lr
with under 1 % of their elements beyond 1e-6, m and v within twice the
gradient's bound of each leaf's max.  Each config's walls (first sharded
call, warm sharded and plain gradients, the sharded train step), the ops run on replicated copies, and the
backend are printed; a config that raises is reported with its error and
the next one runs.  Exits 1 when a bound is missed or a config raised.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import os
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

ARCHS = ("llama3.2-3b", "minicpm3-4b", "olmoe-1b-7b", "mamba2-1.3b",
         "jamba-1.5-large-398b", "whisper-small", "internvl2-26b")
#: jamba's smoke config cut to one super-block (every kind of sublayer)
CHANGES = {"jamba-1.5-large-398b": {"n_layers": 4}}
LOSS_TOL, GRAD_REL, NORM_REL, LOGIT_REL, PARAM_SHARE = 1e-5, 1e-3, 1e-4, 1e-4, 0.01
OPT = {"lr": 1e-3, "warmup_steps": 1}
COND = {"whisper-small": 1e-2}
B, T, ACCUM, MAX_LEN, DECODE_STEPS = 8, 8, 2, 16, 2


def share(got: torch.Tensor, want: torch.Tensor) -> float:
    d = (got.double() - want.double()).abs().max()
    return float(d) / max(float(want.double().abs().max()), 1e-30)


def run_arch(arch, mesh, dev):
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import dtensor
    from repro_torch.distributed import sharding as shd
    from repro_torch.models import model as M
    from repro_torch.models import steps
    from repro_torch.models.layers import leaves, map_tree
    from repro_torch.optim import adamw

    cfg = dataclasses.replace(get_config(arch, smoke=True), **CHANGES.get(arch, {}))
    layout = shd.step_layout(M.n_params(get_config(arch)), mesh)
    params = M.init(cfg, 0, dev).params()
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, T)),
             "loss_mask": rng.random((B, T - 1)) < 0.8}
    if cfg.family == "vlm":
        batch["vision_embeds"] = rng.standard_normal((B, cfg.vision_tokens, cfg.d_model))
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal((B, cfg.enc_context, cfg.d_model))
    batch = {k: torch.from_numpy(v).to(dev, torch.float32 if v.dtype == np.float64 else None)
             for k, v in batch.items()}
    n = B // ACCUM
    pre = {k: v[:n] for k, v in batch.items() if k != "loss_mask"}

    def dist_batch(b):
        return {k: shd.distribute(v, shd.NamedSharding(
            mesh, shd.batch_spec_for(mesh, layout, tuple(v.shape))), requires_grad=False)
            for k, v in b.items()}

    def timed(fn):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        out = fn()
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return out, time.perf_counter() - t0

    def decode(p, cache, tok):
        if cfg.family == "encdec":
            with torch.no_grad(), dtensor.sharded_context(p):
                M.encode(cfg, p, tok("frames"), cache)
        serve = steps.make_serve_step(cfg)
        out = []
        for pos in range(DECODE_STEPS):
            logits, cache = serve(p, cache, tok("tokens")[:, pos:pos + 1], pos)
            out.append(dtensor.full(logits))
        return out, cache

    row = {}
    # a copy for the plain train step, which updates its weights in place
    fresh = M.LM(cfg, map_tree(lambda t: t.detach().clone(), params)).params()
    (loss_p, g_p), row["grads_plain_s"] = timed(
        lambda: steps.accumulated_grads(cfg, params, batch, ACCUM))
    pre_p = steps.make_prefill_step(cfg)(params, pre)
    dec_p, cache_p = decode(params, M.init_cache(cfg, n, MAX_LEN, torch.float32, dev),
                            lambda k: pre[k])
    dparams = shd.distribute_tree(params, mesh, layout.rules, M.axes(cfg))
    sharded = (lambda: steps.accumulated_grads(
        cfg, dparams, dist_batch(batch), ACCUM, batch_spec=layout.batch_axes,
        act_spec=layout.act_spec))
    (loss_s, g_s), row["grads_sharded_first_s"] = timed(sharded)
    _, row["grads_sharded_warm_s"] = timed(sharded)
    g_s = dict(leaves(g_s))
    row["placements_equal"] = all(tuple(g_s[k].placements) == tuple(p.placements)
                                  for k, p in leaves(dparams))
    row["loss_diff"] = abs(float(loss_p) - float(dtensor.full(loss_s)))
    row["worst_grad_share"] = max(share(dtensor.full(g_s[k]), g) for k, g in leaves(g_p))
    dpre = dist_batch(pre)
    pre_s = steps.make_prefill_step(cfg, act_spec=layout.act_spec)(dparams, dpre)
    row["prefill_share"] = share(dtensor.full(pre_s), pre_p)
    cache = M.init_cache(cfg, n, MAX_LEN, torch.float32, dev)
    cache = shd.distribute_like(cache, shd.cache_shardings(cache, mesh))
    tok = shd.NamedSharding(mesh, shd.data_spec(mesh, n, 2))
    dec_s, cache_s = decode(dparams, cache, lambda k: dpre[k] if k == "frames" else
                            shd.distribute(pre[k], tok, requires_grad=False))
    row["decode_share"] = max(share(s, p) for s, p in zip(dec_s, dec_p))
    flat_p = dict(leaves(cache_p))
    row["cache_share"] = max(share(dtensor.full(v), flat_p[k]) for k, v in leaves(cache_s))
    # the train step last: it updates the weights and moments in place
    opt_cfg = adamw.AdamWConfig(**OPT)
    fresh, opt_p, m_p = steps.make_train_step(cfg, opt_cfg, accum=ACCUM)(
        fresh, adamw.init(fresh, opt_cfg), batch)
    (dparams, opt_s, m_s), row["train_step_sharded_s"] = timed(
        lambda: steps.make_train_step(cfg, opt_cfg, accum=ACCUM, batch_spec=layout.batch_axes,
                                      act_spec=layout.act_spec)(
            dparams, adamw.init(dparams, opt_cfg), dist_batch(batch)))
    lr = float(m_p["lr"])
    row["step_loss_diff"] = abs(float(m_p["loss"]) - float(m_s["loss"]))
    row["step_grad_norm_rel_diff"] = (abs(float(m_p["grad_norm"]) - float(m_s["grad_norm"]))
                                      / float(m_p["grad_norm"]))
    row["lr_equal"] = lr == float(m_s["lr"])
    got = dict(leaves(dparams))
    dmax, beyond, total = 0.0, 0, 0
    for k, p in leaves(fresh):
        d = (dtensor.full(got[k]).detach().double() - p.detach().double()).abs()
        dmax = max(dmax, float(d.max()))
        beyond += int((d > 1e-6).sum())
        total += d.numel()
    row["max_param_diff"], row["param_share_beyond_1e-6"] = dmax, beyond / total
    for name in ("m", "v"):
        got_n = dict(leaves(getattr(opt_s, name)))
        row[f"worst_{name}_share"] = max(share(dtensor.full(got_n[k]), t)
                                         for k, t in leaves(getattr(opt_p, name)))
    grad_rel = COND.get(arch, GRAD_REL)
    norm_rel = COND.get(arch, NORM_REL)
    row["ok"] = bool(row["placements_equal"] and row["loss_diff"] <= LOSS_TOL
                     and row["worst_grad_share"] <= grad_rel
                     and max(row["prefill_share"], row["decode_share"], row["cache_share"])
                     <= LOGIT_REL
                     and row["step_loss_diff"] <= LOSS_TOL
                     and row["step_grad_norm_rel_diff"] <= norm_rel and row["lr_equal"]
                     and dmax <= 2 * lr * (1 + 1e-4) and beyond / total < PARAM_SHARE
                     and max(row["worst_m_share"], row["worst_v_share"]) <= 2 * grad_rel)
    return row


def rank_main(archs, device: str) -> int:
    import torch.distributed as dist

    from repro_torch.distributed import dtensor
    from repro_torch.launch import mesh as mesh_mod

    rank = int(os.environ["RANK"])
    # a rank stuck in a collective its peers left ends the run in a minute
    timeout = datetime.timedelta(seconds=60)
    if device == "cuda":
        dev = torch.device("cuda", int(os.environ["LOCAL_RANK"]))
        torch.cuda.set_device(dev)
        torch.backends.cuda.matmul.allow_tf32 = False
        dist.init_process_group("nccl", device_id=dev, timeout=timeout)
    else:
        dev = torch.device("cpu")
        torch.set_num_threads(1)
        dist.init_process_group("gloo", timeout=timeout)
    try:
        mesh = mesh_mod.make_debug_mesh(2, 2)
        rows = {}
        for arch in archs:
            # every rank meets the same failure at the same op, so the
            # group stays in step for the next config
            try:
                rows[arch] = run_arch(arch, mesh, dev)
            except Exception as e:  # noqa: BLE001 - reported, and the exit code is 1
                rows[arch] = {"ok": False, "error": f"{type(e).__name__}: {e}"[:600]}
        out = {"backend": dist.get_backend(), "world": dist.get_world_size(),
               "replicated_ops": dtensor.replications(), "configs": rows,
               "tolerance": {"loss": LOSS_TOL, "grad_share": GRAD_REL, "grad_norm": NORM_REL,
                             "conditioned": COND, "logits_and_cache": LOGIT_REL,
                             "params_after_step": "2 lr",
                             "param_share_beyond_1e-6": PARAM_SHARE,
                             "moments": "2 x grad_share"}}
        if device == "cuda":
            out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev)
        if rank == 0:
            print(json.dumps(out), flush=True)
        return 0 if all(r["ok"] for r in rows.values()) else 1
    finally:
        dist.destroy_process_group()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--archs", default=",".join(ARCHS))
    args = ap.parse_args()
    archs = args.archs.split(",")
    from repro_torch.launch import ranks

    if ranks.in_rank():
        return rank_main(archs, args.device)
    if args.device == "cuda" and torch.cuda.device_count() < 4:
        raise SystemExit(f"four cards wanted, {torch.cuda.device_count()} found")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    return ranks.spawn([sys.executable, __file__, *sys.argv[1:]], 4, timeout=600, env=env)


if __name__ == "__main__":
    sys.exit(main())

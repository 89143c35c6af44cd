"""The sharded step on gloo ranks against the port's one-device step, on
the CPU, in f32 (``test_torch_shard_step*.py``, ``test_torch_shard_save.py``).

The weights are the reference's ``M.init`` at a fixed key
(``torch_lm_train_parity.models``), the batch (8 rows at accum 2 unless a
run asks for others) is drawn with numpy from a seed; the ranks are 4 on a
2×2 mesh unless a run asks for the 8 of 2×2×2.  The ranks (``torch_shard_rank.py``, spawned by
``repro_torch.launch.ranks.spawn``) run while this process computes the
same steps on plain tensors; then every result is held to the bounds of
``torch_lm_train_parity``: the loss within 1e-5 nats, each leaf's gradient
within 1e-3 of its max |g| and the grad norm within 1e-4 relative (whisper
1e-2 for both), the parameters after the step within 2 lr with under 1 %
of their elements beyond 1e-6, both moments (m and v) within twice the
gradient's bound of each leaf's max; logits (prefill and each decode
step) and the decode cache within 1e-4 of their max.
"""
import json
import os
import sys
import threading
from pathlib import Path

import numpy as np
import torch

import torch_lm_parity as parity
import torch_lm_train_parity as tp
from repro_torch.launch import ranks
from repro_torch.models import model as M
from repro_torch.models import steps
from repro_torch.models.layers import leaves
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[1]
B, ACCUM, MAX_LEN, DECODE_STEPS = 8, 2, 16, 2
MESH = (2, 2)
OPT = {"lr": 1e-3, "warmup_steps": 1}
LOGIT_REL = 1e-4
#: the share of parameter elements that may differ by more than 1e-6 after
#: the step (``test_torch_lm_train``'s bound on ``check_train_step``)
PARAM_SHARE = 0.01
#: the trees each rank writes in shards (``torch_shard_rank.run_arch``)
TREES = {"grad": "grads", "param": "params", "m": "m", "v": "v"}
RANK_TIMEOUT_S = 170


def np_batch(cfg, rows=B):
    return tp.batch(cfg, B=rows)


def one_device(cfg, model, b, accum=ACCUM):
    """The steps of ``torch_shard_rank.run_arch`` on plain tensors."""
    batch = parity.torch_batch(b)
    out = {}
    loss, grads = steps.accumulated_grads(cfg, model.params(), batch, accum)
    out["grad_loss"] = float(loss)
    out["grads"] = {"/".join(k): g.detach().numpy() for k, g in leaves(grads)}
    fresh = M.LM(cfg, _copy_tree(model.params())).params()
    opt_cfg = adamw.AdamWConfig(**OPT)
    fresh, opt, metrics = steps.make_train_step(cfg, opt_cfg, accum=accum)(
        fresh, adamw.init(fresh, opt_cfg), batch)
    out.update(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
               lr=float(metrics["lr"]))
    out["params"] = {"/".join(k): p.detach().numpy() for k, p in leaves(fresh)}
    for name in ("m", "v"):
        out[name] = {"/".join(k): t.numpy() for k, t in leaves(getattr(opt, name))}
    n = next(iter(batch.values())).shape[0] // accum
    pre = {k: v[:n] for k, v in batch.items() if k != "loss_mask"}
    out["prefill"] = steps.make_prefill_step(cfg)(model.params(), pre).numpy()
    cache = M.init_cache(cfg, n, MAX_LEN, torch.float32, "cpu")
    if cfg.family == "encdec":
        M.encode(cfg, model.params(), pre["frames"], cache)
    serve = steps.make_serve_step(cfg)
    for pos in range(DECODE_STEPS):
        logits, cache = serve(model.params(), cache, pre["tokens"][:, pos:pos + 1], pos)
        out[f"decode_{pos}"] = logits.numpy()
    from repro_torch.checkpoint.manager import flatten

    out["cache"] = {k: c.numpy() for k, c in flatten(cache).items()}
    return out


def _copy_tree(tree):
    if isinstance(tree, dict):
        return {k: _copy_tree(v) for k, v in tree.items()}
    return tree.detach().clone()


def spawn(job_dir: Path, world: int = 4):
    """Run the ranks on ``job_dir`` in a thread; returns (thread, result)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    result = {}

    def go():
        result["code"] = ranks.spawn([sys.executable, str(ROOT / "tests" / "torch_shard_rank.py"),
                                      str(job_dir)], world, timeout=RANK_TIMEOUT_S, env=env)

    th = threading.Thread(target=go)
    th.start()
    return th, result


def write_job(job_dir: Path, archs, restore=(), changes=None, mesh=MESH, accum=ACCUM,
              save=()):
    """The job file (the ranks read it first); ``changes``: ``{arch: {field:
    value}}`` replaced in a smoke config on both sides; ``mesh``: the debug
    mesh's sizes, ``(data, model)`` or ``(pod, data, model)``; ``save``: the
    configs whose sharded state after the train step the ranks checkpoint
    (``{"arch", "dir"}``)."""
    job_dir.mkdir(parents=True, exist_ok=True)
    tmp = job_dir / "job.json.tmp"
    tmp.write_text(json.dumps(
        {"archs": list(archs), "accum": accum, "opt": OPT, "max_len": MAX_LEN,
         "decode_steps": DECODE_STEPS, "restore": list(restore),
         "changes": changes or {}, "mesh": list(mesh), "save": list(save)}))
    os.replace(tmp, job_dir / "job.json")


def write_inputs(job_dir: Path, arch: str, changes=None, rows=B):
    """A config's reference weights and batch for the ranks; returns the
    config, the port's model on those weights and the numpy batch."""
    _, params, cfg, model = tp.models(arch, **(changes or {}))
    np.savez(job_dir / f"weights_{arch}.npz",
             **{"/".join(k): np.asarray(v) for k, v in leaves(parity.np_tree(params))})
    b = np_batch(cfg, rows)
    np.savez(job_dir / f"batch_{arch}.npz", **b)
    (job_dir / f"ready_{arch}").touch()
    return cfg, model, b


def _share(got, want, rel, what):
    """The largest difference as a share of max |want|, asserted ≤ ``rel``."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()) if want.size else 0.0, 1e-30)
    err = float(np.abs(got - want).max()) if want.size else 0.0
    assert err <= rel * scale, f"{what}: max err {err} > {rel} x {scale}"
    return err / scale


def assemble(job_dir: Path, arch: str, shapes, mesh=MESH):
    """``{key: full array}`` from each rank's shards (``put_local``), with
    ``shapes`` the full shapes: every element written by each rank that
    holds it, and replicas required to agree bit for bit."""
    ranks_ = [dict(np.load(job_dir / f"local_{arch}_{r}.npz"))
              for r in range(int(np.prod(mesh)))]
    out = {}
    for key, shape in shapes.items():
        full = np.full(shape, np.nan)
        for loc in ranks_:
            coord = loc["coord"]
            pl = json.loads(str(loc["place|" + key]))
            index = []
            for d, n in enumerate(shape):
                parts, at = 1, 0
                for i, p in enumerate(pl):
                    if p == ["S", d]:
                        parts *= mesh[i]
                        at = at * mesh[i] + int(coord[i])
                size = n // parts
                index.append(slice(at * size, (at + 1) * size))
            block = full[tuple(index)]
            seen = ~np.isnan(block)
            assert np.array_equal(block[seen], loc[key][seen]), f"{arch} {key}: replicas differ"
            full[tuple(index)] = loc[key]
        assert not np.isnan(full).any(), f"{arch} {key}: elements no rank holds"
        out[key] = full
    return out


def check(arch, job_dir: Path, cfg, want, mesh=MESH):
    """One config's rank results against the one-device ones."""
    got = dict(np.load(job_dir / f"out_{arch}.npz"))
    shapes = {f"{tree}/{k}": v.shape for tree, name in TREES.items()
              for k, v in want[name].items()}
    shapes.update({f"cache/{k}": v.shape for k, v in want["cache"].items()})
    got.update(assemble(job_dir, arch, shapes, mesh))
    g_rel, n_rel = tp.grad_rel(arch), tp.norm_rel(arch)
    assert bool(got["grad_placements_equal"].all()), arch
    assert abs(float(got["grad_loss"]) - want["grad_loss"]) <= tp.LOSS_TOL, arch
    worst = max(_share(got["grad/" + k], g, g_rel, f"{arch} grad {k}")
                for k, g in want["grads"].items())
    assert abs(float(got["loss"]) - want["loss"]) <= tp.LOSS_TOL, (arch, got["loss"])
    assert abs(float(got["grad_norm"]) - want["grad_norm"]) <= n_rel * want["grad_norm"], arch
    assert float(got["lr"]) == want["lr"], arch
    lr = want["lr"]
    beyond, total = 0, 0
    for k, p in want["params"].items():
        d = np.abs(got["param/" + k].astype(np.float64) - p)
        assert d.max() <= 2 * lr * (1 + 1e-4), (arch, k, d.max())
        beyond += int((d > 1e-6).sum())
        total += d.size
    assert beyond / total < PARAM_SHARE, (arch, beyond / total)
    for name in ("m", "v"):
        for k, t in want[name].items():
            _share(got[f"{name}/" + k], t, 2 * g_rel, f"{arch} {name} {k}")
    _share(got["prefill"], want["prefill"], LOGIT_REL, f"{arch} prefill")
    for pos in range(DECODE_STEPS):
        _share(got[f"decode_{pos}"], want[f"decode_{pos}"], LOGIT_REL, f"{arch} decode {pos}")
    for k, c in want["cache"].items():
        _share(got["cache/" + k], c, LOGIT_REL, f"{arch} cache {k}")
    return worst


class Run:
    """The ranks' run on ``archs`` beside the one-device steps: ``start``
    spawns the ranks first and writes each config's inputs while they
    start; ``finish`` waits for them.  ``mesh``, ``rows`` and ``accum``: the
    debug mesh, the batch's rows and the microbatches (``write_job``)."""

    def __init__(self, tmp_path: Path, archs, restore=(), changes=None, mesh=MESH, rows=B,
                 accum=ACCUM, save=()):
        self.job_dir = tmp_path / "job"
        self.archs = list(archs)
        self.mesh = tuple(mesh)
        changes = changes or {}
        write_job(self.job_dir, self.archs, restore, changes, mesh, accum, save)
        self.thread, self.result = spawn(self.job_dir, int(np.prod(mesh)))
        self.want, self.cfgs = {}, {}
        threads = torch.get_num_threads()
        torch.set_num_threads(1)    # the ranks have the cores
        try:
            for arch in self.archs:
                cfg, model, b = write_inputs(self.job_dir, arch, changes.get(arch), rows)
                self.cfgs[arch] = cfg
                self.want[arch] = one_device(cfg, model, b, accum)
        except BaseException:
            self.thread.join()
            raise
        finally:
            torch.set_num_threads(threads)

    def finish(self):
        self.thread.join()
        assert self.result.get("code") == 0, self.result
        return self

    def check(self, arch):
        return check(arch, self.job_dir, self.cfgs[arch], self.want[arch], self.mesh)

    def replications(self):
        return json.loads((self.job_dir / "replications.json").read_text())

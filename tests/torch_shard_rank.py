"""One rank of the sharded-step parity runs (``torch_shard_parity``).

  python tests/torch_shard_rank.py JOB_DIR

run as each rank of ``repro_torch.launch.ranks.spawn`` (gloo, one thread a
rank) on the job's debug mesh: 2×2 ``("data", "model")`` (4 ranks) or
2×2×2 ``("pod", "data", "model")`` (8 ranks).  ``JOB_DIR/job.json``
names the smoke configs; for each, ``weights_<arch>.npz`` holds the
reference's parameters and ``batch_<arch>.npz`` the batch, written while
the ranks start (``ready_<arch>`` marks them complete).  The parameters
are distributed under the reference dry run's layout for the full config
(``sharding.step_layout``), then: the train step's gradients at the job's
accum through ``accumulated_grads`` (``batch_spec``/``act_spec`` set), a
prefill, two decode steps against a cache under ``cache_shardings``
(enc-dec: after ``encode``), and last the train step itself through
``make_train_step``, which updates the weights in place.
Each rank writes its shards of the gradients, the parameters and both
moments after the step and the cache to ``local_<arch>_<rank>.npz`` with
their placements and its mesh coordinate (no collective); rank 0 writes
the loss, the metrics, the logits, whether each gradient's placements are
its parameter's and the train step's collectives
(``hlo.CollectiveRecorder``) to ``out_<arch>.npz``.  With ``save`` in the
job, the sharded state after the train step (parameters, AdamW ``m``, ``v``
and ``step``) is checkpointed by every rank (``CheckpointManager.save``),
rank 0 writes it gathered to ``saved_<arch>.npz``, and the ranks restore it
onto the mesh and check each leaf's placements and bits.  With ``restore`` in
the job, the checkpoint directories it names are restored onto the mesh
and gathered back into ``restored_<i>.npz``.  Imports nothing of JAX.
"""
import dataclasses
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint.manager import CheckpointManager, flatten
from repro_torch.configs.registry import get_config
from repro_torch.distributed import dtensor, hlo
from repro_torch.distributed import sharding as shd
from repro_torch.launch import mesh as mesh_mod
from repro_torch.models import model as M
from repro_torch.models import steps
from repro_torch.models.layers import leaves, tree_of
from repro_torch.optim import adamw


def full_np(t):
    return dtensor.full(t).detach().float().numpy()


def put_local(out, key, t):
    """This rank's shard of ``t`` under ``key`` and its placements under
    ``place|key`` (``[["S", dim] | ["R"], ...]``): no collective."""
    pl = []
    for p in t.placements:
        if p.is_partial():
            raise ValueError(f"{key}: a pending sum {t.placements}")
        pl.append(["S", p.dim] if p.is_shard() else ["R"])
    out[key] = t.to_local().detach().float().numpy()
    out["place|" + key] = np.array(json.dumps(pl))


def wait_for(path: Path, timeout: float = 150.0) -> None:
    """The parent writes each config's inputs while the ranks start."""
    t0 = time.monotonic()
    while not path.exists():
        if time.monotonic() - t0 > timeout:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.05)


def run_arch(job, mesh, arch, out_dir: Path):
    wait_for(out_dir / f"ready_{arch}")
    cfg = dataclasses.replace(get_config(arch, smoke=True), **job["changes"].get(arch, {}))
    layout = shd.step_layout(M.n_params(get_config(arch)), mesh)
    with np.load(out_dir / f"weights_{arch}.npz") as w:
        params = tree_of((tuple(k.split("/")), torch.from_numpy(w[k])) for k in w.files)
    with np.load(out_dir / f"batch_{arch}.npz") as b:
        batch = {k: torch.from_numpy(b[k]) for k in b.files}

    def dist_batch(bt):
        return {k: shd.distribute(v, shd.NamedSharding(
            mesh, shd.batch_spec_for(mesh, layout, tuple(v.shape))), requires_grad=False)
            for k, v in bt.items()}

    out = {}
    t0 = time.perf_counter()
    walls = {}
    opt_cfg = adamw.AdamWConfig(**job["opt"])
    # the same step's gradients (make_train_step keeps them to itself)
    dparams = shd.distribute_tree(params, mesh, layout.rules, M.axes(cfg))
    loss, grads = steps.accumulated_grads(cfg, dparams, dist_batch(batch), job["accum"],
                                          batch_spec=layout.batch_axes,
                                          act_spec=layout.act_spec)
    out["grad_loss"] = full_np(loss)
    local = {}
    same = []
    for (k, g), (_, p) in zip(leaves(grads), leaves(dparams)):
        same.append(tuple(g.placements) == tuple(p.placements))
        put_local(local, "grad/" + "/".join(k), g)
    out["grad_placements_equal"] = np.array(same)
    walls["grads"] = time.perf_counter() - t0
    # prefill and decode
    # a microbatch's rows: the train step's shapes, whose sharding is known
    B = batch["tokens"].shape[0] // job["accum"]
    pre = {k: v[:B] for k, v in batch.items() if k != "loss_mask"}
    logits = steps.make_prefill_step(cfg, act_spec=layout.act_spec)(dparams, dist_batch(pre))
    out["prefill"] = full_np(logits)
    walls["prefill"] = time.perf_counter() - t0 - sum(walls.values())
    cache = M.init_cache(cfg, B, job["max_len"], torch.float32, "cpu")
    cache = shd.distribute_like(cache, shd.cache_shardings(cache, mesh))
    if cfg.family == "encdec":
        with torch.no_grad(), dtensor.sharded_context(dparams):
            M.encode(cfg, dparams, dist_batch({"f": pre["frames"]})["f"], cache)
    serve = steps.make_serve_step(cfg)
    tok = shd.NamedSharding(mesh, shd.data_spec(mesh, B, 2))
    for pos in range(job["decode_steps"]):
        t = shd.distribute(pre["tokens"][:, pos:pos + 1], tok, requires_grad=False)
        logits, cache = serve(dparams, cache, t, pos)
        out[f"decode_{pos}"] = full_np(logits)
    for k, c in flatten(cache).items():
        put_local(local, "cache/" + k, c)
    walls["decode"] = time.perf_counter() - t0 - sum(walls.values())
    # the train step itself, last: it updates the weights in place
    step = steps.make_train_step(cfg, opt_cfg, accum=job["accum"],
                                 batch_spec=layout.batch_axes, act_spec=layout.act_spec)
    opt = adamw.init(dparams, opt_cfg)
    recorder = hlo.CollectiveRecorder()    # the step's collectives, over gloo
    with recorder:
        dparams, opt, metrics = step(dparams, opt, dist_batch(batch))
    out["collectives"] = np.array(json.dumps(recorder.summary()))
    for name in ("loss", "grad_norm", "lr"):
        out[name] = np.asarray(float(metrics[name]))
    for k, p in leaves(dparams):
        put_local(local, "param/" + "/".join(k), p)
    for name in ("m", "v"):
        for k, t in leaves(getattr(opt, name)):
            put_local(local, f"{name}/" + "/".join(k), t)
    walls["train_step"] = time.perf_counter() - t0 - sum(walls.values())
    out["walls"] = np.array(json.dumps(walls))
    for entry in job.get("save", ()):
        if entry["arch"] == arch:
            save_and_restore(cfg, layout, mesh, {"params": dparams, "opt": opt}, entry["dir"],
                             out_dir / f"saved_{arch}.npz")
    rank = dist.get_rank()
    np.savez(out_dir / f"local_{arch}_{rank}.npz", coord=np.array(mesh.get_coordinate()),
             **local)
    if rank == 0:
        np.savez(out_dir / f"out_{arch}.npz", **out)


def save_and_restore(cfg, layout, mesh, state, directory, out_path: Path) -> None:
    """``state`` saved by every rank, then restored onto the mesh under the
    layout's placements: each leaf's placements and bits as saved (raises
    otherwise); rank 0 writes the gathered state to ``out_path``."""
    gathered = {k: dtensor.full(v).detach() for k, v in flatten(state).items()}
    CheckpointManager(directory).save(1, state, extra={"by": "ranks"})
    tmpl = M.abstract(cfg)
    template = {"params": tmpl, "opt": adamw.AdamWState(
        torch.empty((), dtype=torch.int32, device="meta"), tmpl, tmpl)}
    ps = shd.tree_shardings(tmpl, M.axes(cfg), mesh, layout.rules)
    os_ = shd.tree_shardings(tmpl, M.axes(cfg), mesh, layout.opt_rules)
    shardings = {"params": ps, "opt": adamw.AdamWState(None, os_, os_)}
    back, extra = CheckpointManager(directory).restore(template, device="cpu",
                                                       shardings=shardings)
    saved = flatten(state)
    for k, v in flatten(back).items():
        if dtensor.is_dtensor(saved[k]) != dtensor.is_dtensor(v):
            raise AssertionError(f"{k}: restored as {type(v).__name__}")
        if dtensor.is_dtensor(v) and tuple(v.placements) != tuple(saved[k].placements):
            raise AssertionError(f"{k}: placements {v.placements} != {saved[k].placements}")
        if not torch.equal(dtensor.full(v), gathered[k]):
            raise AssertionError(f"{k}: restored bits differ")
    if dist.get_rank() == 0:
        np.savez(out_path, extra=np.array(json.dumps(extra)),
                 **{k.replace("/", "|"): v.numpy() for k, v in gathered.items()})


def restore(job, mesh, out_dir: Path):
    """Each named checkpoint restored onto the mesh under the job's rules,
    its placements checked, and gathered back."""
    for i, r in enumerate(job["restore"]):
        wait_for(Path(r["dir"]) / "ready")
        cfg = get_config(r["arch"], smoke=True)
        layout = shd.step_layout(M.n_params(get_config(r["arch"])), mesh)
        tmpl = M.abstract(cfg)
        template = {"params": tmpl, "opt": adamw.AdamWState(
            torch.empty((), dtype=torch.int32, device="meta"), tmpl, tmpl)}
        ps = shd.tree_shardings(tmpl, M.axes(cfg), mesh, r.get("rules") or layout.rules)
        shardings = {"params": ps, "opt": adamw.AdamWState(shd.replicated(mesh), ps, ps)}
        state, extra = CheckpointManager(r["dir"]).restore(template, device="cpu",
                                                           shardings=shardings)
        want = flatten(shardings)
        got = {k: full_np(v) if v.is_floating_point() else dtensor.full(v).numpy()
               for k, v in flatten(state).items()}
        ok = all(tuple(v.placements) == want[k].placements for k, v in flatten(state).items())
        if dist.get_rank() == 0:
            np.savez(out_dir / f"restored_{i}.npz", placements_ok=np.array(ok),
                     extra=np.array(json.dumps(extra)),
                     **{k.replace("/", "|"): v for k, v in got.items()})


def main(job_dir: str) -> None:
    torch.set_num_threads(1)
    out_dir = Path(job_dir)
    wait_for(out_dir / "job.json")
    job = json.loads((out_dir / "job.json").read_text())
    dist.init_process_group("gloo")
    try:
        sizes = job.get("mesh", [2, 2])
        shape = (mesh_mod.debug_shape(*sizes[1:], pod=sizes[0]) if len(sizes) == 3
                 else mesh_mod.debug_shape(*sizes))
        mesh = mesh_mod.device_mesh(shape)
        for arch in job["archs"]:
            run_arch(job, mesh, arch, out_dir)
        if job.get("restore"):
            restore(job, mesh, out_dir)
        if dist.get_rank() == 0:
            (out_dir / "replications.json").write_text(json.dumps(dtensor.replications()))
        # no rank tears its group down while a peer is still in a collective
        dist.barrier()
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main(sys.argv[1])

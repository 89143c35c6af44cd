"""Multi-pod dry run: every (arch × shape × mesh) cell's step on a fake world.

The port of the JAX package's ``launch/dryrun.py``.  For each cell the real
train, prefill or serve step runs with the production placements on the
16×16 (single pod, 256 ranks) or 2×16×16 (two pods, 512 ranks) mesh of a
fake process group (``FakeStore``, backend ``fake``), every tensor a
``FakeTensorMode`` tensor: shapes and dtypes, nothing allocated, no
collective sent.  This process plays rank 0; every rank holds blocks of the
same shapes, so its figures are every rank's.  It records, as the reference
does for its compiled step:

  * ``memory``: ``argument_bytes`` exactly, from the local shard shapes of
    what the step takes (:func:`argument_bytes`: parameters, optimizer state
    and batch; or parameters, cache, tokens and ``pos``); ``output_bytes``
    from the outputs' local shapes; ``alias_bytes``, the outputs that are
    arguments updated in place (the port's train step writes the
    parameters and moments, its decode step the cache, into the tensors
    it is given; the reference donates nothing, so its alias is 0);
    ``temp_bytes``, the peak of live tensor bytes during the step less the
    arguments and less the outputs that are new, so that the reference's
    ``argument + temp + output - alias`` is the estimated peak;
  * ``cost``: ``flops_per_device`` by ``torch.utils.flop_counter``'s formulas
    on each local op (``FlopCounterMode``'s registry: matmuls, convolutions,
    attention kernels), ``bytes_accessed_per_device`` the sum of each local
    op's operand and result bytes (views and metadata excluded);
  * ``collectives``: the inventory of ``distributed.hlo`` (the functional
    collectives DTensor issues, with the card's all-to-all,
    ``hlo.alltoall_on_cpu_meshes``) and its wire bytes a device;
  * ``timing``: ``lower_s`` the time to build the state and its placements,
    ``compile_s`` the fake step's;
  * ``loops``: as the reference's.

Where a figure counts differently from XLA's: XLA's ``cost_analysis`` counts
a loop body once (``tests/test_roofline_model.py:32``), the port runs every
layer and every microbatch, so its FLOPs and bytes accessed are the whole
step's; ``temp_bytes`` is a peak of live tensors in eager order (autograd's
saved tensors, block remat, the caching of nothing), not XLA's buffer
assignment; the collectives are DTensor's redistributions, not GSPMD's
(no collective-permute; the MoE dispatch runs on replicated tokens,
``distributed.dtensor.replications``).

The cell's own policy is the reference's (``dryrun.py:53-130``): under 1e9
parameters pure data parallelism, over 50e9 bf16 moments and accumulator;
the MoE ``token_chunk = 8192 · world/16``; ``REPRO_ZERO1`` set: parameters
TP-only and the optimizer state on the FSDP rules (``sharding.step_layout``);
``attn_chunk`` by sequence length; accum 1, 8 or 16 by family and size; the
encoder-decoder's cross context by the cell (``shape_adjusted_config``).

No ``--device``: nothing runs on a device.  The reference is device-free
too (it forks 512 host CPUs and only compiles).

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-3b --shape decode_32k --mesh single
  python -m repro_torch.launch.dryrun --sweep [--mesh both]

Records go to ``results/dryrun_torch/<arch>__<shape>__<mesh>.json``, or to
the directory ``REPRO_TORCH_DRYRUN_DIR`` names.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import os
import subprocess
import sys
import time
import traceback
import weakref
from pathlib import Path
from typing import Any, Dict, Optional

import torch

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig, shapes_for
from repro_torch.configs.registry import all_archs, get_config
from repro_torch.distributed import dtensor, hlo
from repro_torch.distributed import sharding as shd
from repro_torch.launch import input_specs as ispec
from repro_torch.launch.mesh import MeshShape, production_shape
from repro_torch.models import model as M
from repro_torch.models import steps
from repro_torch.models.layers import leaves, map_tree, torch_dtype
from repro_torch.optim import adamw

ROOT = Path(__file__).resolve().parents[3]


def results_dir() -> Path:
    return Path(os.environ.get("REPRO_TORCH_DRYRUN_DIR") or ROOT / "results" / "dryrun_torch")


# ---------------------------------------------------------------------------
# The cell's policy
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Cell:
    """One dry-run cell: the model its step runs, the shape, the mesh and
    the reference's policy for them."""

    arch: str
    shape: ShapeConfig
    mesh_kind: str
    mesh: MeshShape
    cfg: ModelConfig            # the cell's config (``shape_adjusted_config``, MoE chunk)
    n_params: int
    layout: shd.StepLayout
    accum: int
    attn_chunk: Optional[int]
    overrides: Dict[str, Any] = dataclasses.field(default_factory=dict)

    @property
    def world(self) -> int:
        return self.mesh.size


def accum_for(n_params: int, cfg: ModelConfig) -> int:
    """The reference's microbatch count of a train cell: the microbatch
    must stay divisible by the data shards (256 rows over 16 cap it at 16)."""
    if n_params < 1e9:
        return 1
    if n_params > 50e9 or (cfg.moe and cfg.moe.n_experts) or n_params > 10e9:
        return 16
    return 8


def attn_chunk_for(seq_len: int) -> Optional[int]:
    return None if seq_len < 4096 else (1024 if seq_len == 4096 else 2048)


def plan(arch: str, shape_name: str, mesh_kind: str, overrides=None) -> Optional[Cell]:
    """The cell's policy (module docstring); None where the reference skips
    the cell (a full-attention model's ``long_500k``)."""
    cfg = get_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    shape = SHAPES[shape_name]
    if shape_name not in shapes_for(cfg):
        return None
    multi = mesh_kind == "multi"
    mesh = production_shape(multi_pod=multi)
    cfg_cell = ispec.shape_adjusted_config(cfg, shape)
    n_par = M.n_params(cfg_cell)
    small = n_par < 1e9
    if not small and cfg_cell.moe and cfg_cell.moe.n_experts:
        # bound the dispatch buffers: ~8k tokens a chunk a data shard
        cfg_cell = dataclasses.replace(cfg_cell, moe=dataclasses.replace(
            cfg_cell.moe, token_chunk=8192 * (mesh.size // 16)))
    layout = shd.step_layout(n_par, mesh, zero1=bool(os.environ.get("REPRO_ZERO1")))
    accum = accum_for(n_par, cfg_cell) if shape.kind == "train" else 1
    return Cell(arch, shape, mesh_kind, mesh, cfg_cell, n_par, layout, accum,
                attn_chunk_for(shape.seq_len), dict(overrides or {}))


def on_model(cell: Cell, cfg: ModelConfig) -> Cell:
    """``cell`` with another model in its step (a smoke config), under the
    cell's own policy (mesh, rules, accum, chunks), which stays that of the
    cell's full config."""
    cfg = ispec.shape_adjusted_config(cfg, cell.shape)
    if cfg.moe and cfg.moe.n_experts and cell.cfg.moe:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, token_chunk=cell.cfg.moe.token_chunk))
    return dataclasses.replace(cell, cfg=cfg)


def layer_scan_trips(cfg: ModelConfig) -> int:
    if cfg.family == "hybrid":
        return cfg.n_layers // max(cfg.attn_every, 1)
    return cfg.n_layers


# ---------------------------------------------------------------------------
# What the step takes: shapes and placements
# ---------------------------------------------------------------------------


def _meta(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def arguments(cell: Cell, mesh=None):
    """``{part: (tree of meta tensors, tree of NamedShardings)}`` of what
    the cell's step takes, on ``mesh`` (default ``cell.mesh``; a
    ``DeviceMesh`` of the same layout for a step)."""
    cfg, shape, layout = cell.cfg, cell.shape, cell.layout
    mesh = cell.mesh if mesh is None else mesh
    tmpl = M.abstract(cfg)
    ax = M.axes(cfg)
    p_sh = shd.tree_shardings(tmpl, ax, mesh, layout.rules)
    out = {"params": (tmpl, p_sh)}

    def batch():
        b = ispec.batch_specs(cfg, shape)
        return b, {k: shd.NamedSharding(mesh, shd.batch_spec_for(mesh, layout, tuple(v.shape)))
                   for k, v in b.items()}

    if shape.kind == "train":
        o_sh = shd.tree_shardings(tmpl, ax, mesh, layout.opt_rules)
        dt = torch_dtype(layout.state_dtype)
        mom = map_tree(lambda t: _meta(t.shape, dt), tmpl)
        out["opt"] = (adamw.AdamWState(_meta((), torch.int32), mom, mom),
                      adamw.AdamWState(shd.replicated(mesh), o_sh, o_sh))
        out["batch"] = batch()
    elif shape.kind == "prefill":
        out["batch"] = batch()
    else:
        cache, tokens, pos = ispec.decode_specs(cfg, shape)
        out["cache"] = (cache, shd.cache_shardings(cache, mesh))
        out["tokens"] = (tokens, shd.NamedSharding(mesh, shd.data_spec(mesh, tokens.shape[0], 2)))
        out["pos"] = (pos, shd.replicated(mesh))
    return out


def _walk(tree, shardings, fn, path=()):
    """``fn(path, leaf, sharding)`` over a tree (dicts and ``NamedTuple``s),
    rebuilt; ``path`` the leaf's keys (a ``NamedTuple``'s field names)."""
    if isinstance(tree, dict):
        return {k: _walk(tree[k], shardings[k], fn, path + (k,)) for k in tree}
    if isinstance(tree, tuple):
        return type(tree)(*(_walk(a, s, fn, path + (f,))
                            for f, a, s in zip(tree._fields, tree, shardings)))
    return fn(path, tree, shardings)


def unread_arguments(cell: Cell) -> set:
    """The ``(part, *path)`` of the arguments the cell's step never reads,
    which XLA drops from the compiled step (``jax.jit``'s ``keep_unused``
    is off): a decode step reads neither the encoder nor the cross
    attention's K and V projections (the cache holds their products), and
    an SSM's decode step not ``pos``."""
    if cell.shape.kind != "decode":
        return set()
    if cell.cfg.family == "ssm":
        return {("pos",)}
    if cell.cfg.family == "encdec":
        out = {("params", *k) for k, _ in leaves(M.abstract(cell.cfg))
               if k[0] in ("enc_blocks", "enc_norm")}
        return out | {("params", "blocks", "xattn", w) for w in ("wk", "wv")}
    return set()


def argument_bytes(cell: Cell) -> Dict[str, int]:
    """The bytes one rank holds of each argument the cell's step reads,
    from the local shard shapes alone (no step runs), and their ``total``:
    the reference's ``memory_analysis().argument_size_in_bytes``."""
    unread = unread_arguments(cell)
    out = {}
    for part, (tree, sh) in arguments(cell).items():
        n = 0

        def add(path, a, s):
            nonlocal n
            if (part, *path) not in unread:
                n += math.prod(shd.local_shape(tuple(a.shape), s.spec, s.mesh)) * a.element_size()

        _walk(tree, sh, add)
        out[part] = n
    out["total"] = sum(out.values())
    return out


# ---------------------------------------------------------------------------
# The fake world
# ---------------------------------------------------------------------------


@contextlib.contextmanager
def fake_world(mesh: MeshShape):
    """A fake process group of ``mesh.size`` ranks (this process rank 0) and
    ``mesh`` as a CPU ``DeviceMesh`` on it; the group is torn down after."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch.mesh import device_mesh

    if dist.is_initialized():
        raise RuntimeError("a dry run brings up its own fake process group; one is already up")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=mesh.size)
    try:
        yield device_mesh(mesh, "cpu")
    finally:
        dist.destroy_process_group()


def _stand_in(a: torch.Tensor, sharding: Optional[shd.NamedSharding], requires_grad: bool):
    """A tensor of ``a``'s shape and dtype (under ``FakeTensorMode``: nothing
    allocated): with ``sharding``, a DTensor whose local block is a fresh
    tensor of the local shape; else a plain one."""
    shape = tuple(a.shape)
    if sharding is None:
        return torch.zeros(shape, dtype=a.dtype).requires_grad_(requires_grad)
    from torch.distributed.tensor import DTensor

    local = torch.zeros(shd.local_shape(shape, sharding.spec, sharding.mesh), dtype=a.dtype)
    stride = tuple(math.prod(shape[k + 1:]) for k in range(len(shape)))
    out = DTensor.from_local(local, sharding.mesh, sharding.placements, run_check=False,
                             shape=torch.Size(shape), stride=stride)
    return out.requires_grad_(requires_grad) if requires_grad else out


class StepMeter(hlo.CollectiveRecorder):
    """The collectives (``hlo.CollectiveRecorder``), and on every local op
    its FLOPs (``torch.utils.flop_counter``'s formulas), its operand and
    result bytes, and the live bytes of the storages made under it: each
    counted from the first tensor that holds it until the last one dies.
    A collective's ``wait_tensor`` returns its input on a device (a new
    storage only under fake tensors): its output counts as the input's
    storage, and it moves no bytes.
    The storages of ``arguments`` are never counted, nor the ops DTensor's
    sharding propagation runs on global-shape stand-ins (a factory op
    called from it, and every op on what such ops made)."""

    def __init__(self, arguments=()):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flops = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.live = 0
        self.peak = 0
        self._args = {_storage_key(t) for t in arguments}
        self.read: set = set()      # the argument storages an op (not a view) took
        self._refs: Dict[int, list] = {}
        self._alias: Dict[int, int] = {}      # a wait_tensor's storage -> its input's
        self._held: Dict[int, int] = {}       # the live tensors on each such storage

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if hlo._has_subclass(types):
            return NotImplemented
        kwargs = kwargs or {}
        ins = list(_tensors((args, kwargs)))
        shadow = (any(getattr(t, "_dryrun_shadow", False) for t in ins) if ins
                  else _in_propagation())
        out = func(*args, **kwargs)
        outs = list(_tensors(out))
        if shadow:
            for t in outs:
                t._dryrun_shadow = True
            return out
        c = hlo.collective_of(func, args, kwargs, out)
        if c is not None:
            self.collectives.append(c)
        packet = func._overloadpacket
        if packet in self._flops:
            self.flops += int(self._flops[packet](*args, **kwargs, out_val=out))
        wait = func.namespace == "_c10d_functional" and func._opname == "wait_tensor"
        if not func.is_view and func.namespace != "prim" and not wait:
            self.bytes_accessed += sum(hlo.tensor_bytes(t) for t in ins + outs)
            self.read.update(k for k in map(_storage_key, ins) if k in self._args)
        if wait:
            src = self._key(ins[0])
            for t in outs:
                if _storage_key(t) != src:
                    self._alias[_storage_key(t)] = src
        for t in outs:
            self._track(t)
        return out

    def _key(self, t: torch.Tensor) -> int:
        """The storage ``t`` is counted under."""
        own = _storage_key(t)
        return self._alias.get(own, own)

    def _track(self, t: torch.Tensor) -> None:
        own, key = _storage_key(t), self._key(t)
        if key in self._args:
            return
        refs = self._refs.get(key)
        if refs is None:
            refs = self._refs[key] = [0, t.untyped_storage().nbytes()]
            self.live += refs[1]
            self.peak = max(self.peak, self.live)
        refs[0] += 1
        if own != key:
            self._held[own] = self._held.get(own, 0) + 1
        weakref.finalize(t, self._release, key, own)

    def _release(self, key: int, own: int) -> None:
        if own != key:      # the alias lives as long as its storage
            self._held[own] -= 1
            if not self._held[own]:
                del self._held[own], self._alias[own]
        refs = self._refs[key]
        refs[0] -= 1
        if refs[0] == 0:
            self.live -= refs[1]
            del self._refs[key]


def _in_propagation() -> bool:
    """True when DTensor's sharding propagation runs the op on stand-ins of
    the global shapes to learn its output's shape: no rank does that work."""
    f = sys._getframe(2)
    while f is not None:
        if f.f_code.co_name.startswith("_propagate_tensor_meta"):
            return True
        f = f.f_back
    return False


def _storage_key(t: torch.Tensor) -> int:
    return t.untyped_storage()._cdata


def _tensors(tree):
    from torch.utils._pytree import tree_leaves

    return (t for t in tree_leaves(tree) if isinstance(t, torch.Tensor))


def _local(t: torch.Tensor) -> torch.Tensor:
    return t.to_local() if dtensor.is_dtensor(t) else t


def _locals(tree):
    """The local blocks of a tree's DTensors (plain tensors as they are)."""
    return [_local(t) for t in _tensors(tree)]


@dataclasses.dataclass
class DryRun:
    """A cell's dry run: the reference's record, the arguments' bytes by
    part, the ops run on replicated copies (``dtensor.replications``), the
    ``(part, *path)`` of the tensor arguments no op of the step took, and
    the collectives one by one."""

    record: Dict[str, Any]
    arguments: Dict[str, int]
    replications: Dict[str, int]
    unread: set
    collectives: list

    def largest_collectives(self, n: int = 5):
        """``(wire bytes a device, count, line)`` of the ``n`` collective
        lines (op, shapes, group) that move the most, summed over the step."""
        by_line: Dict[str, list] = {}
        for c in self.collectives:
            acc = by_line.setdefault(c.line, [0.0, 0])
            acc[0] += hlo.wire_bytes_per_device(c)
            acc[1] += 1
        top = sorted(by_line.items(), key=lambda kv: -kv[1][0])[:n]
        return [(w, k, line) for line, (w, k) in top]


def step_call(cell: Cell, mesh=None):
    """``(step function, its arguments by part)`` for the cell: on ``mesh``
    (a ``DeviceMesh``) DTensors under the cell's placements; with none,
    the same step on plain tensors of the global shapes."""
    made = {}
    for part, (tree, sh) in arguments(cell, mesh).items():
        if part == "pos":
            # the serve step takes a Python int: the middle of the self-attention cache
            made[part] = (ispec.WHISPER_DEC_LEN if cell.cfg.family == "encdec"
                          else cell.shape.seq_len) // 2
            continue
        grad = part == "params" and cell.shape.kind == "train"
        made[part] = _walk(tree, sh,
                           lambda _, a, s: _stand_in(a, None if mesh is None else s, grad))
    if "opt" in made:   # the step count: a plain tensor on every rank (``adamw.init``)
        made["opt"] = made["opt"]._replace(step=torch.zeros((), dtype=torch.int32))
    layout, cfg = cell.layout, cell.cfg
    if cell.shape.kind == "train":
        opt_cfg = adamw.AdamWConfig(state_dtype=layout.state_dtype)
        fn = steps.make_train_step(cfg, opt_cfg, accum=cell.accum, attn_chunk=cell.attn_chunk,
                                   batch_spec=layout.batch_axes, act_spec=layout.act_spec,
                                   accum_dtype=layout.accum_dtype)
    elif cell.shape.kind == "prefill":
        fn = steps.make_prefill_step(cfg, attn_chunk=cell.attn_chunk, act_spec=layout.act_spec)
    else:
        fn = steps.make_serve_step(cfg)
    return fn, made


def dry_run(cell: Cell) -> DryRun:
    """The cell's step on a fake world of its mesh (module docstring)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    t0 = time.time()
    arg_bytes = argument_bytes(cell)
    before = dtensor.replications()
    with fake_world(cell.mesh) as mesh, FakeTensorMode(), hlo.alltoall_on_cpu_meshes():
        fn, made = step_call(cell, mesh)
        t_lower = time.time() - t0
        arg_locals = _locals(made)
        meter = StepMeter(arg_locals)
        with meter:
            out = fn(*made.values())
        t_compile = time.time() - t0 - t_lower
        arg_keys = {_storage_key(t) for t in arg_locals}
        outs = _locals(out)
        output = sum(hlo.tensor_bytes(t) for t in outs)
        alias = sum(hlo.tensor_bytes(t) for t in outs if _storage_key(t) in arg_keys)
        unread = set()
        for part, tree in made.items():
            if isinstance(tree, int):      # pos
                continue

            def note(path, t, _):
                if _storage_key(_local(t)) not in meter.read:
                    unread.add((part, *path))

            _walk(tree, tree, note)
        del out, made, arg_locals, outs
    temp = max(meter.peak - (output - alias), 0)
    total = arg_bytes["total"] + temp + output - alias
    reps = {k: v - before.get(k, 0) for k, v in dtensor.replications().items()
            if v != before.get(k, 0)}
    shape = cell.shape
    record = {
        "arch": cell.arch,
        "shape": shape.name,
        "mesh": cell.mesh_kind,
        "world": cell.world,
        "n_params": cell.n_params,
        "kind": shape.kind,
        "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "memory": {
            "argument_bytes": arg_bytes["total"],
            "temp_bytes": temp,
            "output_bytes": output,
            "alias_bytes": alias,
            "per_device_total_bytes": total,
            "fits_16GB": bool(total < 16e9),
        },
        "cost": {
            "flops_per_device": float(meter.flops),
            "bytes_accessed_per_device": float(meter.bytes_accessed),
        },
        "collectives": meter.summary(),
        "timing": {"lower_s": t_lower, "compile_s": t_compile},
        "overrides": cell.overrides,
        "loops": {
            "accum": cell.accum if shape.kind == "train" else 1,
            "layer_scan_trips": layer_scan_trips(cell.cfg),
            "attn_chunk": cell.attn_chunk,
        },
    }
    return DryRun(record, arg_bytes, reps, unread, meter.collectives)


def run_cell(arch: str, shape_name: str, mesh_kind: str, overrides=None) -> dict:
    """The reference's ``run_cell``: the cell's record (module docstring)."""
    cell = plan(arch, shape_name, mesh_kind, overrides)
    if cell is None:
        return {"skipped": f"{arch} is full-attention; long_500k not lowered"}
    return dry_run(cell).record


def cell_filename(arch, shape, mesh_kind, tag=""):
    t = f"__{tag}" if tag else ""
    return results_dir() / f"{arch}__{shape}__{mesh_kind}{t}.json"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--mesh", default="single", choices=["single", "multi", "both"])
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--tag", default="", help="suffix for experiment variants")
    ap.add_argument("--overrides", default="", help="JSON dict of ModelConfig overrides")
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--force", action="store_true")
    args = ap.parse_args(argv)
    results = results_dir()
    results.mkdir(parents=True, exist_ok=True)

    if args.sweep:
        meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]
        cells = [(arch, shape, mk) for arch in all_archs()
                 for shape in shapes_for(get_config(arch)) for mk in meshes]
        print(f"sweeping {len(cells)} cells", flush=True)
        for arch, shape, mk in cells:
            out = cell_filename(arch, shape, mk, args.tag)
            if out.exists() and not args.force:
                print(f"SKIP {out.name} (exists)", flush=True)
                continue
            cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
                   "--arch", arch, "--shape", shape, "--mesh", mk]
            if args.tag:
                cmd += ["--tag", args.tag]
            if args.overrides:
                cmd += ["--overrides", args.overrides]
            t0 = time.time()
            try:
                r = subprocess.run(cmd, timeout=args.timeout, capture_output=True, text=True)
                ok = r.returncode == 0 and out.exists()
                print(f"{'OK  ' if ok else 'FAIL'} {arch} {shape} {mk} "
                      f"({time.time() - t0:.0f}s)", flush=True)
                if not ok:
                    out.with_suffix(".err").write_text(
                        (r.stdout or "")[-4000:] + "\n---\n" + (r.stderr or "")[-8000:])
            except subprocess.TimeoutExpired:
                print(f"TIMEOUT {arch} {shape} {mk}", flush=True)
        return

    if args.mesh == "both":
        ap.error("--mesh both needs --sweep")
    overrides = json.loads(args.overrides) if args.overrides else None
    try:
        cell = plan(args.arch, args.shape, args.mesh, overrides)
        run = dry_run(cell) if cell is not None else None
    except Exception:
        traceback.print_exc()
        sys.exit(1)
    out = cell_filename(args.arch, args.shape, args.mesh, args.tag)
    if run is None:
        rec = {"skipped": f"{args.arch} is full-attention; long_500k not lowered"}
        out.write_text(json.dumps(rec, indent=2))
        print(f"SKIPPED: {rec['skipped']}")
        return
    rec = run.record
    out.write_text(json.dumps(rec, indent=2))
    print(json.dumps({k: rec[k] for k in ("arch", "shape", "mesh", "memory", "cost", "timing")},
                     indent=2))
    print("collectives:", json.dumps(rec["collectives"]))
    print("arguments:", json.dumps(run.arguments))
    print("replicated ops:", json.dumps(run.replications))
    print("largest collectives (wire bytes a device, count, op):")
    for w, k, line in run.largest_collectives():
        print(f"  {w:.0f}  x{k}  {line}")


if __name__ == "__main__":
    main()

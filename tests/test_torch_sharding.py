"""The port's sharding rules (``repro_torch.distributed.sharding``) against
the JAX package's, with no process group.

* Every leaf of every full config's parameter tree gets the reference's
  ``spec_for`` under ``default_rules`` with and without FSDP (and, under 1e9
  parameters, the dry run's all-``None`` rules) on the 16×16 and 2×16×16
  production meshes and the 2×2 and 2×2×2 debug meshes; so does every leaf
  of every config's ``decode_32k`` cache (``cache_spec_for_leaf``) and
  ``data_spec`` at B in {1, 8, 128, 256}.  The reference's functions read
  only ``mesh.shape`` (and ``axis_names``), so both take the port's
  ``MeshShape``, as the reference's own test takes a fake mesh.
* The reference's own cases (``tests/test_moe_data_dist.py:122-139``).
* The blocks each rank holds: in a JAX subprocess with 8 host devices,
  ``NamedSharding(...).devices_indices_map`` on the 2×2 and 2×2×2 debug
  meshes, device by device, against DTensor's
  ``compute_local_shape_and_global_offset`` of the port's placements on a
  fake process group of world 4 and 8 (and the port's ``local_block``), for
  one smoke config a family: parameters, decode cache, a batch and the dry
  run's activations.  This pins the major-to-minor order of a tuple spec.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import registry as ref_registry
from repro.configs.base import SHAPES as REF_SHAPES
from repro.distributed import sharding as ref_shd
from repro.launch import input_specs as ref_ispec
from repro.models import model as RM
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES
from repro_torch.distributed import sharding as shd
from repro_torch.launch import input_specs, mesh
from repro_torch.models import model as M
from repro_torch.models.layers import leaves

ROOT = Path(__file__).resolve().parents[1]
MESHES = {"16x16": mesh.production_shape(), "2x16x16": mesh.production_shape(multi_pod=True),
          "2x2": mesh.debug_shape(2, 2), "2x2x2": mesh.debug_shape(2, 2, pod=2)}
ARCHS = sorted(registry.ARCHS)
#: one smoke config a family (and the two attention kinds)
FAMILY_ARCHS = ("llama3.2-3b", "minicpm3-4b", "olmoe-1b-7b", "mamba2-1.3b",
                "jamba-1.5-large-398b", "whisper-small", "internvl2-26b")


def rule_sets(n_params: int, multi: bool):
    sets = {"fsdp": ref_shd.default_rules(multi), "no_fsdp": ref_shd.default_rules(multi, False)}
    if n_params < 1e9:   # the dry run's pure data parallelism
        sets["dryrun_small"] = {k: None for k in sets["fsdp"]}
    return sets


def test_rules_and_specs_are_the_reference_tables():
    for multi in (False, True):
        for fsdp in (False, True):
            assert shd.default_rules(multi, fsdp) == ref_shd.default_rules(multi, fsdp)
    assert shd.PartitionSpec("data", None) == ("data", None)
    assert shd.PartitionSpec() == ()


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference_on_every_mesh(arch):
    cfg, ref_cfg = registry.get_config(arch), ref_registry.get_config(arch)
    ref_abs = dict(leaves(jax.tree.map(lambda a: tuple(a.shape), RM.abstract(ref_cfg))))
    axes = dict(leaves(M.axes(cfg)))
    ref_axes = dict(leaves(RM.axes(ref_cfg)))
    assert axes.keys() == ref_abs.keys() and {k: tuple(v) for k, v in ref_axes.items()} == axes
    shapes = {k: tuple(t.shape) for k, t in leaves(M.abstract(cfg))}
    assert shapes == ref_abs
    n = 0
    for name, m in MESHES.items():
        for rname, rules in rule_sets(M.n_params(cfg), "pod" in m.axis_names).items():
            got = shd.tree_shardings(M.abstract(cfg), M.axes(cfg), m, rules)
            for path, s in leaves(got):
                want = tuple(ref_shd.spec_for(shapes[path], axes[path], m, rules))
                assert tuple(s.spec) == want, (arch, name, rname, path, s.spec, want)
                shd.placements(s.spec, m)   # every spec has placements on its mesh
                n += 1
    assert n >= 4 * 2 * len(shapes)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_cache_specs_equal_reference(arch):
    cfg, ref_cfg = registry.get_config(arch), ref_registry.get_config(arch)
    cache, tokens, pos = input_specs.decode_specs(cfg, SHAPES["decode_32k"])
    ref_cache, _, _ = ref_ispec.decode_specs(ref_cfg, REF_SHAPES["decode_32k"])
    ref_shapes = dict(leaves(jax.tree.map(lambda a: tuple(a.shape), ref_cache)))
    assert {k: tuple(t.shape) for k, t in leaves(cache)} == ref_shapes
    for name, m in MESHES.items():
        got = shd.cache_shardings(cache, m)
        for path, s in leaves(got):
            want = tuple(ref_shd.cache_spec_for_leaf(ref_shapes[path], m))
            assert tuple(s.spec) == want, (arch, name, path)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_data_specs_equal_reference(name):
    m = MESHES[name]
    assert shd.batch_axes(m) == ref_shd.batch_axes(m)
    for B in (1, 8, 128, 256):
        for ndim in (1, 2, 3):
            assert tuple(shd.data_spec(m, B, ndim)) == tuple(ref_shd.data_spec(m, B, ndim))
    assert tuple(shd.replicated(m).spec) == ()


def test_reference_spec_for_cases():
    """``tests/test_moe_data_dist.py::test_spec_for_divisibility_and_conflicts``."""
    m = mesh.production_shape()
    rules = shd.default_rules(multi_pod=False)
    # heads=24 not divisible by 16 → dropped; ffn=8192 divisible → model
    assert shd.spec_for((3072, 24, 128), ("embed", "heads", "head_dim"), m, rules) == ("data",)
    assert shd.spec_for((3072, 8192), ("embed", "ffn"), m, rules) == ("data", "model")
    # conflict: vocab and ffn both want model → second drops
    assert shd.spec_for((4096, 8192), ("vocab", "ffn"), m, rules) == ("model",)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard

    m3 = MESHES["2x2x2"]
    assert shd.placements(shd.PS(("pod", "data"), None, "model"), m3) == (
        Shard(0), Shard(0), Shard(2))
    assert shd.placements(shd.PS(), m3) == (Replicate(),) * 3
    assert shd.placements(shd.PS(None, "data"), MESHES["2x2"]) == (Shard(1), Replicate())
    for bad in (shd.PS(("data", "pod")), shd.PS("data", "data"), shd.PS("expert")):
        with pytest.raises(ValueError):
            shd.placements(bad, m3)
    assert shd.local_block((8, 6), shd.PS(("pod", "data")), m3, (1, 0, 1)) == ((4, 6), (0, 6))
    assert shd.local_shape((8, 6), shd.PS(("pod", "data"), "model"), m3) == (2, 3)


def test_step_layout_is_the_dry_runs():
    m = MESHES["16x16"]
    small = shd.step_layout(M.n_params(registry.get_config("whisper-small")), m)
    assert all(v is None for v in small.rules.values())
    assert small.batch_axes == ("data", "model") and small.act_spec == (("data", "model"),
                                                                          None, None)
    big = shd.step_layout(M.n_params(registry.get_config("jamba-1.5-large-398b")),
                          MESHES["2x16x16"])
    assert big.rules == ref_shd.default_rules(True) and big.batch_axes == ("pod", "data")
    assert big.state_dtype == "bfloat16"
    mid = shd.step_layout(M.n_params(registry.get_config("llama3.2-3b")), m)
    assert mid.rules == ref_shd.default_rules(False) and mid.state_dtype == "float32"
    assert shd.batch_spec_for(m, mid, (256, 4096)) == (("data",), None)
    # 32 rows do not split 256 ways: the data axis alone, as data_spec
    assert shd.batch_spec_for(m, small, (32, 4096)) == ("data", None)
    assert shd.batch_spec_for(m, small, (8, 4096)) == (None, None)


# ---------------------------------------------------------------------------
# The blocks each rank holds
# ---------------------------------------------------------------------------

JAX_BLOCKS = r"""
import json, sys
import jax, numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as PS
cases = json.loads(sys.stdin.read())
out = []
for c in cases:
    devs = np.array(jax.devices()[: int(np.prod(c["mesh"]))]).reshape(c["mesh"])
    m = Mesh(devs, tuple(c["axes"]))
    spec = PS(*[tuple(e) if isinstance(e, list) else e for e in c["spec"]])
    idx = NamedSharding(m, spec).devices_indices_map(tuple(c["shape"]))
    out.append([[[s.start or 0, s.stop if s.stop is not None else n]
                 for s, n in zip(idx[d], c["shape"])] for d in devs.flat])
print(json.dumps(out))
"""


def block_cases():
    """(mesh name, shape, spec) for each family's parameters, cache, a batch
    and the dry run's activations on both debug meshes."""
    cases = []
    for name in ("2x2", "2x2x2"):
        m = MESHES[name]
        for arch in FAMILY_ARCHS:
            cfg = registry.get_config(arch, smoke=True)
            rules = shd.default_rules("pod" in m.axis_names)
            tree = shd.tree_shardings(M.abstract(cfg), M.axes(cfg), m, rules)
            shapes = dict(leaves(M.abstract(cfg)))
            cases += [(name, tuple(shapes[k].shape), s.spec) for k, s in leaves(tree)]
            cache = M.init_cache(cfg, 8, 16, torch.float32, "meta")
            cache_sh = dict(leaves(shd.cache_shardings(cache, m)))
            cases += [(name, tuple(t.shape), cache_sh[k].spec) for k, t in leaves(cache)]
        small = shd.step_layout(1, m)
        cases += [(name, (8, 16), shd.data_spec(m, 8, 2)), (name, (8, 4, 16), small.act_spec)]
    return cases


def _json_spec(spec):
    return [list(e) if isinstance(e, tuple) else e for e in spec]


def test_rank_blocks_equal_reference_devices(tmp_path):
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    from torch.testing._internal.distributed.fake_pg import FakeStore

    cases = block_cases()
    payload = json.dumps([{"mesh": list(MESHES[n].sizes), "axes": list(MESHES[n].axis_names),
                           "shape": list(shape), "spec": _json_spec(spec)}
                          for n, shape, spec in cases])
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    done = subprocess.run([sys.executable, "-c", JAX_BLOCKS], input=payload, text=True,
                          capture_output=True, env=env, timeout=240)
    assert done.returncode == 0, done.stderr
    want = json.loads(done.stdout)
    assert dist.is_initialized() is False
    n_checked = 0
    for name in ("2x2", "2x2x2"):
        m = MESHES[name]
        picked = [(i, shape, spec) for i, (n, shape, spec) in enumerate(cases) if n == name]
        for rank in range(m.size):
            dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=m.size)
            try:
                dm = init_device_mesh("cpu", m.sizes, mesh_dim_names=m.axis_names)
                coord = dm.get_coordinate()
                for i, shape, spec in picked:
                    size, off = compute_local_shape_and_global_offset(
                        shape, dm, shd.placements(spec, dm))
                    got = [[o, o + s] for o, s in zip(off, size)]
                    assert got == want[i][rank], (name, rank, shape, spec, got, want[i][rank])
                    assert [list(b) for b in shd.local_block(shape, spec, m, coord)] == got
                    n_checked += 1
            finally:
                dist.destroy_process_group()
    assert n_checked == sum(MESHES[n].size for n, _, _ in cases)

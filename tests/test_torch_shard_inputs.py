"""The sharding group's inputs and edges, on the CPU.

* ``launch/input_specs``: for every config × ``shapes_for`` cell the port's
  ``meta`` tensors have the shapes and dtypes of the reference's
  ``ShapeDtypeStruct``s (train/prefill batches, decode cache, tokens, pos),
  and ``shape_adjusted_config`` is the reference's.
* ``launch/mesh``: the production meshes need a process group of their
  world (none raises, a world of another size raises); on a fake group of
  world 256 and 512 they are 16×16 and 2×16×16 ``DeviceMesh``es.
* With plain tensors the step's specs change nothing: the train step with
  ``batch_spec``/``act_spec`` given equals the one without, bit for bit,
  and the DTensor helpers pass plain tensors through.
* The entry points added to the card's default: ``init_cache`` and
  ``convert`` raise without CUDA unless the caller names the CPU.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_lm_parity as parity
import torch_lm_train_parity as tp
from repro.configs import registry as ref_registry
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.base import shapes_for as ref_shapes_for
from repro.launch import input_specs as ref_ispec
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, shapes_for
from repro_torch.distributed import dtensor
from repro_torch.distributed import sharding as shd
from repro_torch.launch import input_specs, mesh
from repro_torch.models import convert, steps
from repro_torch.models import model as M
from repro_torch.models.layers import leaves
from repro_torch.optim import adamw

ARCHS = sorted(registry.ARCHS)


def _sig(a):
    return tuple(a.shape), str(jnp.dtype(a.dtype)) if not isinstance(a, torch.Tensor) else \
        str(a.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_equal_reference(arch):
    cfg, ref_cfg = registry.get_config(arch), ref_registry.get_config(arch)
    assert shapes_for(cfg) == ref_shapes_for(ref_cfg)
    for name in shapes_for(cfg):
        shape, ref_shape = SHAPES[name], REF_SHAPES[name]
        assert dataclasses.asdict(input_specs.shape_adjusted_config(cfg, shape)) == \
            dataclasses.asdict(ref_ispec.shape_adjusted_config(ref_cfg, ref_shape))
        if shape.kind == "decode":
            got = input_specs.decode_specs(cfg, shape)
            want = ref_ispec.decode_specs(ref_cfg, ref_shape)
            assert {k: _sig(a) for k, a in leaves(got[0])} == \
                {k: _sig(a) for k, a in leaves(jax.tree.map(lambda x: x, want[0]))}
            assert _sig(got[1]) == _sig(want[1]) and _sig(got[2]) == _sig(want[2])
            assert all(t.device.type == "meta" for _, t in leaves(got[0]))
        else:
            got = input_specs.batch_specs(cfg, shape)
            want = ref_ispec.batch_specs(ref_cfg, ref_shape)
            assert {k: _sig(a) for k, a in got.items()} == {k: _sig(a) for k, a in want.items()}
    assert input_specs.WHISPER_DEC_LEN == ref_ispec.WHISPER_DEC_LEN == 448


def test_production_meshes_need_their_world():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    assert not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        mesh.make_production_mesh()
    for multi, world, names in ((False, 256, ("data", "model")),
                                (True, 512, ("pod", "data", "model"))):
        dist.init_process_group("fake", store=FakeStore(), rank=3, world_size=world)
        try:
            m = mesh.make_production_mesh(multi_pod=multi)
            assert m.mesh_dim_names == names and m.size() == world
            assert shd.mesh_sizes(m) == mesh.production_shape(multi_pod=multi).shape
            with pytest.raises(ValueError, match="world"):
                mesh.make_production_mesh(multi_pod=not multi)
        finally:
            dist.destroy_process_group()


@pytest.fixture
def one_thread():
    """Smoke sizes: one thread, which a loaded machine does not thrash."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", ["llama3.2-3b", "olmoe-1b-7b"])
def test_specs_change_nothing_on_plain_tensors(arch, one_thread):
    """The one-device step is the step with no spec, bit for bit."""
    cfg = registry.get_config(arch, smoke=True)
    base = M.init(cfg, 0, "cpu").params()
    b = parity.torch_batch(tp.batch(cfg, B=4))
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    outs = []
    for specs in ({}, {"batch_spec": ("data",), "act_spec": shd.PS(("data",), None, None)}):
        params = _clone(base)
        new, opt, m = steps.make_train_step(cfg, opt_cfg, accum=2, **specs)(
            params, adamw.init(params, opt_cfg), b)
        outs.append((float(m["loss"]), float(m["grad_norm"]),
                     {k: p.detach().clone() for k, p in leaves(new)}))
    assert outs[0][:2] == outs[1][:2]
    assert all(torch.equal(outs[0][2][k], outs[1][2][k]) for k in outs[0][2])
    assert dtensor.replications() == {}


def _clone(v):
    return {k: _clone(x) for k, x in v.items()} if isinstance(v, dict) else v.detach().clone()


def test_dtensor_helpers_pass_plain_tensors():
    t = torch.arange(24.0).reshape(2, 3, 4)
    assert dtensor.constrain(t, shd.PS("data")) is t and dtensor.full(t) is t
    assert dtensor.gather_dim("x", t, 0) is t
    want = t.clone()
    want[:, 1] = -1.0
    dtensor.write_at(t, {1: 1}, torch.full((2, 4), -1.0))
    assert torch.equal(t, want)
    assert dtensor.replicated_call("x", lambda a: a * 2, t).equal(t * 2)
    assert "x" not in dtensor.replications() and not dtensor.any_dtensor({"a": [t]})


def test_entry_points_default_to_the_card(monkeypatch):
    cfg = registry.get_config("llama3.2-3b", smoke=True)
    arrays = {k: np.zeros(s.shape, np.float32) for k, s in leaves(M.specs(cfg))}
    tree = {}
    for k, a in arrays.items():
        node = tree
        for part in k[:-1]:
            node = node.setdefault(part, {})
        node[k[-1]] = a
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for call in (lambda: M.init_cache(cfg, 1, 4),
                 lambda: convert.from_jax_params(cfg, tree),
                 lambda: convert.tree_from_jax(tree)):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert M.init_cache(cfg, 1, 4, device="cpu")["k"].device.type == "cpu"
    assert M.init_cache(cfg, 1, 4, device="meta")["k"].device.type == "meta"
    assert convert.from_jax_params(cfg, tree, "cpu").n_params() == M.n_params(cfg)

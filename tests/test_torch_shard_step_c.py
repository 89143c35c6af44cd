"""The sharded step on 4 gloo ranks equals the one-device step:
jamba-1.5-large-398b (hybrid: attention, Mamba and MoE sublayers), its
smoke config cut to one super-block (``test_torch_shard_step.py`` has the
setting).

And checkpoints restore onto the mesh: one written by the reference's
manager and one by the port's, from the same weights and AdamW state,
restored by the ranks onto the 2×2 mesh's placements
(``CheckpointManager.restore(shardings=)``) and gathered back equal to the
saved arrays bit for bit.
"""
import jax
import numpy as np
import pytest
import torch

import torch_lm_parity as parity
import torch_shard_parity as sp
from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.optim import adamw as ref_adamw
from repro_torch.checkpoint.manager import CheckpointManager, flatten
from repro_torch.models import convert
from repro_torch.optim import adamw

ARCHS = ("jamba-1.5-large-398b",)
#: jamba's smoke config cut to one super-block (attention, three Mamba, two
#: MLP and two MoE sublayers): the second repeats the first's ops
CHANGES = {"jamba-1.5-large-398b": {"n_layers": 4}}
CKPT_ARCH = "llama3.2-3b"


def write_checkpoints(root):
    """The reference's and the port's checkpoint of one state; returns
    ``{key: saved array}``."""
    ref_cfg, params, cfg, _ = sp.tp.models(CKPT_ARCH)
    ropt = ref_adamw.init(params, ref_adamw.AdamWConfig())
    # a non-trivial state: moments and step set from the weights
    ropt = ref_adamw.AdamWState(step=ropt.step + 3, m=jax.tree.map(lambda a: a * 0.5, params),
                                v=jax.tree.map(lambda a: a * a, params))
    state = {"params": params, "opt": ropt}
    RefManager(root / "ref").save(3, state, extra={"by": "reference"})
    (root / "ref" / "ready").touch()
    np_state = parity.np_tree(state)
    port = {"params": convert.tree_from_jax(np_state["params"], "cpu"),
            "opt": adamw.AdamWState(torch.tensor(int(np_state["opt"].step)),
                                    convert.tree_from_jax(np_state["opt"].m, "cpu"),
                                    convert.tree_from_jax(np_state["opt"].v, "cpu"))}
    CheckpointManager(root / "port").save(3, port, extra={"by": "port"})
    (root / "port" / "ready").touch()
    return {k: np.asarray(v) for k, v in flatten(np_state).items()}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("shard_step_c")
    restore = [{"arch": CKPT_ARCH, "dir": str(root / d)} for d in ("ref", "port")]
    r = sp.Run(root, ARCHS, restore, CHANGES)
    r.saved = write_checkpoints(root)
    return r.finish()


@pytest.mark.parametrize("arch", ARCHS)
def test_sharded_step_equals_one_device(run, arch):
    assert run.check(arch) <= sp.tp.grad_rel(arch)


def test_only_the_moe_dispatch_was_replicated(run):
    reps = run.replications()
    assert set(reps) == {"moe.topk", "moe.dispatch", "moe.combine"}


@pytest.mark.parametrize("i,by", [(0, "reference"), (1, "port")])
def test_checkpoint_restores_onto_the_mesh(run, i, by):
    got = dict(np.load(run.job_dir / f"restored_{i}.npz"))
    assert bool(got.pop("placements_ok"))
    assert str(got.pop("extra")) == '{"by": "%s"}' % by
    got = {k.replace("|", "/"): v for k, v in got.items()}
    assert set(got) == set(run.saved)
    for k, want in run.saved.items():
        want = want.astype(np.float32) if want.dtype.kind == "f" else want
        assert got[k].dtype == want.dtype and np.array_equal(got[k], want), k

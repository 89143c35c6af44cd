"""A sharded train state saved by 4 gloo ranks, and a batch whose
microbatch count does not divide over the data axis.

* The microbatch split: llama3.2-3b's smoke config on the 2×2 ``("data",
  "model")`` mesh under the full config's layout, a batch of 6 rows at
  accum 3.  Each rank holds 3 rows and 3 microbatches of 2 do not split
  over 2 data ranks, which DTensor's view cannot keep sharded: the batch is
  gathered first (``dtensor.split_dim``, counted as ``microbatch.reshape``)
  and each microbatch constrained back onto ``("data",)``.  The step's
  gradients, prefill, decode and train step equal the one-device step's
  within ``torch_shard_parity``'s bounds.
* The save: after that train step the ranks save the sharded state
  (parameters, AdamW ``m``, ``v`` and ``step``) with
  ``CheckpointManager.save``: every rank gathers each leaf, rank 0 writes.
  The reference's ``CheckpointManager.restore`` reads the one checkpoint
  bit-equal to the state the ranks gathered, and the ranks' own
  ``restore(shardings=)`` put it back onto the mesh bit-equal, each leaf in
  its saved placements (checked in ``torch_shard_rank.save_and_restore``).
* The collective recorder (``distributed.hlo``) over gloo: the ranks'
  train step's collectives, with the reference's op names.
"""
import jax
import numpy as np
import pytest

import torch_shard_parity as sp
from repro.checkpoint.manager import CheckpointManager as RefManager
from repro.configs import registry as ref_registry
from repro.models import model as RM
from repro.optim import adamw as ref_adamw

ARCH = "llama3.2-3b"
ROWS, ACCUM = 6, 3


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    root = tmp_path_factory.mktemp("shard_save")
    save = [{"arch": ARCH, "dir": str(root / "ckpt")}]
    r = sp.Run(root, (ARCH,), rows=ROWS, accum=ACCUM, save=save)
    r.ckpt = root / "ckpt"
    return r.finish()


def test_uneven_microbatch_step_equals_one_device(run):
    assert run.check(ARCH) <= sp.tp.grad_rel(ARCH)


def test_the_uneven_split_gathered_the_batch(run):
    # the tokens and the loss mask, in the gradients' call and the train step's
    assert run.replications() == {"microbatch.reshape": 2 * 2}


def test_sharded_save_is_one_checkpoint_in_the_reference_format(run):
    assert sorted(p.name for p in run.ckpt.iterdir()) == ["step_0000000001"]
    assert sorted(p.name for p in (run.ckpt / "step_0000000001").iterdir()) == \
        ["host0.npz", "manifest.json"]


def test_reference_restores_the_sharded_save_bit_equal(run):
    saved = dict(np.load(run.job_dir / f"saved_{ARCH}.npz"))
    assert str(saved.pop("extra")) == '{"by": "ranks"}'
    saved = {k.replace("|", "/"): v for k, v in saved.items()}
    ref_cfg = ref_registry.get_config(ARCH, smoke=True)
    params = RM.abstract(ref_cfg)
    opt = jax.eval_shape(lambda p: ref_adamw.init(p, ref_adamw.AdamWConfig()), params)
    state, extra = RefManager(run.ckpt).restore({"params": params, "opt": opt})
    assert extra == {"by": "ranks"}
    got = {"/".join(str(k) for k in path): np.asarray(leaf)
           for path, leaf in jax.tree_util.tree_flatten_with_path(state)[0]}
    assert set(got) == set(saved) and "['opt']/.step" in got
    for k, want in saved.items():
        assert got[k].dtype == want.dtype and np.array_equal(got[k], want), k
    assert int(got["['opt']/.step"]) == 1


def test_recorder_counts_the_train_steps_collectives_over_gloo(run):
    import json

    out = np.load(run.job_dir / f"out_{ARCH}.npz")
    summary = json.loads(str(out["collectives"]))
    # FSDP's gathers, the gradients' reductions, the gathered batch
    assert summary["count"] > 0 and summary["all-gather"] > 0
    assert set(summary) - {"total_wire_bytes_per_device", "count"} <= {
        "all-gather", "all-reduce", "reduce-scatter", "all-to-all"}
    assert summary["total_wire_bytes_per_device"] == pytest.approx(
        sum(v for k, v in summary.items() if k not in ("total_wire_bytes_per_device", "count")))

"""The port's collective inventory and wire bytes
(``repro_torch.distributed.hlo``) against the JAX package's
``distributed/hlo.py``.

* ``wire_bytes_per_device`` equals the reference's for each of the five
  ops at group sizes 1, 2, 4 and 16.
* The reference's own HLO case (``tests/test_moe_data_dist.py``'s parser
  test), given to the port as the three collectives it describes, gives the
  reference's summary.
* The recorder on a fake process group of 4 ranks (a 2×2 ``("data",
  "model")`` mesh, ``FakeTensorMode`` tensors) sees the exact result bytes,
  group size and op of each redistribution: an all-gather of a
  ``Shard(0)`` tensor, a pending sum reduced to ``Replicate`` (all-reduce)
  and scattered to ``Shard(0)`` (reduce-scatter), and a shard moved from dim
  0 to dim 1 (an all-to-all under ``hlo.alltoall_on_cpu_meshes``; without
  it, a CPU mesh all-gathers instead).
"""
import textwrap

import pytest
import torch

from repro.distributed import hlo as ref_hlo
from repro_torch.distributed import hlo

OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all", "collective-permute")


@pytest.mark.parametrize("op", OPS)
@pytest.mark.parametrize("g", (1, 2, 4, 16))
def test_wire_bytes_equal_reference(op, g):
    for nbytes in (0, 2, 4096, 3 * 1024 ** 3):
        got = hlo.wire_bytes_per_device(hlo.Collective(op, nbytes, g, ""))
        want = ref_hlo.wire_bytes_per_device(ref_hlo.Collective(op, nbytes, g, ""))
        assert got == want, (op, g, nbytes)


def test_reference_hlo_case_summary():
    txt = textwrap.dedent("""\
      %ag = bf16[16,1024]{1,0} all-gather(bf16[1,1024]{1,0} %p), replica_groups={{0,1,2,3},{4,5,6,7}}, dimensions={0}
      %ar = f32[128]{0} all-reduce(f32[128]{0} %x), replica_groups=[4,16]<=[64] to_apply=%add
      %rs = f32[8]{0} reduce-scatter(f32[128]{0} %y), replica_groups={{0,1}}
      %done = f32[8]{0} all-reduce-done(f32[8]{0} %h)
    """)
    colls = [hlo.Collective("all-gather", 16 * 1024 * 2, 4, "ag"),
             hlo.Collective("all-reduce", 128 * 4, 16, "ar"),
             hlo.Collective("reduce-scatter", 8 * 4, 2, "rs")]
    assert [(c.op, c.bytes_result, c.group_size) for c in colls] == \
        [(c.op, c.bytes_result, c.group_size) for c in ref_hlo.parse_collectives(txt, 64)]
    assert hlo.collective_summary(colls) == ref_hlo.collective_summary(txt, 64)


@pytest.fixture
def mesh():
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    from repro_torch.launch import mesh as mesh_mod

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
    try:
        yield mesh_mod.device_mesh(mesh_mod.debug_shape(2, 2), "cpu")
    finally:
        dist.destroy_process_group()


def _recorded(mesh, fn, alltoall=True):
    from torch._subclasses.fake_tensor import FakeTensorMode

    rec = hlo.CollectiveRecorder()
    with FakeTensorMode():
        with (hlo.alltoall_on_cpu_meshes() if alltoall else torch.no_grad()), rec:
            fn()
    return [(c.op, c.bytes_result, c.group_size) for c in rec.collectives]


def test_recorder_sees_each_redistribution(mesh):
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

    def dt(shape, placements, dtype=torch.float32):
        return DTensor.from_local(torch.zeros(shape, dtype=dtype), mesh, placements,
                                  run_check=False)

    R = Replicate()
    # a Shard(0) [8, 6] f32 gathered over "data": the full [8, 6] on each rank
    assert _recorded(mesh, lambda: dt((4, 6), [Shard(0), R]).redistribute(mesh, [R, R])) == \
        [("all-gather", 8 * 6 * 4, 2)]
    # a pending sum over "model" of [8, 4] bf16, reduced everywhere
    assert _recorded(mesh, lambda: dt((8, 4), [R, Partial()], torch.bfloat16).redistribute(
        mesh, [R, R])) == [("all-reduce", 8 * 4 * 2, 2)]
    # ... and scattered over dim 0: each rank keeps [4, 4]
    assert _recorded(mesh, lambda: dt((8, 4), [Partial(), R]).redistribute(
        mesh, [Shard(0), R])) == [("reduce-scatter", 4 * 4 * 4, 2)]
    # a shard moved from dim 0 to dim 1 of [8, 6]: [4, 6] in, [8, 3] out
    assert _recorded(mesh, lambda: dt((4, 6), [Shard(0), R]).redistribute(
        mesh, [Shard(1), R])) == [("all-to-all", 8 * 3 * 4, 2)]
    # without the card's all-to-all a CPU mesh gathers the whole [8, 6]
    assert _recorded(mesh, lambda: dt((4, 6), [Shard(0), R]).redistribute(
        mesh, [Shard(1), R]), alltoall=False) == [("all-gather", 8 * 6 * 4, 2)]


def test_recorder_summary_and_lines(mesh):
    from torch.distributed.tensor import DTensor, Replicate, Shard

    rec = hlo.CollectiveRecorder()
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode(), rec:
        x = DTensor.from_local(torch.zeros(4, 3), mesh, [Shard(0), Shard(1)], run_check=False)
        x.redistribute(mesh, [Replicate(), Replicate()])
    # DTensor gathers over "model" first (the collective stacks on dim 0 and
    # the blocks are moved to dim 1 after), then over "data"
    assert [c.line for c in rec.collectives] == [
        "all-gather float32[4, 3]->[8, 3] group 2", "all-gather float32[4, 6]->[8, 6] group 2"]
    assert rec.summary() == {"total_wire_bytes_per_device": 0.5 * 96 + 0.5 * 192,
                             "count": 2, "all-gather": 0.5 * 96 + 0.5 * 192}


def test_step_meter_counts_a_gathered_tensor_once(mesh):
    """``launch/dryrun.StepMeter``'s live bytes: a collective's result and
    the ``wait_tensor`` after it are one storage on a device (the fake
    ``wait_tensor`` makes a second), counted once while either lives; the
    wait moves no bytes."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import DTensor, Replicate, Shard

    from repro_torch.launch import dryrun

    with FakeTensorMode():
        x = DTensor.from_local(torch.zeros(4, 6), mesh, [Shard(0), Replicate()],
                               run_check=False)
        meter = dryrun.StepMeter([x.to_local()])
        with meter:
            full = x.redistribute(mesh, [Replicate(), Replicate()]).to_local()
            assert meter.live == 8 * 6 * 4
        del full
    assert meter.peak == 8 * 6 * 4 and meter.live == 0
    assert [c.op for c in meter.collectives] == ["all-gather"]
    # the all-gather reads its [4, 6] and writes [8, 6]
    assert meter.bytes_accessed == (4 * 6 + 8 * 6) * 4

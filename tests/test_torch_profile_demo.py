"""The port's profiled demo mine on its default database, on the CPU: it
exits 0, prints an attribution row for each of the five dispatch families,
and finds the |F| that ``repro.core.fimi.run`` finds on the same database."""
import re

import jax
import numpy as np

from repro.core import eclat as ref_eclat
from repro.core import fimi as ref_fimi
from repro.data.ibm_gen import generate_dense, params_from_name
from repro_torch.launch import profile_demo
from repro_torch.obs import profile as obs_profile


def test_demo_runs_every_family_and_finds_the_references_fis(capsys):
    args = profile_demo.build_parser().parse_args(["--device", "cpu"])
    dense = generate_dense(params_from_name(args.db, seed=args.seed))
    demo = profile_demo.run(dense, args)
    out = capsys.readouterr().out
    assert profile_demo.main(["--device", "cpu"]) == 0
    assert demo.missing == [] and not obs_profile.PROFILER.enabled
    for family in obs_profile.FAMILIES:
        assert re.search(rf"^  {family} +calls=\d+ +loop_execs=0 +measured=\d", out, re.M), family
    fams = demo.report["families"]
    assert fams["pair"]["calls"] == fams["subset"]["calls"] == args.reps
    # the mine's sweeps are timed calls too: Phase 1 and Phase 4 trips
    assert fams["multi"]["calls"] > args.reps
    assert all(n == 0 for n in demo.launches.values())       # the CPU launches no kernel

    ref = ref_fimi.run(
        ref_fimi.shard_db(dense, args.P), dense.shape[1],
        ref_fimi.FimiParams(min_support_rel=args.support, n_db_sample=256, n_fi_sample=256,
                            eclat=ref_eclat.EclatConfig(max_out=1 << 13, max_stack=2048,
                                                        frontier_size=args.frontier)),
        jax.random.PRNGKey(args.seed))
    assert f"|F| = {ref.n_fis} " in out
    assert demo.result.n_fis == ref.n_fis
    assert demo.pair_out.shape == (dense.shape[1],) * 2
    np.testing.assert_array_equal(np.diag(demo.pair_out.numpy()), dense.sum(axis=0))

"""The port's mine-then-serve launcher against the JAX package's.

``repro_torch.launch.serve_mine --device cpu`` on T1I0.032P20PL6TL10 at 0.08
mines the reference's |F|, builds the reference's R rules, draws the
reference's query stream (``build_workload``, numpy's generator), and its
replay (through the cache, kernel B4's plain version on the CPU) answers
every query as the JAX engine does, dispatching as many queries after the
cache as the reference's ``replay``.
"""
import numpy as np
import pytest

from repro.core import eclat as ref_eclat
from repro.data.ibm_gen import generate_dense, params_from_name
from repro.launch import serve_mine as ref_launch
from repro.serve import QueryCache as RefCache
from repro.serve import QueryEngine as RefEngine
from repro.serve import index as ref_index
from repro_torch.launch import serve_mine

DB, SUPPORT = "T1I0.032P20PL6TL10", 0.08


@pytest.fixture(scope="module")
def both():
    got = serve_mine.main(["--db", DB, "--support", str(SUPPORT), "--device", "cpu"])
    args = serve_mine.build_parser().parse_args(["--db", DB, "--support", str(SUPPORT)])
    dense = generate_dense(params_from_name(DB, seed=args.seed))
    fis = ref_eclat.brute_force_fis(dense, int(np.ceil(SUPPORT * dense.shape[0])))
    ref_fi, ref_rl = ref_index.build_indexes(fis, dense.shape[1], dense.shape[0],
                                             min_confidence=args.minconf)
    stream = ref_launch.build_workload(np.random.default_rng(args.seed + 1), fis, dense,
                                       dense.shape[1], args.queries, pool=args.pool)
    return got, args, fis, ref_fi, ref_rl, stream


def test_mines_and_indexes_as_the_reference(both):
    got, _, fis, ref_fi, ref_rl, _ = both
    assert got.fis == fis and len(fis) == 3370
    assert got.fi_index.n_fis == ref_fi.n_fis and got.rule_index.n_rules == ref_rl.n_rules
    assert got.launches["subset_superset_counts"] == 0     # the CPU launches no kernel


def test_workload_is_the_reference_stream(both):
    got, _, _, _, _, stream = both
    assert len(got.stream) == len(stream) == 1024
    for (k1, m1), (k2, m2) in zip(got.stream, stream):
        assert k1 == k2 and m1.dtype == m2.dtype == np.uint32
        np.testing.assert_array_equal(m1, m2)


def test_replay_answers_equal_the_reference_engine(both):
    got, args, _, ref_fi, ref_rl, stream = both
    cache = RefCache(capacity=args.cache)
    engine = RefEngine(ref_fi, ref_rl, batch=args.batch, top_k=args.topk, cache=cache)
    ref_launch.warm(stream, engine)
    _, n_dispatched = ref_launch.replay(stream, engine, cache, args.batch)
    assert got.n_dispatched == n_dispatched
    assert got.cache.stats.as_dict() == cache.stats.as_dict()
    # the reference's answer to each query, straight from its engine
    call = {"support": engine.support, "rules": engine.rules_for, "superset": engine.supersets}
    for kind in ("support", "rules", "superset"):
        at = [i for i, (k, _) in enumerate(stream) if k == kind]
        for lo in range(0, len(at), args.batch):
            part = at[lo: lo + args.batch]
            want = call[kind](np.stack([stream[i][1] for i in part]))
            for j, i in enumerate(part):
                answer = got.answers[i]
                if kind == "support":
                    assert answer == want[j]
                    continue
                np.testing.assert_array_equal(np.asarray(answer[0]), want[0][j])
                got_v, want_v = np.asarray(answer[1]), want[1][j]
                assert got_v.dtype == want_v.dtype
                if kind == "rules":   # float32 confidences: NaN where no hit
                    np.testing.assert_array_equal(np.isnan(got_v), np.isnan(want_v))
                    got_v, want_v = np.nan_to_num(got_v), np.nan_to_num(want_v)
                np.testing.assert_array_equal(got_v.view(np.uint32), want_v.view(np.uint32))

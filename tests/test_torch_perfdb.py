"""The port's perf history (``obs/perfdb.py``) against the JAX package's.

The row format is the reference's, byte for byte, so a history written by
either package loads in the other (and in the reference's ``obs_report``);
``direction``, ``trends``, ``check_regressions`` and ``bench_result_keys``
give the reference's answers on the same rows.  The port's default file is
its own, ``BENCH_torch_HISTORY.jsonl``.  Every file lives under ``tmp_path``.
"""
import dataclasses
import json

import numpy as np
import pytest

from repro.launch import obs_report
from repro.obs import perfdb as ref_perfdb
from repro_torch.obs import perfdb

KEYS = ("wall_ms", "mine_s", "x_us", "peak_bytes", "stall_frac", "y_qps", "io_speedup",
        "gain_improvement", "overhead_ratio", "slowdown", "prefetch_stall", "latency_p99",
        "slo_burn_rate", "loss", "slo_p99_ms", "slo_qps", "n_fis", "Wall_MS", "count",
        "slo_gate_ok", "hit_frac", "speedup_1_to_4")


def test_default_path_is_the_ports_own():
    assert perfdb.DEFAULT_PATH == "BENCH_torch_HISTORY.jsonl"
    assert perfdb.DEFAULT_PATH != ref_perfdb.DEFAULT_PATH


@pytest.mark.parametrize("key", KEYS)
def test_direction_equals_the_reference(key):
    assert perfdb.direction(key) == ref_perfdb.direction(key)


@pytest.mark.parametrize("written_by", ["port", "reference"])
def test_history_loads_in_the_other_package(tmp_path, written_by):
    writer, reader = (perfdb, ref_perfdb) if written_by == "port" else (ref_perfdb, perfdb)
    p = str(tmp_path / "hist.jsonl")
    rows = [writer.append(p, "serve_load", {"slo_p99_ms": 3.5, "slo_gate_ok": True,
                                            "note": "x", "n": 4}, sha="abc", backend="cuda",
                          ts="T"),
            writer.append(p, "io", {"mine_slowdown_streamed": 1.2})]
    with open(p, "a") as f:
        f.write('{"torn...\n[1, 2]\n{"suite": "x"}\n\n')
    got, want = reader.load(p), writer.load(p)
    assert got == want and got[1] == 3
    assert got[0] == rows and got[0][0]["keys"] == {"slo_p99_ms": 3.5, "n": 4.0}
    # the reference's report reads it too
    assert obs_report.main(["history", "--history", p, "--suite", "serve_load"]) == 0


def test_rows_are_byte_identical(tmp_path):
    a, b = str(tmp_path / "a.jsonl"), str(tmp_path / "b.jsonl")
    for mod, p in ((perfdb, a), (ref_perfdb, b)):
        mod.append(p, "s", {"z_ms": 1.0, "a_qps": 2, "flag": False}, sha="f00", ts="2026")
        mod.append(p, "t", {}, sha="", backend="cpu", ts="2027")
    assert open(a, "rb").read() == open(b, "rb").read()


def test_stamps_equal_the_reference():
    assert perfdb.utc_stamp(1.7e9) == ref_perfdb.utc_stamp(1.7e9)
    assert perfdb.git_sha() == ref_perfdb.git_sha()


def _history(seed: int):
    """Rows of a few suites and keys with drifting values, some regressing."""
    rng = np.random.default_rng(seed)
    rows = []
    for i in range(int(rng.integers(1, 14))):
        for suite in ("serve_load", "kernels"):
            keys = {k: float(rng.lognormal(0, 0.3)) * (1 + (i > 8) * rng.random())
                    for k in rng.choice(KEYS, size=6, replace=False)}
            rows.append({"ts": f"t{i}", "sha": f"s{i}", "backend": "cpu", "suite": suite,
                         "keys": keys})
    return rows


def _regressions(mod, rows, **kw):
    found, n = mod.check_regressions(rows, **kw)
    return [dataclasses.asdict(r) for r in found], n, [r.line() for r in found]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("kw", [
    {},
    {"threshold": 0.05, "window": 3, "min_history": 1},
    {"degrade": 2.0},
    {"direction_overrides": {"n_fis": "higher", "wall_ms": "higher"}, "threshold": 0.1},
])
def test_trends_and_regressions_equal_the_reference(seed, kw):
    rows = _history(seed)
    assert perfdb.trends(rows) == ref_perfdb.trends(rows)
    assert perfdb.trends(rows, suite="kernels", key_match="_ms") == \
        ref_perfdb.trends(rows, suite="kernels", key_match="_ms")
    assert _regressions(perfdb, rows, **kw) == _regressions(ref_perfdb, rows, **kw)


def test_bench_result_keys_equal_the_reference():
    bench = {"bench": "serve", "backend": "cuda", "fast": True, "meta": {"git_sha": "x"},
             "reps": 5, "slo_qps": 3.0, "slo_gate_ok": True, "slo_p99_ms": 1.5,
             "entries": [{"name": "subset", "us": 12.5}, {"name": "noname"}]}
    assert perfdb.bench_result_keys(bench) == ref_perfdb.bench_result_keys(bench)
    assert json.dumps(perfdb.bench_result_keys(bench)) == \
        json.dumps(ref_perfdb.bench_result_keys(bench))

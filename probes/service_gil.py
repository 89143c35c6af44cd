#!/usr/bin/env python3
"""The serving service at half its micro-batched capacity, traced and not,
under the settings of the interpreter that share its one lock between threads.

  python3 probes/service_gil.py [--duration 6]      # one card

The thesis index pair of ``chip_smoke.py``'s ``service`` phase (T500I0.1P50PL10TL40
at support 0.2, minconf 0.5: 15,324 itemsets, 146,804 rules) is built once
and its capacity measured with ``serve_load.compare_dispatch``.  Then
``serve_load.serve`` (2 replicas, batch 64, deadline 4 ms, the cache on) takes
open-loop arrivals at half that capacity, once for each setting, in turns:
the interpreter's thread switch interval at its default (5 ms) or at 0.5 ms;
the heap built so far left to the collector or frozen out of it
(``gc.freeze``); and the tracer off, or on with ``chip_smoke.py``'s buffer of
8M events (a ``queue depth`` counter a submission, a ``service/shed`` instant
a shed, the flush spans).  It prints one JSON object with the offered and
served rates, sheds, flushes, batch fill, windowed latency, the collector's
passes and seconds (by generation) and the trace events of each run, and the
card's ``nvidia-smi`` line.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--duration", type=float, default=6.0, help="measured seconds a run")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import numpy as np
    import torch

    import chip_smoke
    from repro_torch.data import ibm_gen
    from repro_torch.launch import mine, serve_load
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve import QueryEngine
    from repro_torch.serve.index import build_indexes

    if not torch.cuda.is_available():
        chip_smoke.fail("CUDA is not available")
    dev = torch.device("cuda")
    dense = ibm_gen.generate_dense(ibm_gen.params_from_name(chip_smoke.THESIS_DB, seed=0))
    res, _ = mine.mine_dense(dense, support=chip_smoke.SUPPORT, P=4, frontier=16, device=dev,
                             materialize=True)
    fi, rl = build_indexes(res.fi_dict, dense.shape[1], dense.shape[0], min_confidence=0.5,
                           device=dev)
    base = chip_smoke.SERVICE_ARGS + ["--duration", str(args.duration)]
    sargs = serve_load.build_parser().parse_args(base)
    pools = serve_load.build_pools(np.random.default_rng(sargs.seed), res.fi_dict, dense,
                                   fi.n_items, pool=sargs.pool)
    capacity = serve_load.compare_dispatch(
        QueryEngine(fi, rl, batch=sargs.batch, top_k=sargs.topk),
        serve_load.Workload(np.random.default_rng(sargs.seed), pools, zipf_a=sargs.zipf,
                            drift_every=sargs.drift_every))
    target = capacity["batched_qps"] / 2
    runs = []
    default_switch = sys.getswitchinterval()
    tr = obs_trace.tracer()
    with tempfile.TemporaryDirectory() as tmp, contextlib.chdir(tmp):
        for switch_s, frozen in ((default_switch, False), (5e-4, False),
                                 (default_switch, True), (5e-4, True)):
            for traced in (False, True):
                sys.setswitchinterval(switch_s)
                if frozen:
                    gc.collect()
                    gc.freeze()
                obs_metrics.reset()
                tr.clear()
                tr.set_max_events(8_000_000)
                heap_objects = len(gc.get_objects())
                if traced:
                    tr.enable()
                try:
                    with chip_smoke.gc_account() as gc_acc:
                        run = serve_load.serve(
                            serve_load.build_parser().parse_args(base + ["--qps", str(target)]),
                            res.fi_dict, dense, fi, rl)
                finally:
                    tr.disable()
                    sys.setswitchinterval(default_switch)
                    gc.unfreeze()
                n_events, dropped = len(tr.export()["traceEvents"]), tr.dropped_events
                tr.clear()
                tr.set_max_events(obs_trace.DEFAULT_MAX_EVENTS)
                st, fin = run.svc.stats(), run.final
                served = len(run.tickets) - st["shed"]
                runs.append({
                    "switch_interval_s": switch_s, "gc_frozen": frozen, "traced": traced,
                    "offered_qps": len(run.tickets) / run.wall_s,
                    "served_qps": served / run.wall_s,
                    "shed": st["shed"], "errors": st["errors"], "flushes": st["flushes"],
                    "batch_fill_mean": served / max(st["flushes"], 1),
                    "window_ms": {"p50": fin.p50_ms, "p95": fin.p95_ms, "p99": fin.p99_ms},
                    "cache_hit_rate": st["cache"]["hit_rate"], "wall_s": run.wall_s,
                    "heap_tracked_objects": heap_objects,
                    "gc_passes": gc_acc["passes"], "gc_s": gc_acc["s"],
                    "trace_events": n_events, "trace_dropped": dropped})
                del run
    print(json.dumps({"probe": "service_gil", "nvidia_smi": chip_smoke.nvidia_smi(),
                      "n_fis": fi.n_fis, "n_rules": rl.n_rules, "capacity": capacity,
                      "target_qps": target, "runs": runs}), flush=True)


if __name__ == "__main__":
    main()

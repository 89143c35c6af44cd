"""Observability of the port: metrics registry, span tracing, run records,
the kernel profiler, the progress estimator, the serving tier's SLO windows,
the perf history and the diagnosis layer.

Own copies of the JAX package's ``obs`` modules, with the same behaviour and
the same on-disk record, so either package's ``launch/obs_report.py`` reads a
run of either package:

  * :mod:`repro_torch.obs.metrics`  — counters / gauges / histograms, one
    canonical snapshot shape;
  * :mod:`repro_torch.obs.trace`    — nested host spans, Chrome trace-event
    export, the CUDA ``sync`` helper, the ``torch_profiler`` hook;
  * :mod:`repro_torch.obs.runlog`   — per-run manifest + JSONL events +
    metrics snapshot;
  * :mod:`repro_torch.obs.session`  — the launchers' ``--trace`` /
    ``--metrics`` / ``--profile`` / ``--torch-profile`` / ``--doctor`` glue
    (atexit and SIGTERM partial flush);
  * :mod:`repro_torch.obs.machine`  — the machine constants (the H100 SXM,
    the host) that the profiler and ``chip_smoke.py``'s bounds price with;
  * :mod:`repro_torch.obs.profile`  — the kernel profiler: per-family
    measured-vs-modeled attribution;
  * :mod:`repro_torch.obs.slo`      — sliding-window histograms/counters and
    the SLO policy engine (windowed p50/p95/p99, QPS, shed rate,
    error-budget burn-rate alerts with hysteresis) behind the service;
  * :mod:`repro_torch.obs.perfdb`   — the stamped perf history
    (``BENCH_torch_HISTORY.jsonl``), its trends and regression check;
  * :mod:`repro_torch.obs.progress` — the sample-grounded progress/ETA
    estimator;
  * :mod:`repro_torch.obs.critpath` — span-DAG reconstruction over a run
    record's ``trace.json``: critical path + exclusive self-time;
  * :mod:`repro_torch.obs.speedup`  — the additive speedup-loss waterfall
    (imbalance / Thm 6.1 estimation error / exchange / warm-up / host);
  * :mod:`repro_torch.obs.doctor`   — the rules engine turning snapshot +
    critical path + waterfall into ranked findings with evidence keys.

The names below are resolved at first use, so importing one stdlib-only
module of this package (``critpath``, ``speedup``, ``doctor``, ``perfdb``,
``runlog``: what ``launch/obs_report.py`` reads with) does not import torch.
"""
import importlib

_EXPORTS = {
    "SpanDag": "critpath", "critical_path": "critpath",
    "Finding": "doctor", "Thresholds": "doctor", "diagnose": "doctor",
    "CPU_HOST": "machine", "H100_SXM": "machine", "MachineModel": "machine",
    "machine_for_device": "machine",
    "Counter": "metrics", "Gauge": "metrics", "Histogram": "metrics",
    "MetricsRegistry": "metrics", "registry": "metrics", "snapshot": "metrics",
    "check_regressions": "perfdb", "trends": "perfdb",
    "KernelProfiler": "profile", "cost_model": "profile", "profiler": "profile",
    "ProgressEstimator": "progress", "ProgressSnapshot": "progress",
    "RunLog": "runlog", "load_run": "runlog",
    "SLOPolicy": "slo", "SLOStatus": "slo", "SLOTracker": "slo",
    "WindowedCounter": "slo", "WindowedHistogram": "slo",
    "LossTerm": "speedup", "Waterfall": "speedup",
    "TRACER": "trace", "Tracer": "trace", "tracer": "trace",
}

__all__ = sorted(_EXPORTS)


def __getattr__(name):
    if name not in _EXPORTS:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    value = getattr(importlib.import_module(f"{__name__}.{_EXPORTS[name]}"), name)
    globals()[name] = value
    return value

"""Observability of the port: metrics registry, span tracing, run records,
the kernel profiler, the progress estimator, the serving tier's SLO windows
and the perf history.

Own copies of the JAX package's ``obs`` modules, with the same behaviour and
the same on-disk record, so the reference's ``launch/obs_report.py`` reads a
run of either package:

  * :mod:`repro_torch.obs.metrics`  — counters / gauges / histograms, one
    canonical snapshot shape;
  * :mod:`repro_torch.obs.trace`    — nested host spans, Chrome trace-event
    export, the CUDA ``sync`` helper, the ``torch_profiler`` hook;
  * :mod:`repro_torch.obs.runlog`   — per-run manifest + JSONL events +
    metrics snapshot;
  * :mod:`repro_torch.obs.session`  — the launchers' ``--trace`` /
    ``--metrics`` / ``--profile`` / ``--torch-profile`` glue (atexit and
    SIGTERM partial flush);
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
    estimator.
"""
from repro_torch.obs.machine import (  # noqa: F401
    CPU_HOST,
    H100_SXM,
    MachineModel,
    machine_for_device,
)
from repro_torch.obs.metrics import (  # noqa: F401
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    registry,
    snapshot,
)
from repro_torch.obs.perfdb import check_regressions, trends  # noqa: F401
from repro_torch.obs.profile import KernelProfiler, cost_model, profiler  # noqa: F401
from repro_torch.obs.progress import ProgressEstimator, ProgressSnapshot  # noqa: F401
from repro_torch.obs.runlog import RunLog, load_run  # noqa: F401
from repro_torch.obs.slo import (  # noqa: F401
    SLOPolicy,
    SLOStatus,
    SLOTracker,
    WindowedCounter,
    WindowedHistogram,
)
from repro_torch.obs.trace import TRACER, Tracer, tracer  # noqa: F401

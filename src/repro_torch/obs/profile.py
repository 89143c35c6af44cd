"""Kernel performance attribution: measured vs modeled time per family.

The port's copy of the JAX package's ``obs/profile.py``: the same families,
cost model, shape buckets, report and gauge scheme.  A
:class:`KernelProfiler` sits around every ``repro_torch.kernels.ops``
dispatch and accumulates per kernel family

  * **measured** time — the device time of each call, bucketed by
    power-of-two-rounded shape: on a CUDA tensor a pair of CUDA events on
    the current stream around the call, then a wait for the second; on the
    CPU the host clock;
  * **modeled** time — the word-op/byte cost model below priced against the
    :mod:`repro_torch.obs.machine` constants, giving per-family compute and
    memory terms, ``modeled = max(compute, memory)``, an achieved fraction
    ``modeled / measured``, and a memory- vs compute-bound verdict.

Every dispatch in the port is eager (the DFS loop is a host loop over
device tensors), so every execution, Phase 4's included, is a timed call
under ``calls``.  :meth:`KernelProfiler.observe_loop` (the reference's
attribution of kernels compiled into a ``while_loop``) is kept for the same
report shape, and ``trace_dispatches`` is always 0.

Cost models (word-ops; one op = one 32-bit AND / popcount / add)
----------------------------------------------------------------
``W``/``IW`` = 32-bit words per bitmap row.

  bitmap  (I, W)        flops 3·I·W            bytes 4·(I·W + W + I)
  multi   (K, I, W)     flops 3·K·I·W          bytes 4·(I·W + K·W + K·I)
  pair    (I, W)        flops 3·I²·W           bytes 4·(I·W + W + I²)
  subset  (Q, F, IW)    flops 8·Q·F·IW         bytes 4·((Q+F)·IW + 2·Q·F)
  delta   (S, T, F, IW) flops 4·S·T·F·IW       bytes 4·(S·T·IW + F·IW + S·F)

The constants are the reference algorithm's operations per word, not the
instructions a kernel issues: the *same* model prices every family, so the
verdicts and the cross-family ranking are consistent.  ``chip_smoke.py``'s
``bound_ms`` counts the instructions instead.

Disabled path: one attribute check in the ops wrapper, no allocation, no
clock read.
"""
from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

import torch

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs.machine import MachineModel, machine_for_device

#: The five dispatch families of ``repro_torch.kernels.ops``.
FAMILIES = ("bitmap", "multi", "pair", "subset", "delta")

#: Canonical dimension order per family (bucket labels, report rows).
DIM_ORDER: Dict[str, Tuple[str, ...]] = {
    "bitmap": ("I", "W"),
    "multi": ("K", "I", "W"),
    "pair": ("I", "W"),
    "subset": ("Q", "F", "IW"),
    "delta": ("S", "T", "F", "IW"),
}


def cost_model(family: str, dims: Dict[str, int]) -> Tuple[float, float]:
    """(word_ops, bytes) one execution of ``family`` at ``dims`` performs."""
    d = dims
    if family == "bitmap":
        flops = 3.0 * d["I"] * d["W"]
        nbytes = 4.0 * (d["I"] * d["W"] + d["W"] + d["I"])
    elif family == "multi":
        flops = 3.0 * d["K"] * d["I"] * d["W"]
        nbytes = 4.0 * (d["I"] * d["W"] + d["K"] * d["W"] + d["K"] * d["I"])
    elif family == "pair":
        flops = 3.0 * d["I"] * d["I"] * d["W"]
        nbytes = 4.0 * (d["I"] * d["W"] + d["W"] + d["I"] * d["I"])
    elif family == "subset":
        flops = 8.0 * d["Q"] * d["F"] * d["IW"]
        nbytes = 4.0 * ((d["Q"] + d["F"]) * d["IW"] + 2.0 * d["Q"] * d["F"])
    elif family == "delta":
        flops = 4.0 * d["S"] * d["T"] * d["F"] * d["IW"]
        nbytes = 4.0 * (
            d["S"] * d["T"] * d["IW"] + d["F"] * d["IW"] + d["S"] * d["F"]
        )
    else:
        raise ValueError(f"unknown kernel family: {family!r}")
    return flops, nbytes


def _pow2(n: int) -> int:
    """Round up to a power of two (≥ 1) — the shape-bucket resolution."""
    n = int(n)
    if n <= 1:
        return 1
    return 1 << (n - 1).bit_length()


def _bucket_label(family: str, dims: Dict[str, int]) -> str:
    parts = ",".join(f"{k}={_pow2(dims[k])}" for k in DIM_ORDER[family])
    return f"{family}[{parts}]"


class _Bucket:
    """Accumulator for one (family, pow2-shape) bucket."""

    __slots__ = (
        "calls", "loop_execs", "wall_s", "loop_wall_s",
        "flops", "bytes", "min_s", "max_s",
    )

    def __init__(self):
        self.calls = 0          # individually timed dispatches
        self.loop_execs = 0     # executions attributed by observe_loop
        self.wall_s = 0.0       # summed device time of the calls
        self.loop_wall_s = 0.0  # wall time attributed by observe_loop
        self.flops = 0.0        # modeled word-ops across all executions
        self.bytes = 0.0        # modeled bytes across all executions
        self.min_s = float("inf")
        self.max_s = 0.0


def _family_row() -> dict:
    return {
        "calls": 0, "loop_execs": 0, "measured_ms": 0.0,
        "flops": 0.0, "bytes": 0.0,
        "compute_ms": 0.0, "memory_ms": 0.0, "modeled_ms": 0.0,
        "trace_dispatches": 0,
        "buckets": [],
    }


class KernelProfiler:
    """Per-(family, shape-bucket) timing + roofline cost attribution.

    Thread-safe.  All recording methods are no-ops while disabled; the
    ops-layer fast path additionally skips the method call entirely behind
    the :attr:`enabled` attribute check.  The machine is the one passed to
    :meth:`enable`, else the model of the device of the first timed call.
    """

    def __init__(self, machine: Optional[MachineModel] = None):
        self.enabled = False          # read directly by the ops wrapper
        self._named = machine         # the machine the caller fixed
        self._seen: Optional[MachineModel] = None  # the first call's device
        self._buckets: Dict[Tuple[str, str], _Bucket] = {}
        self._lock = threading.Lock()

    # -- lifecycle -----------------------------------------------------------
    def enable(self, machine: Optional[MachineModel] = None) -> None:
        if machine is not None:
            self._named = machine
        self.enabled = True

    def disable(self) -> None:
        self.enabled = False

    def clear(self) -> None:
        """Drop every bucket and the machine seen on the first call."""
        with self._lock:
            self._buckets.clear()
            self._seen = None

    @property
    def machine(self) -> MachineModel:
        """The model the report prices against: the one named, else the
        first call's device's, else (nothing was timed) the device PyTorch
        would run on, the card where there is one."""
        if self._named is not None:
            return self._named
        if self._seen is not None:
            return self._seen
        return machine_for_device("cuda" if torch.cuda.is_available() else "cpu")

    # -- recording -----------------------------------------------------------
    def call(self, family: str, dims: Dict[str, int], thunk: Callable,
             device: torch.device):
        """Run ``thunk``, a dispatch on ``device``, and record its time."""
        if not self.enabled:
            return thunk()
        if self._named is None and self._seen is None:
            self._seen = machine_for_device(device)
        if device.type == "cuda":
            with torch.cuda.device(device):
                start = torch.cuda.Event(enable_timing=True)
                stop = torch.cuda.Event(enable_timing=True)
                start.record()
                out = thunk()
                stop.record()
                stop.synchronize()
            wall_s = start.elapsed_time(stop) / 1e3
        else:
            t0 = time.perf_counter()
            out = thunk()
            wall_s = time.perf_counter() - t0
        self.record_call(family, dims, wall_s)
        return out

    def record_call(self, family: str, dims: Dict[str, int], wall_s: float) -> None:
        """Account one timed execution of ``family`` at ``dims``."""
        if not self.enabled:
            return
        flops, nbytes = cost_model(family, dims)
        label = _bucket_label(family, dims)
        with self._lock:
            b = self._buckets.setdefault((family, label), _Bucket())
            b.calls += 1
            b.wall_s += wall_s
            b.flops += flops
            b.bytes += nbytes
            b.min_s = min(b.min_s, wall_s)
            b.max_s = max(b.max_s, wall_s)
        obs_metrics.registry().histogram(
            f"kernels/{family}/call_us/{label}"
        ).record(wall_s * 1e6)

    def observe_loop(
        self, family: str, dims: Dict[str, int], n_exec: int, wall_s: float
    ) -> None:
        """Attribute ``n_exec`` executions covered by ``wall_s`` (the
        reference's path for kernels inside a compiled loop)."""
        if not self.enabled or n_exec <= 0:
            return
        flops, nbytes = cost_model(family, dims)
        label = _bucket_label(family, dims)
        with self._lock:
            b = self._buckets.setdefault((family, label), _Bucket())
            b.loop_execs += int(n_exec)
            b.loop_wall_s += float(wall_s)
            b.flops += flops * n_exec
            b.bytes += nbytes * n_exec

    # -- reporting -----------------------------------------------------------
    def report(self) -> dict:
        """Measured-vs-modeled attribution, per family and per bucket."""
        m = self.machine
        with self._lock:
            items = list(self._buckets.items())
        families: Dict[str, dict] = {}
        for (family, label), b in sorted(items):
            compute_s = b.flops / m.word_ops_peak
            memory_s = b.bytes / m.hbm_bw
            modeled_s = max(compute_s, memory_s)
            measured_s = b.wall_s + b.loop_wall_s
            fam = families.setdefault(family, _family_row())
            fam["calls"] += b.calls
            fam["loop_execs"] += b.loop_execs
            fam["measured_ms"] += measured_s * 1e3
            fam["flops"] += b.flops
            fam["bytes"] += b.bytes
            fam["compute_ms"] += compute_s * 1e3
            fam["memory_ms"] += memory_s * 1e3
            fam["modeled_ms"] += modeled_s * 1e3
            fam["buckets"].append(
                {
                    "bucket": label,
                    "calls": b.calls,
                    "loop_execs": b.loop_execs,
                    "measured_ms": measured_s * 1e3,
                    "modeled_ms": modeled_s * 1e3,
                    "compute_ms": compute_s * 1e3,
                    "memory_ms": memory_s * 1e3,
                    "min_us": (b.min_s * 1e6) if b.calls else None,
                    "max_us": (b.max_s * 1e6) if b.calls else None,
                }
            )
        for fam in families.values():
            measured = fam["measured_ms"]
            fam["achieved_frac"] = (
                fam["modeled_ms"] / measured if measured > 0 else None
            )
            fam["mem_bound"] = fam["memory_ms"] > fam["compute_ms"]
        return {
            "machine": {
                "name": m.name,
                "peak_flops": m.peak_flops,
                "hbm_bw": m.hbm_bw,
                "link_bw": m.link_bw,
                "word_ops_peak": m.word_ops_peak,
            },
            "families": families,
        }

    def publish(self, reg: Optional[obs_metrics.MetricsRegistry] = None) -> dict:
        """Export the report as counters/gauges so it rides the run record.

        Gauge scheme (the reference's, read by its ``obs_report kernels``)::

            kernels/machine/{word_ops_peak, hbm_bw, peak_flops, link_bw}
            kernels/<family>/{measured_ms, modeled_ms, compute_ms,
                              memory_ms, flops, bytes, achieved_frac,
                              mem_bound}
            kernels/<family>/{calls, loop_execs}          (counters)
        """
        reg = reg or obs_metrics.registry()
        rep = self.report()
        for k, v in rep["machine"].items():
            if k != "name":
                reg.gauge(f"kernels/machine/{k}").set(float(v))
        for family, fam in rep["families"].items():
            reg.counter(f"kernels/{family}/calls").inc(fam["calls"])
            reg.counter(f"kernels/{family}/loop_execs").inc(fam["loop_execs"])
            for k in (
                "measured_ms", "modeled_ms", "compute_ms", "memory_ms",
                "flops", "bytes",
            ):
                reg.gauge(f"kernels/{family}/{k}").set(float(fam[k]))
            if fam["achieved_frac"] is not None:
                reg.gauge(f"kernels/{family}/achieved_frac").set(
                    float(fam["achieved_frac"])
                )
            reg.gauge(f"kernels/{family}/mem_bound").set(
                1.0 if fam["mem_bound"] else 0.0
            )
        return rep


#: The process-global profiler the ops layer checks on every dispatch.
PROFILER = KernelProfiler()


def profiler() -> KernelProfiler:
    return PROFILER

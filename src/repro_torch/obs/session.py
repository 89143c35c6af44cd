"""Shared ``--trace`` / ``--metrics`` / ``--profile`` flags for launchers.

The port's copy of the JAX package's ``obs/session.py``.  A launcher opts
into the run-record contract through two calls::

    add_obs_flags(ap)                  # --trace/--metrics/--profile/--torch-profile
    obs = start_session(args, "mine")  # None unless a flag was given
    ...
    if obs: obs.event("mined", ...)    # launcher timeline events
    ...
    if obs: obs.finish(n_fis=...)      # seal the run record

``--metrics DIR`` records the run (manifest + events + metrics snapshot);
``--trace DIR`` also enables the span tracer and writes the Perfetto-loadable
``trace.json``.  Both may name the same directory; the record layout is
:mod:`repro_torch.obs.runlog`'s.  ``--profile`` enables the kernel profiler
and publishes its attribution into the record.  ``--torch-profile DIR``
captures a ``torch.profiler`` trace of the run (the counterpart of the
reference's ``--jax-profile``).  ``--doctor`` diagnoses the sealed record at
exit and prints the report (:mod:`repro_torch.obs.doctor`); it implies
tracing, and without ``--trace`` / ``--metrics`` it records to a temporary
directory.
"""
from __future__ import annotations

import argparse
import atexit
import os
import signal
import tempfile
import threading
from typing import Optional

from repro_torch.obs import metrics as obs_metrics
from repro_torch.obs import profile as obs_profile
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.runlog import RunLog


def add_obs_flags(ap: argparse.ArgumentParser) -> None:
    g = ap.add_argument_group("observability")
    g.add_argument("--trace", default="", metavar="DIR",
                   help="record this run (manifest/events/metrics) to DIR "
                        "with span tracing on; DIR/trace.json loads in "
                        "Perfetto / chrome://tracing")
    g.add_argument("--metrics", default="", metavar="DIR",
                   help="record this run's manifest/events/metrics snapshot "
                        "to DIR (no tracer overhead)")
    g.add_argument("--torch-profile", default="", metavar="DIR",
                   dest="torch_profile",
                   help="also capture a torch.profiler trace (CPU and CUDA "
                        "activities) to DIR/torch_trace.json")
    g.add_argument("--profile", action="store_true",
                   help="enable the kernel profiler: per-family measured-vs-"
                        "modeled attribution published into the run record "
                        "(needs --trace or --metrics)")
    g.add_argument("--doctor", action="store_true",
                   help="diagnose this run at exit: critical path, speedup "
                        "waterfall, and the doctor's ranked findings "
                        "(records to a temp dir unless --trace/--metrics "
                        "names one; implies span tracing)")


class ObsSession:
    """A run record plus the tracer/profiler lifetime bound to it.

    Crash-safe: construction registers an ``atexit`` hook and (when on the
    main thread) a chaining ``SIGTERM`` handler, both of which flush the
    partial record — manifest (flagged ``partial``), metrics snapshot,
    trace — so a killed run still leaves a loadable, Perfetto-openable
    record next to the already-durable ``events.jsonl``.  A normal
    :meth:`finish` unregisters both and seals the record.
    """

    def __init__(self, run_dir: str, name: str, config: dict,
                 trace_on: bool, torch_profile: str = "",
                 profile_on: bool = False, device=None, doctor_on: bool = False):
        self._doctor_on = doctor_on
        # a fresh registry state so the record contains exactly this run
        obs_metrics.reset()
        self.tracer = obs_trace.tracer()
        if trace_on:
            self.tracer.clear()
            self.tracer.enable()
        self.profiler = obs_profile.profiler()
        self._profile_on = profile_on
        if profile_on:
            self.profiler.clear()
            self.profiler.enable()
        self.log = RunLog(run_dir, name, config, device=device)
        self._torch_profiler = (
            obs_trace.torch_profiler(torch_profile) if torch_profile else None
        )
        if self._torch_profiler is not None:
            self._torch_profiler.__enter__()
        self._finished = False
        atexit.register(self._atexit_flush)
        self._prev_sigterm = None
        self._sigterm_installed = False
        if threading.current_thread() is threading.main_thread():
            try:
                self._prev_sigterm = signal.signal(
                    signal.SIGTERM, self._on_sigterm)
                self._sigterm_installed = True
            except (ValueError, OSError):   # no signals on this platform
                pass

    @property
    def run_dir(self) -> str:
        return self.log.run_dir

    def event(self, kind: str, **fields) -> None:
        self.log.event(kind, **fields)

    # -- crash path -----------------------------------------------------------
    def _publish_profile(self) -> None:
        if self._profile_on:
            self.profiler.publish(obs_metrics.registry())
            self._profile_on = False          # publish is cumulative: once

    def _flush_partial(self, reason: str) -> None:
        if self._finished:
            return
        self._publish_profile()
        self.log.flush_partial(
            metrics_snapshot=obs_metrics.snapshot(),
            tracer=self.tracer,
            reason=reason,
        )

    def _atexit_flush(self) -> None:
        self._flush_partial("atexit")

    def _on_sigterm(self, signum, frame) -> None:
        self._flush_partial("sigterm")
        self._finished = True
        prev = self._prev_sigterm
        if callable(prev):
            prev(signum, frame)
        # die with the conventional 128+SIGTERM status via the default
        # disposition (atexit hooks have nothing left to do)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
        signal.raise_signal(signal.SIGTERM)

    def _uninstall(self) -> None:
        atexit.unregister(self._atexit_flush)
        if self._sigterm_installed:
            try:
                signal.signal(
                    signal.SIGTERM, self._prev_sigterm or signal.SIG_DFL)
            except (ValueError, OSError):
                pass
            self._sigterm_installed = False

    def finish(self, **summary) -> str:
        if self._torch_profiler is not None:
            self._torch_profiler.__exit__(None, None, None)
            self._torch_profiler = None
        self._publish_profile()
        if self.profiler.enabled:
            self.profiler.disable()
        self.log.finish(
            metrics_snapshot=obs_metrics.snapshot(),
            tracer=self.tracer,
            **summary,
        )
        self._finished = True
        self._uninstall()
        if self.tracer.enabled:
            self.tracer.disable()
        print(f"obs: run record written to {self.run_dir}"
              + (" (trace.json loads in Perfetto)" if "trace.json" in
                 os.listdir(self.run_dir) else ""))
        if self._doctor_on:
            self._print_diagnosis()
        return self.run_dir

    def _print_diagnosis(self) -> None:
        """The ``--doctor`` exit hook: diagnose the sealed record, print."""
        from repro_torch.obs import doctor as obs_doctor
        from repro_torch.obs import perfdb
        from repro_torch.obs.runlog import load_run

        rows = None
        if os.path.exists(perfdb.DEFAULT_PATH):
            rows, _ = perfdb.load(perfdb.DEFAULT_PATH)
        report = obs_doctor.diagnose(load_run(self.run_dir), history_rows=rows)
        print(obs_doctor.render_text(report))


def start_session(args, name: str,
                  config: Optional[dict] = None) -> Optional[ObsSession]:
    """Build the session the launcher's flags ask for (None when neither
    ``--trace`` nor ``--metrics`` names a directory and ``--doctor`` is off)."""
    run_dir = getattr(args, "trace", "") or getattr(args, "metrics", "")
    doctor_on = bool(getattr(args, "doctor", False))
    if not run_dir:
        if not doctor_on:
            return None
        # --doctor alone still needs a record to diagnose: a temporary one
        run_dir = tempfile.mkdtemp(prefix=f"doctor-{name}-")
    return ObsSession(
        run_dir,
        name,
        config if config is not None else dict(vars(args)),
        # the doctor's critical path needs spans, so --doctor implies tracing
        trace_on=bool(getattr(args, "trace", "")) or doctor_on,
        torch_profile=getattr(args, "torch_profile", ""),
        profile_on=bool(getattr(args, "profile", False)),
        device=getattr(args, "device", None),
        doctor_on=doctor_on,
    )

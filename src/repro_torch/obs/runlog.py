"""Run records: a manifest + JSONL event log + metrics/trace files per run.

The port's copy of the JAX package's ``obs/runlog.py``, with the same
on-disk format, so the reference's ``launch/obs_report.py`` reads a record
of either package.  Every observed run lands in one directory::

    run_dir/
      manifest.json   # what ran: name, config, git SHA, backend, devices,
                      # start time; finish() adds wall_s and any summary
      events.jsonl    # append-only timeline of launcher events (one JSON
                      # object per line: {"t": rel_seconds, "kind": ..., ...})
      metrics.json    # the registry's canonical snapshot at finish()
      trace.json      # Chrome trace-event JSON (only when tracing was on)
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
from typing import Optional

MANIFEST = "manifest.json"
EVENTS = "events.jsonl"
METRICS = "metrics.json"
TRACE = "trace.json"


def git_sha(cwd: Optional[str] = None) -> Optional[str]:
    """Best-effort HEAD SHA of the surrounding checkout (None outside git)."""
    try:
        out = subprocess.run(
            ["git", "rev-parse", "HEAD"],
            capture_output=True, text=True, timeout=5,
            cwd=cwd or os.path.dirname(os.path.abspath(__file__)),
        )
        return out.stdout.strip() if out.returncode == 0 else None
    except Exception:
        return None


def _backend_info(device=None) -> dict:
    """Backend and device identity of the run: ``cuda`` with the card's name
    and the device count, or ``cpu``.  ``device`` is the run's device (the
    card unless the launcher was told ``--device cpu``); an unusable CUDA
    must never break run recording."""
    try:
        import torch

        dev = torch.device(device if device is not None else
                           ("cuda" if torch.cuda.is_available() else "cpu"))
        if dev.type == "cuda":
            return {
                "backend": "cuda",
                "device_kind": torch.cuda.get_device_name(dev),
                "n_devices": torch.cuda.device_count(),
            }
        return {"backend": "cpu", "device_kind": "cpu", "n_devices": 1}
    except Exception:
        return {"backend": None, "device_kind": None, "n_devices": 0}


class RunLog:
    """One run's record: manifest at start, events during, metrics at end."""

    def __init__(self, run_dir: str, name: str, config: Optional[dict] = None,
                 device=None):
        self.run_dir = run_dir
        os.makedirs(run_dir, exist_ok=True)
        self._t0 = time.monotonic()
        self._lock = threading.Lock()
        self.manifest = {
            "name": name,
            "config": _jsonable(config or {}),
            "argv": sys.argv,
            "git_sha": git_sha(),
            "started_unix": time.time(),
            **_backend_info(device),
        }
        self._write_manifest()
        self._events = open(os.path.join(run_dir, EVENTS), "a")

    def _write_manifest(self) -> None:
        path = os.path.join(self.run_dir, MANIFEST)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.manifest, f, indent=2)
        os.replace(tmp, path)

    def event(self, kind: str, **fields) -> None:
        """Append one timeline event (relative seconds since run start)."""
        rec = {"t": round(time.monotonic() - self._t0, 6), "kind": kind,
               **_jsonable(fields)}
        with self._lock:
            self._events.write(json.dumps(rec) + "\n")
            self._events.flush()

    def flush_partial(
        self,
        metrics_snapshot: Optional[dict] = None,
        tracer=None,
        reason: str = "partial",
    ) -> None:
        """Write everything recorded SO FAR without sealing the record.

        The crash path (:class:`~repro_torch.obs.session.ObsSession`'s atexit /
        SIGTERM hooks): a killed run still leaves a loadable
        ``manifest.json`` (flagged ``partial`` with the reason),
        ``metrics.json`` and ``trace.json`` next to the already-durable
        ``events.jsonl``.  Idempotent; a later :meth:`finish` overwrites
        the partial flag with the sealed summary.
        """
        self.manifest["wall_s"] = time.monotonic() - self._t0
        self.manifest["partial"] = True
        self.manifest["partial_reason"] = reason
        self._write_manifest()
        if metrics_snapshot is not None:
            with open(os.path.join(self.run_dir, METRICS), "w") as f:
                json.dump(metrics_snapshot, f, indent=2)
        if tracer is not None and tracer.enabled:
            tracer.write(os.path.join(self.run_dir, TRACE))
        with self._lock:
            if not self._events.closed:
                self._events.flush()

    def finish(
        self,
        metrics_snapshot: Optional[dict] = None,
        tracer=None,
        **summary,
    ) -> None:
        """Seal the record: wall time + summary into the manifest, the
        metrics snapshot to ``metrics.json``, the trace (if any) to
        ``trace.json``."""
        self.manifest["wall_s"] = time.monotonic() - self._t0
        self.manifest.pop("partial", None)
        self.manifest.pop("partial_reason", None)
        self.manifest.update(_jsonable(summary))
        self._write_manifest()
        if metrics_snapshot is not None:
            with open(os.path.join(self.run_dir, METRICS), "w") as f:
                json.dump(metrics_snapshot, f, indent=2)
        if tracer is not None and tracer.enabled:
            tracer.write(os.path.join(self.run_dir, TRACE))
        with self._lock:
            self._events.close()


def _jsonable(obj):
    """Best-effort plain-JSON projection (numpy scalars/arrays, tuples…)."""
    if isinstance(obj, dict):
        return {str(k): _jsonable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_jsonable(v) for v in obj]
    if isinstance(obj, (str, int, float, bool)) or obj is None:
        return obj
    if hasattr(obj, "item") and not hasattr(obj, "__len__"):  # numpy scalar
        return obj.item()
    if hasattr(obj, "tolist"):                                # numpy array
        return obj.tolist()
    return repr(obj)


def load_run(run_dir: str) -> dict:
    """Read a run record back: manifest, metrics, events, trace (if present).

    Raises ``FileNotFoundError`` when ``manifest.json`` is missing — the
    defining file of a run record.
    """
    with open(os.path.join(run_dir, MANIFEST)) as f:
        out = {"run_dir": run_dir, "manifest": json.load(f)}
    mpath = os.path.join(run_dir, METRICS)
    out["metrics"] = None
    if os.path.exists(mpath):
        with open(mpath) as f:
            out["metrics"] = json.load(f)
    out["events"] = []
    epath = os.path.join(run_dir, EVENTS)
    if os.path.exists(epath):
        with open(epath) as f:
            out["events"] = [json.loads(ln) for ln in f if ln.strip()]
    tpath = os.path.join(run_dir, TRACE)
    out["trace"] = None
    if os.path.exists(tpath):
        with open(tpath) as f:
            out["trace"] = json.load(f)
    return out

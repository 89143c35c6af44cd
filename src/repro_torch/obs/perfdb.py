"""Persistent perf trajectory: stamped benchmark snapshots in a JSONL file.

The port's own copy of the JAX package's ``obs/perfdb.py``, with the same
behaviour and the same row format, so each package's :func:`load` reads the
other's file.  Its default file is the port's own,
``BENCH_torch_HISTORY.jsonl``: the port never appends to the JAX package's
``BENCH_HISTORY.jsonl``.  One JSON object per line::

    {"ts": "2026-08-08T12:00:00Z", "sha": "a03672c", "backend": "cuda",
     "suite": "serve_load", "keys": {"slo_p99_ms": 3.1, ...}}

Writer: the gated ``launch/serve_load.py`` run.  Readers: the reference's
``obs_report history`` and ``obs_report regress`` (pass the file's path).

Properties the gates rely on:

  * **Atomic append** — each row is a single ``os.write`` to an
    ``O_APPEND`` fd, so concurrent writers interleave whole lines and a
    crash can at worst truncate the final line;
  * **Corrupt-line tolerance** — :func:`load` skips unparsable lines (and
    reports how many), so one torn write never wedges the trend gates;
  * **Directionality by key name** — ``*_ms``/``*_s``/``*_us``/
    ``overhead``/``slowdown``/``stall``/``latency`` are lower-better,
    ``*_speedup``/``*_qps``/``*_improvement`` higher-better, anything
    else (counts, config echoes) is recorded but not gated.

Stdlib-only.
"""
from __future__ import annotations

import dataclasses
import json
import os
import time
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.obs.runlog import git_sha as _full_git_sha

#: Default ledger file of the port, in the working directory.
DEFAULT_PATH = "BENCH_torch_HISTORY.jsonl"

_LOWER_SUBSTR = ("overhead", "slowdown", "stall", "latency", "burn_rate",
                 "loss")
_LOWER_SUFFIX = ("_ms", "_s", "_us", "_bytes")
_HIGHER_SUBSTR = ("speedup", "improvement")
_HIGHER_SUFFIX = ("_qps", "_frac")


def direction(key: str) -> Optional[str]:
    """'lower' / 'higher' when the key has a better direction, else None."""
    k = key.lower()
    if any(s in k for s in _HIGHER_SUBSTR) or k.endswith(_HIGHER_SUFFIX):
        return "higher"
    if any(s in k for s in _LOWER_SUBSTR) or k.endswith(_LOWER_SUFFIX):
        return "lower"
    return None


def git_sha(cwd: Optional[str] = None) -> str:
    """Short git SHA of the surrounding checkout ('' outside git)."""
    return (_full_git_sha(cwd) or "")[:9]


def utc_stamp(t: Optional[float] = None) -> str:
    return time.strftime(
        "%Y-%m-%dT%H:%M:%SZ", time.gmtime(time.time() if t is None else t)
    )


def append(
    path: str,
    suite: str,
    keys: Dict[str, float],
    *,
    sha: Optional[str] = None,
    backend: str = "",
    ts: Optional[str] = None,
) -> dict:
    """Atomically append one stamped snapshot row; returns the row."""
    row = {
        "ts": ts if ts is not None else utc_stamp(),
        "sha": sha if sha is not None else git_sha(),
        "backend": backend,
        "suite": suite,
        "keys": {
            k: float(v) for k, v in keys.items()
            if isinstance(v, (int, float)) and not isinstance(v, bool)
        },
    }
    data = (json.dumps(row, sort_keys=True) + "\n").encode()
    fd = os.open(path, os.O_WRONLY | os.O_CREAT | os.O_APPEND, 0o644)
    try:
        os.write(fd, data)
    finally:
        os.close(fd)
    return row


def load(path: str) -> Tuple[List[dict], int]:
    """All well-formed rows in file order, plus the corrupt-line count."""
    rows: List[dict] = []
    corrupt = 0
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            try:
                row = json.loads(line)
            except json.JSONDecodeError:
                corrupt += 1
                continue
            if not isinstance(row, dict) or "suite" not in row \
                    or not isinstance(row.get("keys"), dict):
                corrupt += 1
                continue
            rows.append(row)
    return rows, corrupt


def trends(
    rows: Iterable[dict],
    *,
    suite: Optional[str] = None,
    key_match: Optional[str] = None,
) -> Dict[Tuple[str, str], List[dict]]:
    """{(suite, key): [{ts, sha, value}, ...]} in file (=time) order."""
    out: Dict[Tuple[str, str], List[dict]] = {}
    for row in rows:
        s = str(row.get("suite", ""))
        if suite and s != suite:
            continue
        for k, v in row.get("keys", {}).items():
            if key_match and key_match not in k:
                continue
            if not isinstance(v, (int, float)) or isinstance(v, bool):
                continue
            out.setdefault((s, k), []).append(
                {"ts": row.get("ts", ""), "sha": row.get("sha", ""),
                 "value": float(v)}
            )
    return out


def _median(vals: List[float]) -> float:
    s = sorted(vals)
    n = len(s)
    return s[n // 2] if n % 2 else 0.5 * (s[n // 2 - 1] + s[n // 2])


@dataclasses.dataclass
class Regression:
    """One gated key whose newest value degraded past the threshold."""

    suite: str
    key: str
    direction: str          # "lower" | "higher" (better)
    latest: float
    median: float           # trailing median the latest is judged against
    ratio: float            # latest/median (lower-better) or inverse
    n_history: int

    def line(self) -> str:
        arrow = "↑" if self.direction == "lower" else "↓"
        return (
            f"{self.suite}/{self.key}: {self.latest:.4g} vs trailing "
            f"median {self.median:.4g} ({self.ratio:.2f}x {arrow} worse, "
            f"n={self.n_history})"
        )


def check_regressions(
    rows: List[dict],
    *,
    threshold: float = 0.25,
    window: int = 8,
    min_history: int = 2,
    degrade: float = 1.0,
    direction_overrides: Optional[Dict[str, str]] = None,
) -> Tuple[List[Regression], int]:
    """Judge each directional key's newest value against its own history.

    The newest value regresses when it is worse than the trailing median
    of the previous ``min(window, available)`` values by more than
    ``threshold`` (relative).  Keys need ``min_history`` prior values
    before they gate — a brand-new metric can't regress.  ``degrade``
    synthetically worsens every newest value by that factor first: the
    deterministic failing partner ``tools/check.sh`` uses to prove the
    gate can fire.  ``direction_overrides`` ({key: "lower"|"higher"})
    wins over the name-inferred direction — the escape hatch for keys the
    naming convention misreads (and a way to gate an otherwise-untracked
    key).  Returns (regressions, n_keys_gated).
    """
    checked = 0
    found: List[Regression] = []
    overrides = direction_overrides or {}
    for (suite, key), series in sorted(trends(rows).items()):
        d = overrides.get(key) or direction(key)
        if d is None or len(series) < min_history + 1:
            continue
        prior = [p["value"] for p in series[:-1]][-window:]
        med = _median(prior)
        latest = series[-1]["value"]
        if degrade != 1.0:
            latest = latest * degrade if d == "lower" else latest / degrade
        if med <= 0:
            continue
        checked += 1
        ratio = latest / med if d == "lower" else med / max(latest, 1e-12)
        if ratio > 1.0 + threshold:
            found.append(Regression(
                suite=suite, key=key, direction=d, latest=latest,
                median=med, ratio=ratio, n_history=len(prior),
            ))
    return found, checked


def bench_result_keys(bench: dict) -> Dict[str, float]:
    """The numeric result scalars of one ``BENCH_*.json`` payload.

    Mirrors the summary table's config/result split: config echoes and
    structured fields are dropped; per-entry kernel timings are folded in
    as ``<entry-name>_us`` so the kernel suite contributes gateable
    series too.
    """
    config_keys = {"bench", "backend", "db", "fast", "reps", "block_tx",
                   "n_blocks", "P", "window_blocks", "support", "meta"}
    out: Dict[str, float] = {}
    for k, v in bench.items():
        if k in config_keys or isinstance(v, bool):
            continue
        if isinstance(v, (int, float)):
            out[k] = float(v)
    for e in bench.get("entries") or []:
        name, us = e.get("name"), e.get("us")
        if isinstance(name, str) and isinstance(us, (int, float)):
            out[f"{name}_us"] = float(us)
    return out

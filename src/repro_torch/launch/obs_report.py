"""Run-record report CLI: summarize, diff, and gate on observability output.

The port's copy of the JAX package's ``launch/obs_report.py``: the same
subcommands, output and exit codes.  It reads the run records
:mod:`repro_torch.obs.runlog` writes (``--trace`` / ``--metrics`` on any of
the port's launchers; the format is the reference's, so a record of either
package reads the same), the port's ``BENCH_torch_*.json`` payloads and its
perf history ``BENCH_torch_HISTORY.jsonl``.  Stdlib-only, and it touches no
device: it is the one entry point of the port without ``--device``, and
loads anywhere the JSON does.

Subcommands::

  summary RUN_DIR [--format text|json|markdown]
      Digest one run: manifest identity, driver event timeline, the metric
      families, span time by name.  ``--format json`` emits the full digest
      as machine-readable JSON; ``--format markdown`` renders tables for CI
      step summaries.

  diff OLD_RUN NEW_RUN [--threshold 0.2]
      Compare two runs' time-like metrics (wall_s, */phase_ms/*, *_ms/*_s
      gauges, latency-histogram p95s).  Prints old → new with the ratio and
      **exits 1** when any time-like metric regressed by more than the
      threshold (0.2 = +20%).  Counters/gauges that are not time-like are
      shown for context but never gate.

  baseline --bench BENCH.json [...] [--threshold 0.05] [RUN_DIR]
      Gate on benchmark baselines: every ratio-type key in each BENCH file
      (``*_overhead*``, ``*_slowdown*`` — measured-vs-baseline ratios where
      1.0 = parity) must stay <= 1 + threshold; ``--match SUBSTR`` narrows
      the gated keys (e.g. ``--match overhead`` for the parity-type gates
      only).  With a RUN_DIR, metrics sharing a flattened name with a bench
      key are also compared under the same threshold.  Exits 1 on any
      regression.

  inject-slowdown SRC_RUN DST_RUN --factor 1.3 [--match SUBSTR]
      Copy a run record with every time-like quantity scaled by ``factor``
      (wall_s, *_ms/*_s gauges and histograms, trace durations); ``--match``
      narrows the scaling to names containing a substring.  The
      deterministic partner for testing the diff gate: ``diff SRC DST``
      must fail and ``diff SRC SRC`` must pass, with no timing flakiness.
      (``--match compute_ms`` is the kernels --check-model failing partner.)

  kernels RUN_DIR [--require bitmap,multi,...] [--check-model]
      Render the kernel profiler's attribution (``--profile`` runs):
      measured vs modeled time, achieved roofline fraction, and the
      memory-/compute-bound verdict per family.  ``--require`` exits 1
      unless every named family has attribution; ``--check-model``
      recomputes each roofline term from the published flop/byte/machine
      gauges and exits 1 on mismatch.

  history [--history BENCH_torch_HISTORY.jsonl] [--suite S] [--key SUBSTR]
          [--format text|markdown]
      Render per-key trends from the perf ledger (newest last, with the
      git SHA each row was stamped with).

  regress [--history BENCH_torch_HISTORY.jsonl] [--threshold 0.25] [--window 8]
          [--direction KEY=up|down ...] [--format text|markdown]
      Gate the newest ledger row: exit 1 when any directional key degraded
      past the threshold vs its trailing median (``repro_torch.obs.perfdb``).
      ``--degrade F`` synthetically worsens the newest values first — the
      deterministic proof that the gate can fire.
      ``--direction`` overrides the name-inferred better-direction per key.

  critpath RUN_DIR [--top N] [--path] [--format text|json]
      Reconstruct the span DAG of a traced run and print the critical-path
      table: on-path exclusive self-time by span name, straggler lanes and
      all (``repro_torch.obs.critpath``).

  doctor RUN_DIR [--history LEDGER] [--format text|json|markdown] [--gate]
      The performance doctor: critical path + speedup-loss waterfall +
      ranked findings with evidence keys and remediation hints
      (``repro_torch.obs.doctor``).  ``--gate`` exits 1 when any severity>=error
      finding fires — the CI hook.

Exit codes: 0 ok, 1 regression detected, 2 usage / unreadable record.
"""
from __future__ import annotations

import argparse
import copy
import json
import os
import sys
from typing import Dict, Iterable, List, Optional, Tuple

from repro_torch.obs import critpath, doctor, perfdb, runlog

#: gauge/summary names treated as durations (the regression-gated set)
_TIME_SUFFIXES = ("_ms", "_s", "wall_s")


def _is_time_like(name: str) -> bool:
    short = name.rsplit("/", 1)[-1]
    return (
        short.endswith(_TIME_SUFFIXES)
        or "/phase_ms/" in name
        or "stall" in short
        or "latency" in short
    )


def _time_metrics(run: dict) -> Dict[str, float]:
    """Flatten one run's time-like scalars: summary + gauges + hist p95s."""
    out: Dict[str, float] = {}
    man = run.get("manifest") or {}
    for k, v in man.items():
        if isinstance(v, (int, float)) and _is_time_like(str(k)):
            out[str(k)] = float(v)
    m = run.get("metrics") or {}
    for name, v in (m.get("gauges") or {}).items():
        if isinstance(v, (int, float)) and _is_time_like(name):
            out[name] = float(v)
    for name, summ in (m.get("histograms") or {}).items():
        if _is_time_like(name) and isinstance(summ, dict):
            p95 = summ.get("p95")
            if isinstance(p95, (int, float)):
                out[f"{name}:p95"] = float(p95)
    return out


def _load(run_dir: str) -> dict:
    try:
        return runlog.load_run(run_dir)
    except (FileNotFoundError, json.JSONDecodeError) as e:
        print(f"obs_report: cannot read run record at {run_dir}: {e}",
              file=sys.stderr)
        sys.exit(2)


# ---------------------------------------------------------------------------
# summary
# ---------------------------------------------------------------------------


def _span_totals(trace: Optional[dict]) -> List[dict]:
    """Per-name span rows — inclusive total AND exclusive self-time.

    One implementation: :func:`repro_torch.obs.critpath.exclusive_totals` over
    the reconstructed span DAG, so long parents (``fimi/phase4_mine``)
    stop masking the children nested inside them.  Longest-self first.
    """
    dag = critpath.build(trace)
    if dag is None:
        return []
    rows = [
        {"name": name, "total_ms": r["total_ms"], "self_ms": r["self_ms"],
         "count": int(r["count"])}
        for name, r in critpath.exclusive_totals(dag).items()
    ]
    rows.sort(key=lambda r: (-r["self_ms"], -r["total_ms"]))
    return rows


def _summary_digest(run: dict) -> dict:
    """The summary's content as one plain dict (every format renders it)."""
    man = run["manifest"]
    extras = {
        k: v for k, v in man.items()
        if k not in ("name", "config", "argv", "git_sha", "started_unix",
                     "backend", "device_kind", "n_devices", "wall_s")
    }
    m = run["metrics"] or {}
    return {
        "name": man.get("name"),
        "run_dir": run["run_dir"],
        "git_sha": man.get("git_sha"),
        "backend": man.get("backend"),
        "n_devices": man.get("n_devices"),
        "device_kind": man.get("device_kind"),
        "wall_s": man.get("wall_s"),
        "summary": extras,
        "events": run["events"],
        "counters": m.get("counters") or {},
        "gauges": m.get("gauges") or {},
        "histograms": m.get("histograms") or {},
        "spans": _span_totals(run["trace"]),
    }


def _num(v) -> str:
    return f"{v:.4g}" if isinstance(v, (int, float)) else str(v)


def _render_markdown(d: dict, max_events: int, max_gauges: int) -> str:
    """A CI-step-summary-friendly digest (GitHub-flavored markdown)."""
    out = [f"### run `{d['name']}`",
           "",
           f"- dir: `{d['run_dir']}`  git: `{str(d['git_sha'])[:12]}`  "
           f"backend: {d['backend']} ×{d['n_devices']} ({d['device_kind']})",
           f"- wall_s: {_num(d['wall_s']) if d['wall_s'] is not None else '<unfinished>'}"]
    if d["summary"]:
        out.append("- " + "  ".join(f"{k}={_num(v)}"
                                    for k, v in d["summary"].items()))
    if d["events"]:
        out += ["", f"#### events ({len(d['events'])})", "",
                "| t (s) | kind | fields |", "|---|---|---|"]
        for ev in d["events"][:max_events]:
            rest = {k: v for k, v in ev.items() if k not in ("t", "kind")}
            out.append(f"| {ev['t']:.3f} | {ev['kind']} | "
                       + "  ".join(f"{k}={_num(v)}"
                                   for k, v in rest.items()) + " |")
    if d["counters"]:
        out += ["", "#### counters", "", "| name | value |", "|---|---|"]
        out += [f"| {k} | {v} |" for k, v in sorted(d["counters"].items())]
    if d["gauges"]:
        out += ["", "#### gauges", "", "| name | value |", "|---|---|"]
        out += [f"| {k} | {_num(v)} |"
                for k, v in sorted(d["gauges"].items())[:max_gauges]]
    if d["histograms"]:
        out += ["", "#### histograms", "",
                "| name | n | mean | p50 | p95 | p99 | max |",
                "|---|---|---|---|---|---|---|"]
        out += [
            f"| {k} | {s['count']} | {_num(s['mean'])} | {_num(s['p50'])} "
            f"| {_num(s['p95'])} | {_num(s['p99'])} | {_num(s['max'])} |"
            for k, s in sorted(d["histograms"].items())
        ]
    if d["spans"]:
        out += ["", "#### trace spans", "",
                "| span | total ms | self ms | count |", "|---|---|---|---|"]
        out += [f"| {s['name']} | {s['total_ms']:.2f} | {s['self_ms']:.2f} "
                f"| {s['count']} |"
                for s in d["spans"][:12]]
        out.append(f"\n(trace: `{d['run_dir']}/trace.json` — loads in "
                   f"[ui.perfetto.dev](https://ui.perfetto.dev))")
    return "\n".join(out)


def cmd_summary(args) -> int:
    run = _load(args.run)
    d = _summary_digest(run)
    if args.format == "json":
        print(json.dumps(d, indent=2))
        return 0
    if args.format == "markdown":
        print(_render_markdown(d, args.events, args.gauges))
        return 0
    print(f"run: {d['name']}  dir={d['run_dir']}")
    print(f"  git={str(d['git_sha'])[:12]}  "
          f"backend={d['backend']} x{d['n_devices']} "
          f"({d['device_kind']})")
    wall = d["wall_s"]
    print(f"  wall_s={wall:.3f}" if isinstance(wall, (int, float))
          else "  wall_s=<unfinished>")
    if d["summary"]:
        print("  summary: "
              + "  ".join(f"{k}={v}" for k, v in d["summary"].items()))
    if d["events"]:
        print(f"events ({len(d['events'])}):")
        for ev in d["events"][: args.events]:
            rest = {k: v for k, v in ev.items() if k not in ("t", "kind")}
            print(f"  t={ev['t']:>8.3f}s  {ev['kind']:<12} "
                  + " ".join(f"{k}={v}" for k, v in rest.items()))
        if len(d["events"]) > args.events:
            print(f"  ... {len(d['events']) - args.events} more")
    if d["counters"]:
        print("counters:")
        for k, v in sorted(d["counters"].items()):
            print(f"  {k} = {v}")
    if d["gauges"]:
        print(f"gauges: {len(d['gauges'])} "
              f"(use diff/baseline for comparisons)")
        for k, v in sorted(d["gauges"].items())[: args.gauges]:
            print(f"  {k} = {v:.6g}")
        if len(d["gauges"]) > args.gauges:
            print(f"  ... {len(d['gauges']) - args.gauges} more")
    if d["histograms"]:
        print("histograms:")
        for k, s in sorted(d["histograms"].items()):
            print(f"  {k}: n={s['count']} mean={s['mean']:.4g} "
                  f"p50={s['p50']:.4g} p95={s['p95']:.4g} max={s['max']:.4g}")
    if d["spans"]:
        print("trace spans (inclusive total / exclusive self ms):")
        for s in d["spans"][:12]:
            print(f"  {s['name']:<28} {s['total_ms']:>10.2f}ms  "
                  f"self {s['self_ms']:>10.2f}ms  x{s['count']}")
        print(f"  -> load {d['run_dir']}/trace.json in "
              f"https://ui.perfetto.dev or chrome://tracing")
    return 0


# ---------------------------------------------------------------------------
# diff
# ---------------------------------------------------------------------------


def cmd_diff(args) -> int:
    old, new = _load(args.old), _load(args.new)
    t_old, t_new = _time_metrics(old), _time_metrics(new)
    shared = sorted(set(t_old) & set(t_new))
    only_old = sorted(set(t_old) - set(t_new))
    only_new = sorted(set(t_new) - set(t_old))
    if not shared:
        print("obs_report diff: no shared time-like metrics "
              "(were both runs recorded with --metrics or --trace?)",
              file=sys.stderr)
        for name in only_old:
            print(f"  only in {args.old}: {name}", file=sys.stderr)
        for name in only_new:
            print(f"  only in {args.new}: {name}", file=sys.stderr)
        return 2
    regressions: List[str] = []
    print(f"diff {args.old} -> {args.new}  (threshold +{args.threshold:.0%})")
    for name in shared:
        a, b = t_old[name], t_new[name]
        if a <= args.min_seconds_ignore and b <= args.min_seconds_ignore:
            continue  # sub-noise-floor timings cannot gate
        ratio = b / a if a > 0 else float("inf")
        worse = b > a * (1.0 + args.threshold)
        flag = "  << REGRESSION" if worse else ""
        print(f"  {name:<36} {a:>12.4f} -> {b:>12.4f}  "
              f"x{ratio:.2f}{flag}")
        if worse:
            regressions.append(name)
    # non-time context: counter deltas worth a glance (never gate)
    c_old = (old.get("metrics") or {}).get("counters") or {}
    c_new = (new.get("metrics") or {}).get("counters") or {}
    changed = {
        k: (c_old[k], c_new[k])
        for k in set(c_old) & set(c_new) if c_old[k] != c_new[k]
    }
    if changed:
        print("counter deltas (context only):")
        for k, (a, b) in sorted(changed.items()):
            print(f"  {k:<36} {a} -> {b}")
    # metrics present on one side only: a run that silently stopped (or
    # started) recording a phase is itself a finding — never hide it
    if only_old or only_new:
        print(f"metrics in one run only ({len(only_old) + len(only_new)}, "
              f"not gated):")
        for name in only_old:
            print(f"  {name:<36} {t_old[name]:>12.4f} -> (missing in new)")
        for name in only_new:
            print(f"  {name:<36} (missing in old) -> {t_new[name]:>12.4f}")
    if regressions:
        print(f"REGRESSION: {len(regressions)} time-like metric(s) slowed "
              f"beyond +{args.threshold:.0%}: {', '.join(regressions)}")
        return 1
    print("ok: no time-like metric regressed beyond the threshold")
    return 0


# ---------------------------------------------------------------------------
# baseline
# ---------------------------------------------------------------------------


def _flatten(obj, prefix: str = "") -> Dict[str, float]:
    out: Dict[str, float] = {}
    if isinstance(obj, dict):
        for k, v in obj.items():
            out.update(_flatten(v, f"{prefix}{k}."))
    elif isinstance(obj, list):
        for i, v in enumerate(obj):
            name = v.get("name") if isinstance(v, dict) else None
            out.update(_flatten(v, f"{prefix}{name or i}."))
    elif isinstance(obj, (int, float)) and not isinstance(obj, bool):
        out[prefix[:-1]] = float(obj)
    return out


def _ratio_gates(flat: Dict[str, float],
                 match: Optional[List[str]] = None) -> Dict[str, float]:
    """Keys whose value is a measured/baseline ratio (1.0 = parity).

    ``match`` narrows the gated set to keys containing any substring — e.g.
    ``--match overhead`` gates the parity-type overheads at a tight
    threshold without dragging in looser-by-design slowdown factors.
    """
    gates = {
        k: v for k, v in flat.items()
        if "overhead" in k.rsplit(".", 1)[-1]
        or "slowdown" in k.rsplit(".", 1)[-1]
    }
    if match:
        gates = {k: v for k, v in gates.items()
                 if any(m in k for m in match)}
    return gates


def cmd_baseline(args) -> int:
    if not args.bench:
        print("obs_report baseline: need at least one --bench BENCH.json",
              file=sys.stderr)
        return 2
    failures: List[str] = []
    run_flat: Dict[str, float] = {}
    if args.run:
        run = _load(args.run)
        run_flat = _flatten(
            {"gauges": (run["metrics"] or {}).get("gauges") or {}}
        )
        run_flat = {k.split("gauges.", 1)[-1]: v for k, v in run_flat.items()}
    for path in args.bench:
        try:
            with open(path) as f:
                bench = json.load(f)
        except (OSError, json.JSONDecodeError) as e:
            print(f"obs_report baseline: cannot read {path}: {e}",
                  file=sys.stderr)
            return 2
        flat = _flatten(bench)
        gates = _ratio_gates(flat, args.match or None)
        label = os.path.basename(path)
        print(f"{label}: {len(gates)} ratio gate(s), "
              f"threshold <= {1 + args.threshold:.2f}x")
        for k, v in sorted(gates.items()):
            bad = v > 1.0 + args.threshold
            print(f"  {k:<44} {v:.4f}x"
                  + ("  << REGRESSION" if bad else ""))
            if bad:
                failures.append(f"{label}:{k}")
        # run metrics that share a flattened name with a bench scalar
        for k in sorted(set(flat) & set(run_flat)):
            a, b = flat[k], run_flat[k]
            if a <= 0:
                continue
            bad = b > a * (1.0 + args.threshold)
            print(f"  {k:<44} bench={a:.4g} run={b:.4g}"
                  + ("  << REGRESSION" if bad else ""))
            if bad:
                failures.append(f"{label}:{k}(run)")
    if failures:
        print(f"REGRESSION vs baseline: {', '.join(failures)}")
        return 1
    print("ok: all baseline gates hold")
    return 0


# ---------------------------------------------------------------------------
# inject-slowdown (deterministic diff-gate test partner)
# ---------------------------------------------------------------------------


def _scale_time(obj, factor: float, hit, name: str = ""):
    if isinstance(obj, dict):
        return {
            k: _scale_time(v, factor, hit, f"{name}/{k}" if name else str(k))
            for k, v in obj.items()
        }
    if isinstance(obj, (int, float)) and not isinstance(obj, bool):
        return obj * factor if hit(name) else obj
    return obj


def cmd_inject(args) -> int:
    src = _load(args.src)
    match = args.match or []

    def hit(name: str) -> bool:
        if not _is_time_like(name):
            return False
        return not match or any(m in name for m in match)

    os.makedirs(args.dst, exist_ok=True)
    man = _scale_time(copy.deepcopy(src["manifest"]), args.factor, hit)
    with open(os.path.join(args.dst, runlog.MANIFEST), "w") as f:
        json.dump(man, f, indent=2)
    if src["metrics"] is not None:
        m = copy.deepcopy(src["metrics"])
        m["gauges"] = {
            k: (v * args.factor if hit(k) else v)
            for k, v in (m.get("gauges") or {}).items()
        }
        m["histograms"] = {
            k: (
                {
                    f: (v * args.factor
                        if hit(k) and f != "count" else v)
                    for f, v in summ.items()
                }
                if isinstance(summ, dict) else summ
            )
            for k, summ in (m.get("histograms") or {}).items()
        }
        with open(os.path.join(args.dst, runlog.METRICS), "w") as f:
            json.dump(m, f, indent=2)
    if src["trace"] is not None:
        tr = copy.deepcopy(src["trace"])
        scale_trace = not match  # named scaling targets metrics only
        for ev in tr.get("traceEvents", []):
            if scale_trace and "dur" in ev:
                ev["dur"] = ev["dur"] * args.factor
        with open(os.path.join(args.dst, runlog.TRACE), "w") as f:
            json.dump(tr, f)
    epath = os.path.join(args.src, runlog.EVENTS)
    if os.path.exists(epath):
        with open(epath) as fin, \
                open(os.path.join(args.dst, runlog.EVENTS), "w") as fout:
            fout.write(fin.read())
    print(f"wrote {args.dst}: {args.src} with time-like metrics "
          + (f"matching {match} " if match else "")
          + f"scaled x{args.factor}")
    return 0


# ---------------------------------------------------------------------------
# kernels (profiler attribution report)
# ---------------------------------------------------------------------------

_KERNEL_FIELDS = ("measured_ms", "modeled_ms", "compute_ms", "memory_ms",
                  "flops", "bytes", "achieved_frac", "mem_bound")


def _kernel_report(run: dict) -> Tuple[Dict[str, dict], Dict[str, float]]:
    """(families, machine) parsed back out of the published gauge scheme."""
    m = run.get("metrics") or {}
    gauges = m.get("gauges") or {}
    counters = m.get("counters") or {}
    machine = {
        k.rsplit("/", 1)[-1]: float(v)
        for k, v in gauges.items() if k.startswith("kernels/machine/")
    }
    fams: Dict[str, dict] = {}
    for name, v in gauges.items():
        parts = name.split("/")
        if len(parts) == 3 and parts[0] == "kernels" \
                and parts[1] != "machine" and parts[2] in _KERNEL_FIELDS:
            fams.setdefault(parts[1], {})[parts[2]] = float(v)
    for name, v in counters.items():
        parts = name.split("/")
        if len(parts) == 3 and parts[0] == "kernels" \
                and parts[2] in ("calls", "loop_execs"):
            fams.setdefault(parts[1], {})[parts[2]] = int(v)
    return fams, machine


def cmd_kernels(args) -> int:
    run = _load(args.run)
    fams, machine = _kernel_report(run)
    if not fams:
        print(f"obs_report kernels: no kernel-profiler gauges in {args.run} "
              f"(was the run launched with --profile?)", file=sys.stderr)
        return 2
    if machine:
        print("machine model: "
              + "  ".join(f"{k}={v:.3g}" for k, v in sorted(machine.items())))
    print(f"{'family':<8} {'calls':>6} {'loop':>8} {'measured':>11} "
          f"{'modeled':>10} {'achieved':>9}  verdict")
    for fam in sorted(fams):
        d = fams[fam]
        measured = d.get("measured_ms", 0.0)
        modeled = d.get("modeled_ms", 0.0)
        ach = d.get("achieved_frac")
        verdict = ("memory-bound" if d.get("mem_bound", 0.0) > 0.5
                   else "compute-bound")
        print(f"{fam:<8} {d.get('calls', 0):>6} {d.get('loop_execs', 0):>8} "
              f"{measured:>9.3f}ms {modeled:>8.4f}ms "
              + (f"{ach:>9.2g}" if ach is not None else f"{'—':>9}")
              + f"  {verdict}")

    failures: List[str] = []
    if args.require:
        for fam in [f for f in args.require.split(",") if f]:
            d = fams.get(fam)
            if d is None:
                failures.append(f"{fam}: no attribution recorded")
            elif d.get("measured_ms", 0.0) <= 0.0 \
                    or d.get("modeled_ms", 0.0) <= 0.0:
                failures.append(f"{fam}: present but unattributed "
                                f"(measured={d.get('measured_ms', 0.0):.4g}ms"
                                f" modeled={d.get('modeled_ms', 0.0):.4g}ms)")
    if args.check_model:
        peak = machine.get("word_ops_peak", 0.0)
        bw = machine.get("hbm_bw", 0.0)
        if peak <= 0 or bw <= 0:
            failures.append("machine constants missing from the record")
        else:
            tol = args.tolerance
            for fam in sorted(fams):
                d = fams[fam]
                if d.get("modeled_ms", 0.0) <= 0.0:
                    continue
                want_c = d.get("flops", 0.0) / peak * 1e3
                want_m = d.get("bytes", 0.0) / bw * 1e3
                got_c, got_m = d.get("compute_ms", 0.0), d.get("memory_ms", 0.0)
                if abs(got_c - want_c) > tol * max(want_c, 1e-12):
                    failures.append(
                        f"{fam}: compute_ms {got_c:.4g} != flops/peak "
                        f"{want_c:.4g}")
                if abs(got_m - want_m) > tol * max(want_m, 1e-12):
                    failures.append(
                        f"{fam}: memory_ms {got_m:.4g} != bytes/bw "
                        f"{want_m:.4g}")
                lo = max(got_c, got_m)
                hi = got_c + got_m
                mod = d.get("modeled_ms", 0.0)
                if not (lo * (1 - tol) <= mod <= hi * (1 + tol)):
                    failures.append(
                        f"{fam}: modeled_ms {mod:.4g} outside "
                        f"[max,sum]=[{lo:.4g},{hi:.4g}] of its terms")
                if abs(got_m - got_c) > tol * max(got_m, got_c, 1e-12) and \
                        (d.get("mem_bound", 0.0) > 0.5) != (got_m > got_c):
                    failures.append(f"{fam}: mem_bound verdict inconsistent "
                                    f"with its terms")
    if failures:
        print("KERNEL ATTRIBUTION FAIL: " + "; ".join(failures))
        return 1
    if args.require or args.check_model:
        print("ok: kernel attribution "
              + ("complete" if args.require else "")
              + (" and " if args.require and args.check_model else "")
              + ("model-consistent" if args.check_model else ""))
    return 0


# ---------------------------------------------------------------------------
# history / regress (the perf ledger)
# ---------------------------------------------------------------------------


def _load_history(path: str) -> Tuple[List[dict], int]:
    try:
        rows, corrupt = perfdb.load(path)
    except OSError as e:
        print(f"obs_report: cannot read perf history {path}: {e}",
              file=sys.stderr)
        sys.exit(2)
    if not rows:
        print(f"obs_report: no usable rows in {path}", file=sys.stderr)
        sys.exit(2)
    if corrupt:
        print(f"note: skipped {corrupt} corrupt line(s) in {path}")
    return rows, corrupt


def cmd_history(args) -> int:
    rows, _ = _load_history(args.history)
    series = perfdb.trends(
        rows, suite=args.suite or None, key_match=args.key or None
    )
    if not series:
        print("obs_report history: no matching keys", file=sys.stderr)
        return 2
    if args.format == "markdown":
        print(f"### perf history `{args.history}` "
              f"({len(rows)} rows, {len(series)} series)")
        print()
        print("| suite/key | dir | min | max | trailing values "
              "(newest last) |")
        print("|---|---|---|---|---|")
        for (suite, key), pts in sorted(series.items()):
            d = perfdb.direction(key)
            tail = pts[-args.last:]
            vals = " ".join(f"{p['value']:.4g}" for p in tail)
            lo = min(p["value"] for p in pts)
            hi = max(p["value"] for p in pts)
            print(f"| `{suite}/{key}` | {d or '—'} | {lo:.4g} | {hi:.4g} "
                  f"| {vals} |")
        return 0
    print(f"{args.history}: {len(rows)} rows, {len(series)} series")
    for (suite, key), pts in sorted(series.items()):
        d = perfdb.direction(key)
        tail = pts[-args.last:]
        vals = "  ".join(f"{p['value']:.4g}" for p in tail)
        lo = min(p["value"] for p in pts)
        hi = max(p["value"] for p in pts)
        print(f"  {suite}/{key} [{d or 'untracked'}] "
              f"min={lo:.4g} max={hi:.4g}")
        print(f"    {vals}   (newest last, "
              f"sha {tail[-1]['sha'] or '?'} @ {tail[-1]['ts']})")
    return 0


def _parse_directions(specs: List[str]) -> Dict[str, str]:
    """``KEY=up|down`` (CLI speak) → {key: "higher"|"lower"} (perfdb's)."""
    out: Dict[str, str] = {}
    for spec in specs:
        key, _, word = spec.partition("=")
        if word not in ("up", "down") or not key:
            print(f"obs_report regress: bad --direction {spec!r} "
                  f"(want KEY=up or KEY=down)", file=sys.stderr)
            sys.exit(2)
        out[key] = "higher" if word == "up" else "lower"
    return out


def cmd_regress(args) -> int:
    rows, _ = _load_history(args.history)
    found, checked = perfdb.check_regressions(
        rows,
        threshold=args.threshold,
        window=args.window,
        min_history=args.min_history,
        degrade=args.degrade,
        direction_overrides=_parse_directions(args.direction),
    )
    label = f" (values degraded x{args.degrade} first)" \
        if args.degrade != 1.0 else ""
    if args.format == "markdown":
        print(f"### perf regressions `{args.history}`")
        print()
        print(f"{len(rows)} rows, {checked} gated key(s), threshold "
              f"+{args.threshold:.0%}{label}")
        print()
        if found:
            print("| suite/key | latest | trailing median | worse by |")
            print("|---|---|---|---|")
            for reg in found:
                print(f"| `{reg.suite}/{reg.key}` | {reg.latest:.4g} "
                      f"| {reg.median:.4g} | {reg.ratio:.2f}× |")
            print()
            print(f"**REGRESSION:** {len(found)} key(s) degraded")
            return 1
        print("ok: no key degraded past the threshold")
        return 0
    print(f"{args.history}: {len(rows)} rows, {checked} gated key(s), "
          f"threshold +{args.threshold:.0%}{label}")
    if found:
        for reg in found:
            print(f"  REGRESSION {reg.line()}")
        print(f"REGRESSION: {len(found)} key(s) degraded vs trailing median")
        return 1
    print("ok: no key degraded past the threshold")
    return 0


# ---------------------------------------------------------------------------
# critpath / doctor (the diagnosis layer)
# ---------------------------------------------------------------------------


def cmd_critpath(args) -> int:
    run = _load(args.run)
    cp = critpath.analyze(run.get("trace"), top_n=args.top)
    if cp is None:
        print(f"obs_report critpath: no trace spans in {args.run} "
              f"(was the run launched with --trace?)", file=sys.stderr)
        return 2
    if args.format == "json":
        print(json.dumps(cp, indent=2))
        return 0
    print(f"critical path of {args.run} (wall {cp['wall_ms']:.1f} ms)")
    print(f"  {'self ms':>10}  {'share':>6}  {'n':>3}  name")
    for r in cp["table"]:
        print(f"  {r['self_ms']:>10.2f}  {r['share']:>6.1%}  "
              f"{r['count']:>3d}  {r['name']}"
              + (f"  [{r['tracks']}]" if r["tracks"] else ""))
    if args.path:
        print("path (pre-order, on-path self time):")
        for seg in cp["path"]:
            pad = "  " * seg["depth"]
            print(f"  {pad}{seg['name']}  dur={seg['dur_ms']:.2f}ms "
                  f"self={seg['self_ms']:.2f}ms"
                  + (f"  [{seg['track']}]" if seg["track"] else ""))
    return 0


def cmd_doctor(args) -> int:
    run = _load(args.run)
    history_rows = None
    if args.history and os.path.exists(args.history):
        try:
            history_rows, _ = perfdb.load(args.history)
        except OSError:
            history_rows = None
    report = doctor.diagnose(run, history_rows=history_rows, top_n=args.top)
    if args.format == "json":
        print(json.dumps(report, indent=2))
    elif args.format == "markdown":
        print(doctor.render_markdown(report))
    else:
        print(doctor.render_text(report))
    if args.gate and doctor._RANK[report["worst"]] >= doctor._RANK["error"]:
        print(f"DOCTOR GATE: severity {report['worst']} finding(s) present",
              file=sys.stderr)
        return 1
    return 0


# ---------------------------------------------------------------------------


def main(argv: Optional[Iterable[str]] = None) -> int:
    ap = argparse.ArgumentParser(
        prog="obs_report", description=__doc__.split("\n\n")[0]
    )
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summary", help="digest one run record")
    s.add_argument("run")
    s.add_argument("--events", type=int, default=20,
                   help="max driver events to print")
    s.add_argument("--gauges", type=int, default=24,
                   help="max gauges to print")
    s.add_argument("--format", choices=("text", "json", "markdown"),
                   default="text",
                   help="output format (json: full machine-readable digest; "
                        "markdown: CI step-summary tables)")
    s.set_defaults(fn=cmd_summary)

    d = sub.add_parser("diff", help="compare two runs; exit 1 on regression")
    d.add_argument("old")
    d.add_argument("new")
    d.add_argument("--threshold", type=float, default=0.2,
                   help="allowed slowdown fraction (0.2 = +20%%)")
    d.add_argument("--min-seconds-ignore", type=float, default=0.0,
                   dest="min_seconds_ignore",
                   help="ignore time metrics where both sides are <= this "
                        "(noise floor)")
    d.set_defaults(fn=cmd_diff)

    b = sub.add_parser("baseline",
                       help="gate BENCH_*.json ratio keys; exit 1 on "
                            "regression")
    b.add_argument("run", nargs="?", default="",
                   help="optional run record to compare by shared key names")
    b.add_argument("--bench", action="append", default=[],
                   help="BENCH_*.json baseline file (repeatable)")
    b.add_argument("--threshold", type=float, default=0.05,
                   help="allowed overhead/slowdown above 1.0 (0.05 = 5%%)")
    b.add_argument("--match", action="append", default=[],
                   help="only gate ratio keys containing this substring "
                        "(repeatable; default: every overhead/slowdown key)")
    b.set_defaults(fn=cmd_baseline)

    i = sub.add_parser("inject-slowdown",
                       help="copy a run record with time metrics scaled "
                            "(deterministic diff-gate test input)")
    i.add_argument("src")
    i.add_argument("dst")
    i.add_argument("--factor", type=float, default=1.3)
    i.add_argument("--match", action="append", default=[],
                   help="only scale time-like metrics containing this "
                        "substring (repeatable; trace durations untouched "
                        "when given)")
    i.set_defaults(fn=cmd_inject)

    k = sub.add_parser("kernels",
                       help="render kernel-profiler attribution; gate on "
                            "coverage/model consistency")
    k.add_argument("run")
    k.add_argument("--require", default="",
                   help="comma-separated families that must carry "
                        "attribution (exit 1 otherwise), e.g. "
                        "bitmap,multi,pair,subset,delta")
    k.add_argument("--check-model", action="store_true", dest="check_model",
                   help="recompute roofline terms from the flop/byte/machine "
                        "gauges; exit 1 on mismatch")
    k.add_argument("--tolerance", type=float, default=0.01,
                   help="relative tolerance of --check-model (default 1%%)")
    k.set_defaults(fn=cmd_kernels)

    h = sub.add_parser("history", help="render perf-ledger trends")
    h.add_argument("--history", default=perfdb.DEFAULT_PATH)
    h.add_argument("--suite", default="", help="only this suite")
    h.add_argument("--key", default="", help="only keys containing this")
    h.add_argument("--last", type=int, default=12,
                   help="values shown per series (newest last)")
    h.add_argument("--format", choices=("text", "markdown"), default="text",
                   help="markdown renders a CI step-summary table")
    h.set_defaults(fn=cmd_history)

    r = sub.add_parser("regress",
                       help="gate the newest perf-ledger row vs trailing "
                            "median; exit 1 on degradation")
    r.add_argument("--history", default=perfdb.DEFAULT_PATH)
    r.add_argument("--threshold", type=float, default=0.25,
                   help="allowed relative degradation (0.25 = 25%%)")
    r.add_argument("--window", type=int, default=8,
                   help="trailing values the median is taken over")
    r.add_argument("--min-history", type=int, default=2,
                   dest="min_history",
                   help="prior values a key needs before it gates")
    r.add_argument("--degrade", type=float, default=1.0,
                   help="synthetically worsen newest values by this factor "
                        "(failing-partner self-test)")
    r.add_argument("--direction", action="append", default=[],
                   metavar="KEY=up|down",
                   help="override the name-inferred better-direction of a "
                        "key (up = higher is better); repeatable")
    r.add_argument("--format", choices=("text", "markdown"), default="text",
                   help="markdown renders a CI step-summary table")
    r.set_defaults(fn=cmd_regress)

    c = sub.add_parser("critpath",
                       help="critical path + exclusive self-time of one "
                            "traced run")
    c.add_argument("run")
    c.add_argument("--top", type=int, default=10,
                   help="rows in the by-name critical-path table")
    c.add_argument("--path", action="store_true",
                   help="also print the full pre-order path")
    c.add_argument("--format", choices=("text", "json"), default="text")
    c.set_defaults(fn=cmd_critpath)

    o = sub.add_parser("doctor",
                       help="diagnose one run record: critical path, "
                            "speedup waterfall, ranked findings")
    o.add_argument("run")
    o.add_argument("--history", default=perfdb.DEFAULT_PATH,
                   help="perf ledger for trend rules (missing file: rules "
                        "needing history are skipped)")
    o.add_argument("--top", type=int, default=10,
                   help="rows in the critical-path table")
    o.add_argument("--format", choices=("text", "json", "markdown"),
                   default="text")
    o.add_argument("--gate", action="store_true",
                   help="exit 1 when any severity>=error finding fires")
    o.set_defaults(fn=cmd_doctor)

    args = ap.parse_args(list(argv) if argv is not None else None)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())

"""The performance doctor: ranked, actionable diagnoses over a run record.

The port's copy of the JAX package's ``obs/doctor.py``: the same rule ids,
severities, thresholds and evidence keys.  Where a title or a remediation
of the reference names jit, XLA, tiles or autotuning, this copy names what
applies to the port: eager kernels, their launch facts, the kernel library's
load at first use.

PRs 7–9 taught every driver to *record* — spans, the canonical metrics
snapshot, kernel attribution, the perf ledger.  This module *interprets*:
a rules engine over three inputs

  * the canonical snapshot (``metrics.json``),
  * the critical path (:mod:`repro_torch.obs.critpath` over ``trace.json``),
  * the speedup-loss waterfall (:mod:`repro_torch.obs.speedup`, cluster runs),

emitting :class:`Finding` rows — each with a stable rule id, a severity,
the **evidence keys** (the exact gauge/counter/histogram names and values
that triggered it), and a remediation hint naming the knob to turn.

Rule catalog (ids are stable; golden tests diff the exact finding set):

  ``cluster-imbalance``      always on cluster runs: how much speedup the
                             shard load skew costs (info → warn when it
                             dominates the gap).  Evidence: the waterfall
                             imbalance term, ``cluster/imbalance``.
  ``rebalance-not-engaging`` imbalance dominates *and* ``cluster/donations``
                             is 0 — the rebalancer exists but did nothing.
  ``thm61-estimation-error`` always on cluster runs: the paper's own
                             metric — Thm 6.1 sample-estimated vs observed
                             load shares (``cluster/load/estimation_error``,
                             ``cluster/shard{p}/est_load|obs_load``); warn
                             when the unpredicted skew is material.
  ``exchange-dominates``     Phase-3 all_to_all is the largest loss term.
  ``compile-warmup``         round-0 warm-up (kernel library load, caching
                             allocator growth) costs a material slice.
  ``prefetch-stall``         ``store/prefetch_stall_s`` p95 above threshold;
                             escalates when store spans sit on the critical
                             path — raise ``host_budget_blocks``.
  ``roofline-regression``    a ``kernels/*/achieved_frac`` gauge dropped vs
                             its trailing median in ``BENCH_torch_HISTORY.jsonl``.
  ``capacity-overflow``      exchange/mine overflow counters nonzero —
                             exactness is at risk; raise capacity factors.
  ``retry-exhausted``        ``store/retry/exhausted`` nonzero (error) /
                             ``store/retry/retried_errors`` nonzero (warn).
  ``service-errors``         serving: ``service/errors`` nonzero.
  ``service-shed``           serving: ``service/shed`` nonzero — queue
                             capacity or offered load needs adjusting.
  ``trace-truncated``        the tracer dropped events (``max_events``);
                             the critical path may be partial.
  ``healthy``                emitted when nothing at warn+ fired.

Severities: ``info`` < ``warn`` < ``error``; ``--gate`` fails the process
when anything ≥ ``error`` fires.  Stdlib-only.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

from repro_torch.obs import critpath as critpath_mod
from repro_torch.obs import perfdb
from repro_torch.obs import speedup as speedup_mod

SEVERITIES = ("info", "warn", "error")
_RANK = {s: i for i, s in enumerate(SEVERITIES)}


@dataclasses.dataclass
class Finding:
    """One diagnosis: what fired, on what evidence, and what to turn."""

    rule: str                 # stable id from the catalog above
    severity: str             # "info" | "warn" | "error"
    title: str                # one line, rendered in every format
    detail: str               # the why, with numbers
    evidence: Dict[str, float]  # metric/gauge names -> values that triggered
    remediation: str          # the knob to turn

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclasses.dataclass
class Thresholds:
    """Every rule's tunable trigger point, in one reviewable place."""

    dominant_frac: float = 0.5       # share of the parallel-phase losses
    min_gap_x: float = 0.25          # ignore dominance below this gap
    imbalance_dominant_x: float = 0.5   # absolute floor for "dominates"
    imbalance_warn: float = 1.5      # max/mean observed load
    est_err_warn: float = 0.15       # Thm 6.1 max |est - obs| load share
    est_loss_warn_x: float = 0.25    # or: speedup lost to unpredicted skew
    exchange_frac: float = 0.3       # exchange share of the gap
    compile_frac: float = 0.3        # compile share of the gap
    stall_p95_warn_s: float = 0.02   # prefetch stall p95
    stall_share_warn: float = 0.10   # stall seconds / wall seconds
    roofline_drop: float = 0.15      # relative achieved_frac drop vs median
    roofline_min_history: int = 3    # rows before the roofline rule gates
    dropped_events_warn: int = 10_000


def _sev_max(a: str, b: str) -> str:
    return a if _RANK[a] >= _RANK[b] else b


def worst_severity(findings: List[Finding]) -> str:
    sev = "info"
    for f in findings:
        sev = _sev_max(sev, f.severity)
    return sev


# ---------------------------------------------------------------------------
# The rules
# ---------------------------------------------------------------------------


def _counters(snap: dict) -> Dict[str, float]:
    return {k: float(v) for k, v in (snap.get("counters") or {}).items()
            if isinstance(v, (int, float))}


def _gauges(snap: dict) -> Dict[str, float]:
    return {k: float(v) for k, v in (snap.get("gauges") or {}).items()
            if isinstance(v, (int, float))}


def _hist(snap: dict, name: str) -> Optional[dict]:
    h = (snap.get("histograms") or {}).get(name)
    return h if isinstance(h, dict) else None


def _term(wf, name: str):
    for t in wf.terms:
        if t.name == name:
            return t
    return None


def _cluster_rules(
    snap: dict, wf, th: Thresholds, out: List[Finding]
) -> None:
    g = _gauges(snap)
    if wf is None and "cluster/imbalance" not in g:
        return
    gap = wf.gap_x if wf else 0.0
    imb = g.get("cluster/imbalance", 1.0)
    donations = _counters(snap).get("cluster/donations", 0.0)

    # -- cluster-imbalance: always emitted, severity scales ------------------
    t_imb = _term(wf, "imbalance") if wf else None
    loss_x = t_imb.loss_x if t_imb else 0.0
    # "dominates" is judged among the PARALLEL-phase losses (imbalance /
    # estimation / exchange / compile): host_tail and driver are the serial
    # fraction — real, but not what the rebalancer or the Thm 6.1 sample
    # can fix, and on small demo runs they swamp everything.  An absolute
    # floor keeps a well-balanced run (tiny parallel losses, big serial
    # overhead) from ever "dominating".
    par = {t.name: t.loss_x for t in wf.terms} if wf else {}
    par_losses = [par.get(k, 0.0)
                  for k in ("imbalance", "estimation", "exchange", "compile")]
    dominates = (
        wf is not None and gap >= th.min_gap_x
        and loss_x >= th.imbalance_dominant_x
        and loss_x >= max(par_losses)
        and loss_x >= th.dominant_frac * sum(par_losses)
    )
    sev = "warn" if (dominates or imb >= th.imbalance_warn) else "info"
    ev = {"cluster/imbalance": imb, "speedup/loss/imbalance_x": loss_x}
    if "cluster/makespan_trips" in g:
        ev["cluster/makespan_trips"] = g["cluster/makespan_trips"]
    out.append(Finding(
        rule="cluster-imbalance", severity=sev,
        title=(f"shard load imbalance (max/mean {imb:.2f}) costs "
               f"{loss_x:.2f}x of speedup"
               + (" — the dominant loss term" if dominates else "")),
        detail=(f"observed per-shard DFS work is uneven; the imbalance "
                f"waterfall term is {loss_x:.2f}x of the "
                f"{gap:.2f}x gap to ideal" if wf else
                f"observed per-shard DFS work max/mean = {imb:.2f}"),
        evidence=ev,
        remediation=("smaller --chunk (finer rounds), rebalancing on, or "
                     "more equivalence classes per shard"),
    ))

    # -- rebalance-not-engaging ---------------------------------------------
    if dominates and donations == 0:
        out.append(Finding(
            rule="rebalance-not-engaging", severity="error",
            title="imbalance dominates but the rebalancer made 0 donations",
            detail=("the imbalance term dominates the speedup gap yet "
                    "cluster/donations is 0: inter-round queue donation "
                    "never engaged"),
            evidence={"cluster/donations": donations,
                      "speedup/loss/imbalance_x": loss_x,
                      "cluster/imbalance": imb},
            remediation=("check rebalance=True / --no-rebalance, raise "
                         "max_donations, or lower the donation threshold"),
        ))

    # -- thm61-estimation-error: the paper's metric, always emitted ----------
    est_err = g.get("cluster/load/estimation_error", 0.0)
    t_est = _term(wf, "estimation") if wf else None
    est_loss = t_est.loss_x if t_est else 0.0
    ev = {"cluster/load/estimation_error": est_err,
          "speedup/loss/estimation_x": est_loss}
    # attach the worst shard's est/obs pair as direct Thm 6.1 evidence
    shards = speedup_mod._shard_loads(g)
    if shards is not None:
        est, obs = shards
        W, E = sum(obs) or 1.0, sum(est) or 1.0
        p_worst = max(range(len(obs)),
                      key=lambda p: abs(obs[p] / W - est[p] / E))
        ev[f"cluster/shard{p_worst}/est_load"] = est[p_worst]
        ev[f"cluster/shard{p_worst}/obs_load"] = obs[p_worst]
    sev = ("warn" if est_err >= th.est_err_warn
           or est_loss >= th.est_loss_warn_x else "info")
    out.append(Finding(
        rule="thm61-estimation-error", severity=sev,
        title=(f"Thm 6.1 load estimation error {est_err:.3f} "
               f"(unpredicted skew costs {est_loss:.2f}x)"),
        detail=("max |estimated - observed| per-shard load share; the "
                "estimation waterfall term prices only the skew the "
                "sample-based plan failed to predict"),
        evidence=ev,
        remediation=("raise the Thm 6.1 sample sizes (n_db_sample / "
                     "n_fi_sample) or loosen eps_db"),
    ))

    if wf is None or gap < th.min_gap_x:
        return

    # -- exchange-dominates --------------------------------------------------
    t_ex = _term(wf, "exchange")
    if t_ex and t_ex.loss_x >= th.exchange_frac * gap and t_ex.loss_x > 0:
        out.append(Finding(
            rule="exchange-dominates", severity="warn",
            title=(f"Phase-3 exchange costs {t_ex.loss_x:.2f}x of the "
                   f"{gap:.2f}x gap"),
            detail="all_to_all transaction exchange wall is a major term",
            evidence={"cluster/phase_ms/exchange": t_ex.ms,
                      "speedup/loss/exchange_x": t_ex.loss_x},
            remediation=("larger --chunk (fewer exchange rounds) or overlap "
                         "exchange with mining"),
        ))

    # -- compile-warmup ------------------------------------------------------
    t_c = _term(wf, "compile")
    if t_c and t_c.loss_x >= th.compile_frac * gap and t_c.loss_x > 0:
        out.append(Finding(
            rule="compile-warmup", severity="info",
            title=(f"round-0 warm-up costs {t_c.loss_x:.2f}x "
                   f"({t_c.ms:.0f} ms)"),
            detail=("round 0's mine wall sits above its steady per-trip "
                    "rate: the kernel library's load at first use and the "
                    "caching allocator's growth, not algorithmic loss"),
            evidence={"cluster/round0/mine_ms":
                      t_c.evidence.get("cluster/round0/mine_ms", t_c.ms),
                      "speedup/loss/compile_x": t_c.loss_x},
            remediation=("build the kernel library before the run (it is "
                         "cached under build/repro_torch), warm the allocator, "
                         "or amortize over longer runs before reading speedups"),
        ))


def _store_rules(
    snap: dict, cp: Optional[dict], th: Thresholds, out: List[Finding]
) -> None:
    h = _hist(snap, "store/prefetch_stall_s")
    c = _counters(snap)
    if h and h.get("count", 0) > 0:
        p95 = float(h.get("p95") or 0.0)
        stall_sum = float(h.get("sum") or 0.0)
        wall_s = (cp or {}).get("wall_ms", 0.0) / 1e3
        share = stall_sum / wall_s if wall_s > 0 else 0.0
        on_path = any(
            "store" in r["name"] or "prefetch" in r["name"]
            for r in (cp or {}).get("table", [])
        )
        if p95 > th.stall_p95_warn_s:
            sev = "error" if (on_path or share > th.stall_share_warn) \
                else "warn"
            out.append(Finding(
                rule="prefetch-stall", severity=sev,
                title=(f"prefetch stalls: p95 {p95 * 1e3:.1f} ms, "
                       f"{stall_sum:.2f} s total"
                       + (" — store work on the critical path"
                          if on_path else "")),
                detail=(f"the consumer blocked on disk reads the double "
                        f"buffer failed to hide ({share:.0%} of wall)"
                        if wall_s > 0 else
                        "the consumer blocked on disk reads the double "
                        "buffer failed to hide"),
                evidence={"store/prefetch_stall_s.p95": p95,
                          "store/prefetch_stall_s.sum": stall_sum,
                          "store/blocks_read":
                          c.get("store/blocks_read", 0.0)},
                remediation=("raise host_budget_blocks (--budget-blocks) "
                             "or use larger blocks"),
            ))
    if c.get("store/retry/exhausted", 0) > 0:
        out.append(Finding(
            rule="retry-exhausted", severity="error",
            title=f"{c['store/retry/exhausted']:.0f} I/O retries exhausted",
            detail="a block read/transfer failed past the retry budget",
            evidence={"store/retry/exhausted": c["store/retry/exhausted"],
                      "store/retry/attempts":
                      c.get("store/retry/attempts", 0.0)},
            remediation="check the disk/path; raise RetryPolicy.max_attempts",
        ))
    elif c.get("store/retry/retried_errors", 0) > 0:
        out.append(Finding(
            rule="retry-exhausted", severity="warn",
            title=(f"{c['store/retry/retried_errors']:.0f} transient I/O "
                   "errors were retried"),
            detail="reads succeeded only after retry: flaky storage",
            evidence={"store/retry/retried_errors":
                      c["store/retry/retried_errors"]},
            remediation="inspect the storage path before trusting timings",
        ))


def _overflow_rules(snap: dict, out: List[Finding]) -> None:
    g = _gauges(snap)
    c = _counters(snap)
    total = (g.get("cluster/exchange_overflow", 0)
             + g.get("cluster/mine_overflow", 0)
             + c.get("fimi/exchange_overflow", 0))
    if total > 0:
        out.append(Finding(
            rule="capacity-overflow", severity="error",
            title=f"{total:.0f} buffer overflows: exactness at risk",
            detail=("exchange/mine capacity buffers overflowed; results "
                    "may be truncated unless strict mode raised"),
            evidence={k: v for k, v in
                      {"cluster/exchange_overflow":
                       g.get("cluster/exchange_overflow", 0),
                       "cluster/mine_overflow":
                       g.get("cluster/mine_overflow", 0),
                       "fimi/exchange_overflow":
                       c.get("fimi/exchange_overflow", 0)}.items() if v},
            remediation="raise the capacity factor / frontier cap",
        ))


def _serve_rules(snap: dict, out: List[Finding]) -> None:
    c = _counters(snap)
    errors = c.get("service/errors", 0)
    shed = c.get("service/shed", 0)
    if errors > 0:
        out.append(Finding(
            rule="service-errors", severity="error",
            title=f"{errors:.0f} serving requests errored",
            detail="the mining service returned typed errors",
            evidence={"service/errors": errors},
            remediation="inspect service logs; errors burn the SLO budget",
        ))
    if shed > 0:
        h = _hist(snap, "service/latency_ms") or {}
        out.append(Finding(
            rule="service-shed", severity="warn",
            title=f"{shed:.0f} serving requests shed",
            detail="the admission queue filled; offered load beat capacity",
            evidence={"service/shed": shed,
                      "service/latency_ms.p95":
                      float(h.get("p95") or 0.0)},
            remediation=("raise queue capacity / batch window, or lower "
                         "offered QPS"),
        ))


def _trace_rules(snap: dict, th: Thresholds, out: List[Finding]) -> None:
    c = _counters(snap)
    dropped = c.get("trace/dropped_events", 0)
    if dropped > 0:
        sev = "warn" if dropped >= th.dropped_events_warn else "info"
        out.append(Finding(
            rule="trace-truncated", severity=sev,
            title=f"trace dropped {dropped:.0f} oldest events at its cap",
            detail=("the exported trace is a suffix of the run; critical-"
                    "path and self-time numbers cover only what remains"),
            evidence={"trace/dropped_events": dropped},
            remediation="raise Tracer max_events for full-fidelity traces",
        ))


def _roofline_rules(
    snap: dict, history_rows: Optional[List[dict]], th: Thresholds,
    out: List[Finding],
) -> None:
    if not history_rows:
        return
    fams = {
        k: v for k, v in _gauges(snap).items()
        if k.startswith("kernels/") and k.endswith("/achieved_frac")
    }
    if not fams:
        return
    series = perfdb.trends(history_rows)
    for gauge_name, val in sorted(fams.items()):
        fam = gauge_name.split("/")[1]
        hist = None
        for (_suite, key), pts in series.items():
            if key == gauge_name or key == f"{fam}_achieved_frac":
                hist = [p["value"] for p in pts]
                break
        if not hist or len(hist) < th.roofline_min_history:
            continue
        med = perfdb._median(hist[-8:])
        if med > 0 and val < med * (1.0 - th.roofline_drop):
            out.append(Finding(
                rule="roofline-regression", severity="warn",
                title=(f"kernel family '{fam}' at {val:.2f} of roofline, "
                       f"down from trailing median {med:.2f}"),
                detail=(f"achieved fraction dropped "
                        f"{(1 - val / med):.0%} vs the perf history"),
                evidence={gauge_name: val, f"{gauge_name}.median": med},
                remediation=("compare the family's kernels with their launch "
                             "facts (chip_smoke.py's launch_facts line: grid, "
                             "blocks an SM, waves, registers, spills) at the "
                             "current input sizes"),
            ))


# ---------------------------------------------------------------------------
# diagnose: the engine
# ---------------------------------------------------------------------------


def _wf_dict(wf) -> dict:
    return {
        "P": wf.P, "ideal_x": wf.ideal_x, "measured_x": wf.measured_x,
        "gap_x": wf.gap_x, "wall_ms": wf.wall_ms, "ideal_ms": wf.ideal_ms,
        "additivity_err": wf.additivity_error(), "source": wf.source,
        "terms": [dataclasses.asdict(t) for t in wf.terms],
    }


def diagnose(
    run: dict,
    *,
    history_rows: Optional[List[dict]] = None,
    thresholds: Optional[Thresholds] = None,
    top_n: int = 10,
) -> dict:
    """Run every rule over one loaded run record (``runlog.load_run`` shape).

    Returns ``{"findings": [...], "worst": sev, "critpath": ...,
    "waterfall": ...}`` — findings sorted severity-first, both analysis
    digests included (None when the record lacks the needed input) so the
    renderers and golden tests see one self-contained dict.
    """
    th = thresholds or Thresholds()
    snap = run.get("metrics") or {}
    cp = critpath_mod.analyze(run.get("trace"), top_n=top_n)
    wf = speedup_mod.from_run(run)

    findings: List[Finding] = []
    _cluster_rules(snap, wf, th, findings)
    _store_rules(snap, cp, th, findings)
    _overflow_rules(snap, findings)
    _serve_rules(snap, findings)
    _trace_rules(snap, th, findings)
    _roofline_rules(snap, history_rows, th, findings)

    if worst_severity(findings) == "info":
        detail = "no rule fired above info"
        if wf is not None:
            detail = (f"modeled speedup {wf.measured_x:.2f}x of "
                      f"{wf.ideal_x:.0f}x ideal; no rule fired above info")
        findings.append(Finding(
            rule="healthy", severity="info",
            title="no actionable performance problems found",
            detail=detail, evidence={}, remediation="",
        ))

    findings.sort(key=lambda f: (-_RANK[f.severity], f.rule))
    return {
        "findings": [f.to_dict() for f in findings],
        "worst": worst_severity(findings),
        "critpath": cp,
        "waterfall": _wf_dict(wf) if wf is not None else None,
    }


# ---------------------------------------------------------------------------
# Renderers (shared by obs_report doctor and the drivers' --doctor exit hook)
# ---------------------------------------------------------------------------

_MARK = {"info": "·", "warn": "!", "error": "✗"}


def render_text(report: dict, *, verbose: bool = True) -> str:
    lines: List[str] = []
    cp = report.get("critpath")
    if cp and verbose:
        lines.append(f"critical path (wall {cp['wall_ms']:.1f} ms):")
        lines.append(f"  {'self ms':>9}  {'share':>6}  {'n':>3}  name")
        for r in cp["table"]:
            lines.append(
                f"  {r['self_ms']:>9.2f}  {r['share']:>6.1%}  "
                f"{r['count']:>3d}  {r['name']}"
                + (f"  [{r['tracks']}]" if r["tracks"] else "")
            )
        lines.append("")
    wfd = report.get("waterfall")
    if wfd and verbose:
        wf = _wf_from_dict(wfd)
        lines.append(wf.render_text())
        lines.append("")
    lines.append(f"doctor: {len(report['findings'])} finding(s), "
                 f"worst = {report['worst']}")
    for f in report["findings"]:
        lines.append(f"  {_MARK.get(f['severity'], '?')} "
                     f"[{f['severity']}] {f['rule']}: {f['title']}")
        if verbose and f["detail"]:
            lines.append(f"      {f['detail']}")
        if verbose and f["evidence"]:
            ev = ", ".join(f"{k}={v:.4g}" for k, v in f["evidence"].items())
            lines.append(f"      evidence: {ev}")
        if f["remediation"]:
            lines.append(f"      fix: {f['remediation']}")
    return "\n".join(lines)


def render_markdown(report: dict) -> str:
    lines: List[str] = ["## Performance doctor", ""]
    lines.append(f"**{len(report['findings'])} finding(s)** — worst "
                 f"severity: **{report['worst']}**")
    lines.append("")
    lines.append("| sev | rule | finding | remediation |")
    lines.append("|---|---|---|---|")
    for f in report["findings"]:
        lines.append(f"| {f['severity']} | `{f['rule']}` | {f['title']} | "
                     f"{f['remediation']} |")
    cp = report.get("critpath")
    if cp:
        lines += ["", "### Critical path", "",
                  f"wall: {cp['wall_ms']:.1f} ms", "",
                  "| self ms | share | n | span |", "|---|---|---|---|"]
        for r in cp["table"]:
            lines.append(f"| {r['self_ms']:.2f} | {r['share']:.1%} | "
                         f"{r['count']} | `{r['name']}` |")
    wfd = report.get("waterfall")
    if wfd:
        lines += ["", "### Speedup waterfall", "",
                  _wf_from_dict(wfd).render_markdown()]
    return "\n".join(lines)


def _wf_from_dict(d: dict):
    terms = [speedup_mod.LossTerm(**t) for t in d["terms"]]
    return speedup_mod.Waterfall(
        P=d["P"], ideal_x=d["ideal_x"], measured_x=d["measured_x"],
        wall_ms=d["wall_ms"], ideal_ms=d["ideal_ms"], terms=terms,
        source=d["source"],
    )

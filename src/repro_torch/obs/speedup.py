"""Speedup accounting: decompose (ideal P× − measured×) into loss terms.

The port's copy of the JAX package's ``obs/speedup.py``: the same terms,
the same arithmetic and the same ``speedup/*`` gauge names, so one
``obs_report`` reads a run of either package.

The paper's headline is a speedup of ~6 on 10 processors, and its method
is an argument about the *gap to ideal*: Thm 6.1 sample estimates bound
how uneven the partition can be, the exchange phases are the price of
independence, and everything else is overhead.  This module turns one
cluster run's telemetry — gauges and spans the executor already records —
into an **additive waterfall** over that gap.

Accounting scheme (exact by construction).  Let ``TP`` be the run's wall
time and ``T_ideal`` the perfectly-parallel time: total observed DFS work
``W = Σ_p obs_load_p`` split ``P`` ways, at the steady per-trip rate ``ρ``
measured on this very run.  Write

    TP = T_ideal + Δ_compile + Δ_estimation + Δ_imbalance
       + Δ_exchange + Δ_host_tail + Δ_driver

with every ``Δ`` ≥ 0 derived below and the last one the residual.  Then
with measured (modeled) speedup ``S = P · T_ideal / TP``,

    P − S  =  Σ_k  P · Δ_k / TP

— each term *is* the speedup lost to that cause, and the terms sum to the
gap exactly (floating point aside), which is what the acceptance gate
checks.  Terms:

  * ``compile``     — round 0's mine wall above its steady-rate cost:
                      the warm-up of the first round (needs per-round
                      ``mine_ms`` gauges).  Nothing is compiled in the
                      port: on the card this is the kernel library's load
                      at first use and the caching allocator's growth.
  * ``estimation``  — skew the planner *failed to predict*: observed vs
                      estimated max load share (the paper's own Thm 6.1
                      metric), priced at ``ρ``.
  * ``imbalance``   — the rest of ``Σ_r max_p − W/P``: planned skew plus
                      round-granularity, the rebalancer's target.
  * ``exchange``    — Phase-3 all_to_all wall (``phase_ms/exchange``).
  * ``host_tail``   — plan + merge + store assembly: serial host work.
  * ``driver``      — wall not inside any phase (only when the manifest
                      carries ``mine_wall_s``).

``S`` is *modeled* — relative to this run's own work at its own rate, the
same convention as ``BENCH_cluster.json``'s trips-based speedups — so one
run decomposes without needing a P=1 partner.  For BENCH curve entries
(which do have the P=1 baseline but no phase detail),
:func:`from_bench_entries` gives the coarser exact split

    P − S  =  [P − S·imbalance]  +  [S·(imbalance − 1)]
               (work inflation)      (load imbalance)

where S = base_makespan/makespan and imbalance = max/mean observed load.

Stdlib-only.
"""
from __future__ import annotations

import dataclasses
import re
from typing import Dict, List, Optional

#: phase_ms keys that are serial host work at the run's tail/head
_HOST_PHASES = ("plan", "merge", "assemble")


@dataclasses.dataclass
class LossTerm:
    """One cause's share of the speedup gap."""

    name: str                # "imbalance" | "estimation" | ...
    loss_x: float            # speedup units; sums to ideal − measured
    ms: float                # the wall time behind it
    detail: str              # one-line human explanation
    evidence: Dict[str, float] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Waterfall:
    """The additive decomposition of one run's speedup gap."""

    P: int
    ideal_x: float           # = P
    measured_x: float        # modeled: P * T_ideal / TP
    wall_ms: float           # TP
    ideal_ms: float          # T_ideal
    terms: List[LossTerm]
    source: str              # "run" | "bench"

    @property
    def gap_x(self) -> float:
        return self.ideal_x - self.measured_x

    def additivity_error(self) -> float:
        """|Σ terms − gap| / ideal — the acceptance gate checks < 5%."""
        s = sum(t.loss_x for t in self.terms)
        return abs(s - self.gap_x) / max(self.ideal_x, 1e-12)

    def gauges(self) -> Dict[str, float]:
        """The ``speedup/*`` gauge family this waterfall publishes."""
        out = {
            "speedup/ideal_x": self.ideal_x,
            "speedup/measured_x": self.measured_x,
            "speedup/gap_x": self.gap_x,
            "speedup/additivity_err": self.additivity_error(),
        }
        for t in self.terms:
            out[f"speedup/loss/{t.name}_x"] = t.loss_x
        return out

    def publish(self, reg) -> None:
        for name, v in self.gauges().items():
            reg.gauge(name).set(float(v))

    # -- rendering -----------------------------------------------------------
    def rows(self) -> List[Dict[str, object]]:
        rows: List[Dict[str, object]] = [
            {"label": f"ideal ({self.P} shards)", "x": self.ideal_x,
             "kind": "ideal", "detail": ""}
        ]
        for t in sorted(self.terms, key=lambda t: -t.loss_x):
            rows.append({"label": f"− {t.name}", "x": -t.loss_x,
                         "kind": "loss", "detail": t.detail})
        rows.append({"label": "= measured (modeled)", "x": self.measured_x,
                     "kind": "measured", "detail": ""})
        return rows

    def render_text(self, width: int = 34) -> str:
        scale = width / max(self.ideal_x, 1e-12)
        lines = [f"speedup waterfall ({self.source}): ideal {self.ideal_x:.2f}x "
                 f"-> measured {self.measured_x:.2f}x "
                 f"(gap {self.gap_x:.2f}x, additivity err "
                 f"{self.additivity_error():.1%})"]
        running = self.ideal_x
        for r in self.rows():
            x = float(r["x"])  # signed
            if r["kind"] == "loss":
                running += x
            bar_len = max(0, int(round(abs(x) * scale)))
            bar = ("█" if r["kind"] != "loss" else "▒") * bar_len
            detail = f"  {r['detail']}" if r["detail"] else ""
            lines.append(f"  {r['label']:<22} {x:>+7.3f}x "
                         f"|{bar:<{width}}|{detail}")
        return "\n".join(lines)

    def render_markdown(self) -> str:
        lines = [
            f"**speedup waterfall** ({self.source}): ideal "
            f"{self.ideal_x:.2f}× → measured {self.measured_x:.2f}× "
            f"(gap {self.gap_x:.2f}×, additivity err "
            f"{self.additivity_error():.1%})",
            "",
            "| term | Δ speedup | why |",
            "|---|---|---|",
        ]
        for r in self.rows():
            lines.append(f"| {r['label']} | {float(r['x']):+.3f}× | "
                         f"{r['detail']} |")
        return "\n".join(lines)


# ---------------------------------------------------------------------------
# From a run record's canonical snapshot
# ---------------------------------------------------------------------------

_SHARD_RE = re.compile(r"^cluster/shard(\d+)/(est_load|obs_load)$")
_ROUND_RE = re.compile(r"^cluster/round(\d+)/(mine_ms|max_trips)$")


def _shard_loads(gauges: Dict[str, float]):
    est: Dict[int, float] = {}
    obs: Dict[int, float] = {}
    for k, v in gauges.items():
        m = _SHARD_RE.match(k)
        if m:
            (est if m.group(2) == "est_load" else obs)[int(m.group(1))] = \
                float(v)
    P = len(obs)
    if P == 0 or len(est) != P:
        return None
    return ([est[p] for p in range(P)], [obs[p] for p in range(P)])


def from_snapshot(
    snapshot: dict, *, wall_ms: Optional[float] = None
) -> Optional[Waterfall]:
    """Build the waterfall from a cluster run's canonical metrics snapshot.

    Needs the ``cluster/shard{p}/{est,obs}_load`` gauges, the
    ``cluster/phase_ms/*`` gauges and ``cluster/makespan_trips``; uses the
    per-round ``cluster/round{r}/{mine_ms,max_trips}`` gauges for the
    compile term when present.  Returns None when the snapshot is not a
    cluster run's.
    """
    gauges = {k: float(v) for k, v in (snapshot.get("gauges") or {}).items()
              if isinstance(v, (int, float))}
    loads = _shard_loads(gauges)
    makespan = gauges.get("cluster/makespan_trips", 0.0)
    mine_ms = gauges.get("cluster/phase_ms/mine", 0.0)
    if loads is None or makespan <= 0 or mine_ms <= 0:
        return None
    est, obs = loads
    P = len(obs)
    W = sum(obs)
    if W <= 0:
        return None

    # per-round detail (for the compile term); tolerate absence
    rounds: Dict[int, Dict[str, float]] = {}
    for k, v in gauges.items():
        m = _ROUND_RE.match(k)
        if m:
            rounds.setdefault(int(m.group(1)), {})[m.group(2)] = float(v)
    mine0 = rounds.get(0, {})
    r0_ms, r0_trips = mine0.get("mine_ms", 0.0), mine0.get("max_trips", 0.0)
    later_ms = mine_ms - r0_ms
    later_trips = makespan - r0_trips
    if len(rounds) >= 2 and r0_ms > 0 and later_trips > 0 and later_ms > 0:
        rho = later_ms / later_trips           # steady ms per critical trip
        d_compile = max(0.0, r0_ms - r0_trips * rho)
    else:
        rho = mine_ms / makespan
        d_compile = 0.0

    t_ideal = (W / P) * rho
    # the skew the planner did not predict: observed vs estimated max share
    est_total = sum(est)
    est_max_share = (max(est) / est_total) if est_total > 0 else 1.0 / P
    obs_max_share = max(obs) / W
    d_imb_total = max(0.0, mine_ms - d_compile - t_ideal)
    d_est = min(
        d_imb_total,
        max(0.0, (obs_max_share - est_max_share) * W * rho),
    )
    d_imb = d_imb_total - d_est

    phase = {
        k.rsplit("/", 1)[-1]: v
        for k, v in gauges.items() if k.startswith("cluster/phase_ms/")
    }
    d_exchange = max(0.0, phase.get("exchange", 0.0))
    d_host = sum(max(0.0, phase.get(p, 0.0)) for p in _HOST_PHASES)
    d_host += sum(
        max(0.0, v) for k, v in phase.items()
        if k not in _HOST_PHASES + ("exchange", "mine")
    )
    tp_phases = t_ideal + d_compile + d_est + d_imb + d_exchange + d_host
    d_driver = max(0.0, (wall_ms or 0.0) - tp_phases)
    TP = tp_phases + d_driver

    def loss(ms: float) -> float:
        return P * ms / TP

    imb_gauge = gauges.get("cluster/imbalance", max(obs) / (W / P))
    est_err = gauges.get("cluster/load/estimation_error", 0.0)
    terms = [
        LossTerm("imbalance", loss(d_imb), d_imb,
                 "shard load skew + round granularity "
                 f"(max/mean = {imb_gauge:.2f})",
                 {"cluster/imbalance": imb_gauge,
                  "cluster/makespan_trips": makespan}),
        LossTerm("estimation", loss(d_est), d_est,
                 "skew the Thm 6.1 sample did not predict "
                 f"(est max share {est_max_share:.3f} vs obs "
                 f"{obs_max_share:.3f})",
                 {"cluster/load/estimation_error": est_err}),
        LossTerm("exchange", loss(d_exchange), d_exchange,
                 "Phase-3 all_to_all transaction exchange",
                 {"cluster/phase_ms/exchange": d_exchange}),
        LossTerm("compile", loss(d_compile), d_compile,
                 "round-0 warm-up above the steady per-trip rate (kernel "
                 "library load, caching-allocator growth)",
                 {"cluster/round0/mine_ms": r0_ms}),
        LossTerm("host_tail", loss(d_host), d_host,
                 "serial host work: plan + merge + store assembly",
                 {f"cluster/phase_ms/{p}": phase.get(p, 0.0)
                  for p in _HOST_PHASES if p in phase}),
    ]
    if d_driver > 0:
        terms.append(LossTerm(
            "driver", loss(d_driver), d_driver,
            "wall time outside every recorded phase", {}))
    return Waterfall(
        P=P, ideal_x=float(P), measured_x=P * t_ideal / TP,
        wall_ms=TP, ideal_ms=t_ideal, terms=terms, source="run",
    )


def from_run(run: dict) -> Optional[Waterfall]:
    """Waterfall from a loaded run record (``runlog.load_run`` shape)."""
    metrics = run.get("metrics") or {}
    man = run.get("manifest") or {}
    wall = man.get("mine_wall_s")
    wall_ms = float(wall) * 1e3 if isinstance(wall, (int, float)) else None
    return from_snapshot(metrics, wall_ms=wall_ms)


# ---------------------------------------------------------------------------
# From BENCH_cluster.json curve entries
# ---------------------------------------------------------------------------


def from_bench_entries(entries: List[dict]) -> Dict[int, Waterfall]:
    """The coarse two-term decomposition per curve point (see module doc).

    Uses the P=1 entry's makespan as the serial baseline; each P>1 entry
    splits its gap exactly into work inflation (replication + round
    granularity growing ``Σ obs`` with P) and load imbalance
    (``max/mean``).  Keyed by P.
    """
    curve = [e for e in entries
             if e.get("name") == "cluster_speedup"
             and isinstance(e.get("makespan_trips"), (int, float))]
    base = next((e for e in curve if e.get("P") == 1), None)
    if base is None:
        return {}
    base_mk = float(base["makespan_trips"])
    out: Dict[int, Waterfall] = {}
    for e in curve:
        P = int(e.get("P", 0))
        mk = float(e["makespan_trips"])
        if P <= 1 or mk <= 0:
            continue
        S = base_mk / mk
        imb = float(e.get("imbalance", 1.0))
        s_balanced = S * imb            # speedup if max == mean at same work
        terms = [
            LossTerm("inflation", P - s_balanced, 0.0,
                     "work growth with P: replication + round granularity",
                     {"makespan_trips": mk, "base_makespan_trips": base_mk}),
            LossTerm("imbalance", s_balanced - S, 0.0,
                     f"shard load skew (max/mean = {imb:.2f})",
                     {"imbalance": imb}),
        ]
        out[P] = Waterfall(
            P=P, ideal_x=float(P), measured_x=S,
            wall_ms=float(e.get("wall_s", 0.0)) * 1e3, ideal_ms=0.0,
            terms=terms, source="bench",
        )
    return out


def bench_loss_keys(entries: List[dict]) -> Dict[str, float]:
    """Flat ``loss_*`` keys for BENCH_cluster.json / the perf ledger.

    ``loss_imbalance_x_p4 = 0.7`` reads "0.7× of speedup lost to imbalance
    at P=4" — lower is better, which :mod:`repro_torch.obs.perfdb` infers from
    the ``loss`` prefix, so the trajectory ledger tracks *why* speedup
    moves, not just that it moved.
    """
    out: Dict[str, float] = {}
    for P, wf in sorted(from_bench_entries(entries).items()):
        for t in wf.terms:
            out[f"loss_{t.name}_x_p{P}"] = round(t.loss_x, 6)
        # "loss_total", not "speedup_gap": the "speedup" substring would
        # flip the perfdb direction inference to higher-is-better
        out[f"loss_total_x_p{P}"] = round(wf.gap_x, 6)
    return out

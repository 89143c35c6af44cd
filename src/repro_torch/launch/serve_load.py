"""Arrival-process load harness for the serving front end, SLO-gated.

The port of the JAX package's ``launch/serve_load.py``, with the same flags,
workload and gate.  Drives :class:`repro_torch.serve.service.MiningService`
with the traffic a production deployment faces: **open-loop Poisson
arrivals** at a target QPS (optionally a **closed loop** of concurrent
callers), **Zipf-hot** query popularity, and a **drifting hot set** (the
popular queries rotate every ``--drift-every`` seconds).  While the service
runs, a live dashboard repaints the last-W-seconds view — windowed
p50/p95/p99, QPS, shed rate, error-budget burn rate, queue depth,
per-replica lanes — from the :class:`repro_torch.obs.slo.SLOTracker` the
service feeds.  Every flush is one subset/superset sweep a kind (kernel B4
on the card).  Runs on the card unless ``--device cpu`` is given; without
CUDA and without that flag it raises.

Phases: **warm** (every query kind once, off the clock) → **ramp** (arrival
rate climbs linearly to the target) → **measure**.  The gate (``--gate``)
exits non-zero iff the measured phase violated the SLO: any burn-rate or
latency alert fired, or the final windowed p99 exceeds the objective.
Alerts also land as trace instants and run-record events (``--trace DIR``
makes the whole run a Perfetto timeline in which each request id threads
enqueue → assemble → sweep → respond).

SLO keys are merged into ``--bench-out`` (default ``BENCH_torch_serve.json``
in the working directory; ``''`` skips), and a gated run appends one row to
the port's history, ``BENCH_torch_HISTORY.jsonl`` in the working directory.
``--compare-dispatch`` also measures micro-batched against per-query
dispatch throughput over the same workload and records the speedup.

  python -m repro_torch.launch.serve_load --qps 200 --duration 10 --replicas 2 \\
      [--closed 8] [--gate] [--trace DIR] [--no-dashboard] [--device cpu]

The injected-overload self-test: a target far past capacity with a small
queue must shed, burn the error budget, fire the alert, and exit non-zero::

  python -m repro_torch.launch.serve_load --qps 50000 --max-queue 64 --gate
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import threading
import time
from typing import Callable, List, Optional, Sequence

import numpy as np

from repro_torch import device as device_mod
from repro_torch.core import eclat
from repro_torch.core.rules import pack_itemsets
from repro_torch.data.ibm_gen import generate_dense, params_from_name
from repro_torch.obs import perfdb
from repro_torch.obs import trace as obs_trace
from repro_torch.obs.session import add_obs_flags, start_session
from repro_torch.obs.slo import SLOPolicy, SLOStatus, SLOTracker
from repro_torch.serve import MiningService, QueryCache, QueryEngine
from repro_torch.serve.index import build_indexes

KINDS = ("support", "rules", "superset")
KIND_MIX = (0.5, 0.3, 0.2)


# ---------------------------------------------------------------------------
# workload: Zipf-hot pools per kind, hot set drifting over time
# ---------------------------------------------------------------------------


class Workload:
    """Zipf-ranked query pools whose hot head rotates while serving runs.

    ``draw(now)`` picks a kind by the fixed mix and a pool rank by a Zipf
    law, then shifts the rank → pool-slot mapping by the drift offset
    ``(now - t0) // drift_every`` — the identity of the hot queries
    changes over time (cache churn), the regime a windowed view exists for.
    """

    def __init__(self, rng, pools, zipf_a: float = 1.3,
                 drift_every: float = 10.0, drift_step: int = 7):
        self.rng = rng
        self.pools = pools                       # {kind: uint32[P, IW]}
        self.zipf_a = zipf_a
        self.drift_every = drift_every
        self.drift_step = drift_step
        self.t0 = time.monotonic()

    def draw(self, now: Optional[float] = None):
        now = time.monotonic() if now is None else now
        kind = KINDS[self.rng.choice(len(KINDS), p=KIND_MIX)]
        pool = self.pools[kind]
        n = pool.shape[0]
        rank = min(int(self.rng.zipf(self.zipf_a)) - 1, n - 1)
        shift = int((now - self.t0) / self.drift_every) * self.drift_step
        return kind, pool[(rank + shift) % n]


def build_pools(rng, fis, dense, n_items, pool: int = 64):
    """Per-kind query pools over the mined index (cf. serve_mine): uint32
    masks, the reference's draws in the reference's order."""
    fi_list = sorted(fis, key=lambda s: (len(s), tuple(sorted(s))))
    cand = [fi_list[i] for i in rng.choice(
        len(fi_list), size=min(pool, len(fi_list)), replace=False)]
    probes = [
        frozenset(rng.choice(n_items, size=min(6, n_items),
                             replace=False).tolist())
        for _ in range(max(pool // 8, 1))
    ]
    rows = rng.choice(dense.shape[0], size=min(pool, dense.shape[0]),
                      replace=False)
    baskets = [frozenset(np.nonzero(dense[t])[0].tolist()) for t in rows]
    small = [s for s in fi_list if len(s) <= 2] or fi_list[:1]
    prefixes = [small[i] for i in rng.choice(
        len(small), size=min(pool, len(small)), replace=False)]
    return {
        "support": pack_itemsets(cand + probes, n_items),
        "rules": pack_itemsets(baskets, n_items),
        "superset": pack_itemsets(prefixes, n_items),
    }


# ---------------------------------------------------------------------------
# dashboard
# ---------------------------------------------------------------------------


class Dashboard:
    """Live refreshing operator panel (ANSI repaint on a tty, plain lines
    otherwise)."""

    def __init__(self, enabled: bool, out=sys.stdout):
        self.enabled = enabled
        self.out = out
        self.repaint = enabled and out.isatty()
        self._last_lines = 0

    @staticmethod
    def _ms(v) -> str:
        return f"{v:6.1f}" if v is not None else "     -"

    def render(self, t: float, phase: str, status, svc, policy) -> None:
        if not self.enabled:
            return
        st = svc.stats()
        alert = "ALERT" if status.alert_active else "ok"
        lines = [
            f"serve_load  t={t:6.1f}s  phase={phase:<7}  "
            f"gen={st['generation']}  slo={alert}",
            f"  window {status.window_s:.0f}s: "
            f"qps={status.qps:8.1f} (offered {status.offered_qps:8.1f})  "
            f"p50={self._ms(status.p50_ms)} p95={self._ms(status.p95_ms)} "
            f"p99={self._ms(status.p99_ms)}ms (obj {policy.p99_ms:.0f}ms)",
            f"  shed={status.shed_rate:6.2%}  "
            f"burn={status.burn_rate:6.2f} "
            f"(fire>={policy.burn_hi:.1f} clear<{policy.burn_lo:.1f})  "
            f"queue={st['queue_depth']}/{st['max_queue']}  "
            f"flushes={st['flushes']}  shed_total={st['shed']}",
        ]
        per_flush = st["per_replica_flushes"]
        per_req = st["per_replica_requests"]
        peak = max(per_flush) or 1
        lanes = "  ".join(
            f"r{i} {'▇' * max(1, round(6 * f / peak))} "
            f"{f} flushes/{q} reqs"
            for i, (f, q) in enumerate(zip(per_flush, per_req))
        )
        lines.append(f"  replica lanes: {lanes}")
        if self.repaint and self._last_lines:
            self.out.write(f"\x1b[{self._last_lines}F\x1b[J")
        self.out.write("\n".join(lines) + "\n")
        self.out.flush()
        self._last_lines = len(lines) if self.repaint else 0


# ---------------------------------------------------------------------------
# traffic generators
# ---------------------------------------------------------------------------


def open_loop(svc, workload, rng, t_end: float, rate_fn, tickets: list,
              stop: threading.Event) -> None:
    """Poisson arrivals: exponential gaps at the (ramping) target rate."""
    next_t = time.monotonic()
    while not stop.is_set():
        now = time.monotonic()
        if now >= t_end:
            break
        if now < next_t:
            time.sleep(min(next_t - now, 0.25))
            continue
        kind, mask = workload.draw(now)
        tickets.append(svc.submit(kind, mask))
        # the NEXT arrival's gap — drawn only after an arrival fires
        rate = max(rate_fn(now), 1e-3)
        next_t += rng.exponential(1.0 / rate)
        if next_t < now - 1.0:      # fell behind (stall): don't burst-spiral
            next_t = now


def closed_loop(svc, workload, n_workers: int, t_end: float,
                tickets: list, stop: threading.Event) -> List[threading.Thread]:
    """N concurrent callers, each submit → wait → repeat (think-time 0)."""
    lock = threading.Lock()

    def worker(seed: int):
        rng = np.random.default_rng(seed)
        wl = Workload(rng, workload.pools, workload.zipf_a,
                      workload.drift_every, workload.drift_step)
        wl.t0 = workload.t0
        while not stop.is_set() and time.monotonic() < t_end:
            kind, mask = wl.draw()
            t = svc.submit(kind, mask)
            with lock:
                tickets.append(t)
            try:
                t.result(timeout=10.0)
            except TimeoutError:
                return
    threads = [threading.Thread(target=worker, args=(1000 + i,), daemon=True)
               for i in range(n_workers)]
    for t in threads:
        t.start()
    return threads


# ---------------------------------------------------------------------------
# micro-batch vs per-query dispatch comparison (same harness, same queries)
# ---------------------------------------------------------------------------


def compare_dispatch(engine, workload, n: int = 256) -> dict:
    """Throughput of flush-width sweeps vs per-query dispatch.

    Every engine call pads to the engine width, so both sides run the SAME
    sweep shape — the difference measured is purely amortization.
    """
    draws = [workload.draw() for _ in range(n)]
    by_kind = {k: np.stack([m for kk, m in draws if kk == k])
               for k in KINDS if any(kk == k for kk, _ in draws)}
    call = {"support": engine.support, "rules": engine.rules_for,
            "superset": engine.supersets}
    B = engine.batch
    for k, masks in by_kind.items():        # warm every kind
        call[k](masks[:B])
    t0 = time.perf_counter()
    for k, masks in by_kind.items():
        for off in range(0, masks.shape[0], B):
            call[k](masks[off:off + B])
    batched_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    for k, masks in by_kind.items():
        for i in range(masks.shape[0]):
            call[k](masks[i: i + 1])
    per_query_s = time.perf_counter() - t0
    return {
        "n": n,
        "batched_qps": n / batched_s,
        "per_query_qps": n / per_query_s,
        "speedup": per_query_s / batched_s,
    }


# ---------------------------------------------------------------------------
# BENCH file merge
# ---------------------------------------------------------------------------


def merge_bench(path: str, keys: dict) -> None:
    """Fold ``slo_*`` keys into the (possibly existing) serve BENCH file.

    A provenance ``meta`` block (git SHA / backend / ts) already in the file
    is preserved, and stamped fresh when the load harness writes the file
    first — either way the merged file stays attributable.
    """
    data = {"bench": "serve"}
    if os.path.exists(path):
        try:
            with open(path) as f:
                data = json.load(f)
        except (OSError, json.JSONDecodeError):
            pass
    data.update(keys)
    if not isinstance(data.get("meta"), dict):
        data["meta"] = {"git_sha": perfdb.git_sha(), "backend": "",
                        "ts": perfdb.utc_stamp()}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f, indent=2)
        f.write("\n")
    os.replace(tmp, path)


# ---------------------------------------------------------------------------


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="SLO-gated load harness for the serving front end")
    ap.add_argument("--db", default="T0.5I0.024P8PL5TL8",
                    help="IBM synthetic DB name (mined by brute force — "
                         "small DBs; the harness exercises serving, not "
                         "mining)")
    ap.add_argument("--support", type=float, default=0.08)
    ap.add_argument("--minconf", type=float, default=0.3)
    ap.add_argument("--replicas", type=int, default=2)
    ap.add_argument("--batch", type=int, default=64,
                    help="engine dispatch width / max flush size")
    ap.add_argument("--deadline-ms", type=float, default=4.0,
                    dest="deadline_ms",
                    help="micro-batch deadline: max wait of the oldest "
                         "queued request")
    ap.add_argument("--max-queue", type=int, default=1024, dest="max_queue")
    ap.add_argument("--cache", type=int, default=2048,
                    help="service LRU capacity (0 disables)")
    ap.add_argument("--topk", type=int, default=5)
    ap.add_argument("--qps", type=float, default=200.0,
                    help="open-loop target arrival rate")
    ap.add_argument("--closed", type=int, default=0,
                    help="ALSO run a closed loop of N concurrent callers")
    ap.add_argument("--duration", type=float, default=10.0,
                    help="measured-phase seconds")
    ap.add_argument("--ramp", type=float, default=2.0,
                    help="seconds ramping arrival rate up to the target")
    ap.add_argument("--pool", type=int, default=64)
    ap.add_argument("--zipf", type=float, default=1.3)
    ap.add_argument("--drift-every", type=float, default=5.0,
                    dest="drift_every",
                    help="seconds between hot-set rotations")
    ap.add_argument("--window", type=float, default=5.0,
                    help="SLO sliding-window seconds")
    ap.add_argument("--slo-p99-ms", type=float, default=200.0,
                    dest="slo_p99_ms")
    ap.add_argument("--availability", type=float, default=0.99)
    ap.add_argument("--burn-hi", type=float, default=2.0, dest="burn_hi")
    ap.add_argument("--burn-lo", type=float, default=1.0, dest="burn_lo")
    ap.add_argument("--report-every", type=float, default=0.5,
                    dest="report_every")
    ap.add_argument("--no-dashboard", action="store_true",
                    dest="no_dashboard")
    ap.add_argument("--gate", action="store_true",
                    help="exit non-zero if the measured phase violated "
                         "the SLO (alert fired or final windowed p99 over "
                         "objective)")
    ap.add_argument("--compare-dispatch", action="store_true",
                    dest="compare_dispatch",
                    help="also measure micro-batched vs per-query dispatch "
                         "throughput")
    ap.add_argument("--bench-out", default="BENCH_torch_serve.json",
                    dest="bench_out",
                    help="BENCH file to merge slo_* keys into ('' skips)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    add_obs_flags(ap)
    return ap


@dataclasses.dataclass
class LoadRun:
    """What one load run produced; ``rc`` is the launcher's exit code."""

    rc: int
    svc: MiningService
    slo: SLOTracker
    final: SLOStatus                  # the closing windowed evaluation
    slo_keys: dict                    # what the BENCH file and history get
    tickets: list                     # every submission, in offer order
    measure_alerts: List[dict]        # alert fires inside the measured phase
    unresolved: int
    wall_s: float


def serve(args, fis, dense, fi_index, rule_index, *, obs=None,
          on_start: Optional[Callable[[MiningService], None]] = None) -> LoadRun:
    """Warm, ramp and measure a :class:`MiningService` of ``args.replicas``
    engines over the index pair, then gate and record.

    ``on_start(svc)`` runs once the service is built, before any traffic
    (a caller hooks its own instrumentation or a hot-swap thread there).
    """
    n_items = fi_index.n_items
    rng = np.random.default_rng(args.seed)
    policy = SLOPolicy(
        p99_ms=args.slo_p99_ms, availability=args.availability,
        window_s=args.window, burn_hi=args.burn_hi, burn_lo=args.burn_lo,
    )
    slo = SLOTracker(policy)
    tracer = obs_trace.tracer()

    def on_alert(ev):
        line = (f"[slo] {ev['kind']} ({ev['objective']})  "
                + "  ".join(f"{k}={v}" for k, v in ev.items()
                            if k not in ("kind", "objective", "slo", "t")))
        print(line, file=sys.stderr)
        tracer.instant(f"slo/{ev['kind']}", **{
            k: v for k, v in ev.items() if k != "t"})
        if obs:
            obs.event(ev["kind"], **{k: v for k, v in ev.items()
                                     if k != "kind"})

    slo.on_alert(on_alert)

    engines = [
        QueryEngine(fi_index, rule_index, batch=args.batch,
                    top_k=args.topk)
        for _ in range(args.replicas)
    ]
    cache = QueryCache(capacity=args.cache) if args.cache > 0 else None
    svc = MiningService(
        engines, max_batch=args.batch, deadline_ms=args.deadline_ms,
        max_queue=args.max_queue, slo=slo, cache=cache, auto_start=False,
    )

    pools = build_pools(rng, fis, dense, n_items, pool=args.pool)
    workload = Workload(rng, pools, zipf_a=args.zipf,
                        drift_every=args.drift_every)

    # ---- warm (every kind once, off the clock) ------------------------------
    t0 = time.time()
    for kind in KINDS:
        m = pools[kind][:1]
        eng_call = {"support": engines[0].support,
                    "rules": engines[0].rules_for,
                    "superset": engines[0].supersets}[kind]
        eng_call(np.broadcast_to(m, (args.batch,) + m.shape[1:]))
        eng_call(m)
    print(f"warm: ran {len(KINDS)} query kinds in {time.time()-t0:.2f}s")
    if on_start is not None:
        on_start(svc)

    # ---- drive --------------------------------------------------------------
    svc.start()
    dash = Dashboard(enabled=not args.no_dashboard)
    stop = threading.Event()
    tickets: list = []
    t_start = time.monotonic()
    t_measure0 = t_start + args.ramp
    t_end = t_measure0 + args.duration

    def rate_fn(now: float) -> float:
        if args.ramp <= 0 or now >= t_measure0:
            return args.qps
        frac = (now - t_start) / args.ramp
        return args.qps * (0.25 + 0.75 * frac)

    arr = threading.Thread(
        target=open_loop,
        args=(svc, workload, np.random.default_rng(args.seed + 1), t_end,
              rate_fn, tickets, stop),
        daemon=True,
    )
    arr.start()
    closed_threads = []
    if args.closed > 0:
        closed_threads = closed_loop(svc, workload, args.closed, t_end,
                                     tickets, stop)

    while time.monotonic() < t_end:
        time.sleep(args.report_every)
        now = time.monotonic()
        phase = "ramp" if now < t_measure0 else "measure"
        status = slo.evaluate()   # alert callback handles transitions
        dash.render(now - t_start, phase, status, svc, policy)
    stop.set()
    arr.join(timeout=5)
    for t in closed_threads:
        t.join(timeout=5)
    svc.stop(drain=True)

    # resolve every ticket (sheds resolved at submit; the rest at flush)
    unresolved = sum(1 for t in tickets if not t.done())
    final = slo.evaluate()
    dash.render(time.monotonic() - t_start, "done", final, svc, policy)
    measure_alerts = slo.alerts_since(t_measure0)

    st = svc.stats()
    wall = time.monotonic() - t_start
    print(f"\nserve_load: {len(tickets)} offered in {wall:.1f}s "
          f"(target {args.qps:.0f} QPS, ramp {args.ramp:.0f}s + measure "
          f"{args.duration:.0f}s), {st['shed']} shed, {st['errors']} "
          f"errors, {unresolved} unresolved")
    p99 = final.p99_ms
    print(f"window[{policy.window_s:.0f}s]: qps={final.qps:.1f} "
          f"p50={final.p50_ms} p95={final.p95_ms} p99={p99} ms "
          f"(objective {policy.p99_ms}), shed_rate={final.shed_rate:.2%}, "
          f"burn={final.burn_rate:.2f}")
    print(f"alerts: {len(measure_alerts)} fired in measured phase "
          f"({len(slo.alerts)} transitions total)")

    cmp_stats = None
    if args.compare_dispatch:
        cmp_stats = compare_dispatch(engines[0], workload)
        print(f"dispatch: micro-batched {cmp_stats['batched_qps']:,.0f} QPS "
              f"vs per-query {cmp_stats['per_query_qps']:,.0f} QPS "
              f"-> {cmp_stats['speedup']:.1f}x")

    # ---- gate + artifacts ----------------------------------------------------
    p99_over = (p99 is not None and p99 > policy.p99_ms)
    violated = bool(measure_alerts) or p99_over or final.alert_active
    slo_keys = {
        "slo_target_qps": args.qps,
        "slo_window_s": policy.window_s,
        "slo_qps": final.qps,
        "slo_offered_qps": final.offered_qps,
        "slo_p50_ms": final.p50_ms,
        "slo_p95_ms": final.p95_ms,
        "slo_p99_ms": p99,
        "slo_p99_objective_ms": policy.p99_ms,
        "slo_shed_rate": final.shed_rate,
        "slo_shed_total": float(st["shed"]),
        "slo_burn_rate": final.burn_rate,
        "slo_alerts_fired": len(measure_alerts),
        "slo_gate_ok": not violated,
    }
    if cmp_stats is not None:
        slo_keys["slo_microbatch_speedup"] = cmp_stats["speedup"]
    if args.bench_out:
        merge_bench(args.bench_out, slo_keys)
        print(f"[merged {len(slo_keys)} slo_* keys into {args.bench_out}]")
    if args.gate:
        # gated launches feed the port's persistent perf trajectory too
        row = perfdb.append(perfdb.DEFAULT_PATH, "serve_load", slo_keys,
                            backend=fi_index.device.type)
        print(f"[history += serve_load: {len(row['keys'])} keys @ "
              f"{row['sha'] or '?'}]")
    if obs:
        obs.event("load_done", offered=len(tickets), shed=st["shed"],
                  alerts=len(measure_alerts))
        obs.finish(**{k: v for k, v in slo_keys.items()})

    rc = 0
    if args.gate and violated:
        why = []
        if measure_alerts:
            why.append(f"{len(measure_alerts)} SLO alert(s) fired")
        if p99_over:
            why.append(f"windowed p99 {p99:.1f}ms > {policy.p99_ms}ms")
        if final.alert_active:
            why.append("alert still active at end of run")
        print(f"SLO GATE FAILED: {'; '.join(why)}", file=sys.stderr)
        rc = 1
    elif args.gate:
        print("SLO gate: ok")
    return LoadRun(rc, svc, slo, final, slo_keys, tickets, measure_alerts, unresolved, wall)


def run(argv: Optional[Sequence[str]] = None) -> LoadRun:
    """The launcher: parse, index the named database (mined by brute force),
    serve under load."""
    args = build_parser().parse_args(argv)
    dev = device_mod.resolve(args.device)
    obs = start_session(args, "serve_load")
    dense = generate_dense(params_from_name(args.db, seed=args.seed))
    n_tx, n_items = dense.shape
    fis = eclat.brute_force_fis(dense, int(np.ceil(args.support * n_tx)))
    fi_index, rule_index = build_indexes(fis, n_items, n_tx, min_confidence=args.minconf,
                                         device=dev)
    print(f"index: db={args.db} |D|={n_tx} |B|={n_items} "
          f"F={fi_index.n_fis} R={rule_index.n_rules}")
    return serve(args, fis, dense, fi_index, rule_index, obs=obs)


def main(argv: Optional[Sequence[str]] = None) -> int:
    return run(argv).rc


if __name__ == "__main__":
    sys.exit(main())

"""Span-DAG reconstruction and critical-path analysis over ``trace.json``.

The port's copy of the JAX package's ``obs/critpath.py``, with the same
behaviour, so one analysis reads a run record of either package.

"Where did the wall clock go" gets one canonical answer here.  The tracer
(:mod:`repro_torch.obs.trace`) exports flat Chrome trace events; this module
rebuilds the structure those events imply and walks it:

  * **Nesting** — per track (tid), a span is the child of the innermost
    span whose interval contains it: exactly how Perfetto stacks them.
  * **Cross-track containment** — spans recorded on *other* tracks
    (the executor's modeled per-shard mining lanes, the store's prefetch
    worker thread) attach to the innermost main-track span that temporally
    contains them, so a ``cluster/mine`` round owns its shard lanes and a
    ``fimi/assemble_store`` span owns the prefetch reads that served it.
    Instants (``cluster/donate`` donations, ``stream/drift`` triggers,
    swap markers) attach to their enclosing span as annotations — the
    cross-track evidence the doctor's rules cite.
  * **Exclusive self-time** — ``span.dur − union(child intervals)``:
    long parents (``phase4``) stop masking their children.  Children on
    parallel tracks overlap each other, so the subtraction uses the merged
    interval union, never a naive sum.
  * **Critical path** — from a virtual root covering the whole trace,
    repeatedly descend into the chain of children that were *last active*
    walking backwards in time.  Parallel siblings (shard lanes) resolve to
    the straggler; the time a parent spent with no selected child active
    is its own on-path self-time; gaps between top-level spans surface as
    the virtual root's self-time (``(untraced)``).

Stdlib-only (the ``obs_report`` layering rule): input is the already-loaded
trace dict of a run record.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

#: slack (us) when testing containment: modeled lanes are stamped with a
#: ``t0`` taken just before the enclosing span entered, and clocks are
#: microsecond-rounded — a strict test would orphan them.
_EPS_US = 2_000.0

#: the aggregate row name for time inside no span at all (driver glue,
#: argument parsing, everything the tracer never saw).
UNTRACED = "(untraced)"


@dataclasses.dataclass
class SpanNode:
    """One complete ("ph": "X") event, placed in the reconstructed DAG."""

    name: str
    track: str               # thread/virtual-track name ("" when unnamed)
    tid: int
    t0: float                # us, trace timebase
    dur: float               # us
    args: dict
    order: int = 0           # position in the event stream (tie-breaks)
    children: List["SpanNode"] = dataclasses.field(default_factory=list)
    parent: Optional["SpanNode"] = None
    instants: List[dict] = dataclasses.field(default_factory=list)

    @property
    def end(self) -> float:
        return self.t0 + self.dur

    def exclusive_us(self) -> float:
        """dur minus the merged union of child intervals (clipped to self)."""
        covered = _union_len(
            [(max(c.t0, self.t0), min(c.end, self.end)) for c in self.children]
        )
        return max(0.0, self.dur - covered)


@dataclasses.dataclass
class SpanDag:
    """The reconstructed forest plus the virtual root spanning the trace."""

    nodes: List[SpanNode]
    root: SpanNode           # virtual: name == UNTRACED, covers [min, max]
    tracks: Dict[int, str]

    @property
    def wall_us(self) -> float:
        return self.root.dur


@dataclasses.dataclass
class PathSeg:
    """One span on the critical path, with its on-path self contribution."""

    name: str
    track: str
    depth: int
    t0_us: float
    dur_us: float
    self_us: float           # dur minus the selected (on-path) children
    args: dict


def _union_len(intervals: Sequence[Tuple[float, float]]) -> float:
    """Total length of the union of (start, end) intervals."""
    ivs = sorted((a, b) for a, b in intervals if b > a)
    total = 0.0
    cur_a = cur_b = None
    for a, b in ivs:
        if cur_b is None or a > cur_b:
            if cur_b is not None:
                total += cur_b - cur_a
            cur_a, cur_b = a, b
        elif b > cur_b:
            cur_b = b
    if cur_b is not None:
        total += cur_b - cur_a
    return total


def _contains(outer: SpanNode, inner: SpanNode, eps: float = _EPS_US) -> bool:
    return (
        outer.t0 - eps <= inner.t0
        and inner.end <= outer.end + eps
        and outer.dur >= inner.dur - eps
    )


def build(trace: Optional[dict]) -> Optional[SpanDag]:
    """Reconstruct the span DAG of one exported Chrome trace (None if empty).

    Accepts the dict shape :meth:`repro_torch.obs.trace.Tracer.export` writes;
    tolerates missing metadata and unordered events.
    """
    if not trace:
        return None
    events = trace.get("traceEvents") or []
    tracks: Dict[int, str] = {}
    spans: List[SpanNode] = []
    instants: List[dict] = []
    for ev in events:
        ph = ev.get("ph")
        if ph == "M" and ev.get("name") == "thread_name":
            tracks[ev.get("tid", 0)] = (ev.get("args") or {}).get("name", "")
        elif ph == "X":
            spans.append(SpanNode(
                name=str(ev.get("name", "?")),
                track="",
                tid=int(ev.get("tid", 0)),
                t0=float(ev.get("ts", 0.0)),
                dur=max(0.0, float(ev.get("dur", 0.0))),
                args=dict(ev.get("args") or {}),
                order=len(spans),
            ))
        elif ph == "i":
            instants.append(ev)
    if not spans:
        return None
    for s in spans:
        s.track = tracks.get(s.tid, f"tid{s.tid}")

    # --- per-track nesting (innermost containing span on the same tid) -----
    by_tid: Dict[int, List[SpanNode]] = {}
    for s in spans:
        by_tid.setdefault(s.tid, []).append(s)
    for tid_spans in by_tid.values():
        # enter-order with ties broken outermost-first; a stack of open
        # spans gives each its innermost container
        tid_spans.sort(key=lambda s: (s.t0, -s.dur))
        stack: List[SpanNode] = []
        for s in tid_spans:
            while stack and not _contains(stack[-1], s, eps=0.5):
                stack.pop()
            if stack:
                s.parent = stack[-1]
                stack[-1].children.append(s)
            stack.append(s)

    # --- cross-track containment: attach orphan roots of other tracks ------
    roots = [s for s in spans if s.parent is None]
    # candidates a foreign root may attach to, innermost (shortest) first.
    # The eps slack makes near-equal intervals contain each other BOTH
    # ways (the executor's straggler lane vs the main-track mine span it
    # mirrors exactly) — resolve mutual containment asymmetrically: the
    # longer span is the parent; on equal durations the earlier-recorded
    # one wins, never the reverse (a lane must not adopt its host).
    def _may_adopt(cand: SpanNode, r: SpanNode) -> bool:
        if not _contains(cand, r):
            return False
        if not _contains(r, cand):
            return True
        if cand.dur != r.dur:
            return cand.dur > r.dur
        return cand.order < r.order

    for r in roots:
        best: Optional[SpanNode] = None
        for cand in spans:
            if cand.tid == r.tid or _in_subtree(cand, r):
                continue
            if _may_adopt(cand, r) and (best is None or cand.dur < best.dur):
                best = cand
        if best is not None:
            r.parent = best
            best.children.append(r)

    # --- instants annotate the innermost enclosing span --------------------
    for ev in instants:
        ts = float(ev.get("ts", 0.0))
        tid = int(ev.get("tid", 0))
        host: Optional[SpanNode] = None
        for s in spans:
            if s.tid == tid and s.t0 <= ts <= s.end \
                    and (host is None or s.dur < host.dur):
                host = s
        if host is not None:
            host.instants.append(ev)

    # --- the virtual root: whole-trace interval over the real roots --------
    roots = [s for s in spans if s.parent is None]
    t_lo = min(s.t0 for s in spans)
    t_hi = max(s.end for s in spans)
    root = SpanNode(
        name=UNTRACED, track="", tid=-1,
        t0=t_lo, dur=max(0.0, t_hi - t_lo), args={},
    )
    root.children = sorted(roots, key=lambda s: s.t0)
    for r in roots:
        r.parent = root
    return SpanDag(nodes=spans, root=root, tracks=tracks)


def _in_subtree(node: SpanNode, ancestor: SpanNode) -> bool:
    cur: Optional[SpanNode] = node
    while cur is not None:
        if cur is ancestor:
            return True
        cur = cur.parent
    return False


# ---------------------------------------------------------------------------
# Exclusive self-time (the summary's new column)
# ---------------------------------------------------------------------------


def exclusive_totals(dag: SpanDag) -> Dict[str, Dict[str, float]]:
    """Per-name inclusive/exclusive totals over the whole DAG.

    ``{name: {"total_ms", "self_ms", "count"}}`` — the single
    implementation both ``obs_report summary`` and the doctor use, so the
    two never disagree about what a span's own time is.
    """
    out: Dict[str, Dict[str, float]] = {}
    for s in dag.nodes:
        row = out.setdefault(
            s.name, {"total_ms": 0.0, "self_ms": 0.0, "count": 0}
        )
        row["total_ms"] += s.dur / 1e3
        row["self_ms"] += s.exclusive_us() / 1e3
        row["count"] += 1
    return out


# ---------------------------------------------------------------------------
# Critical path
# ---------------------------------------------------------------------------


def _select_chain(node: SpanNode) -> List[SpanNode]:
    """The children that were last-active, walking backwards through node.

    Starting at ``node.end``, repeatedly take the child that ends latest at
    or before the cursor, then jump the cursor to that child's start.
    Parallel siblings fully shadowed by a later-ending sibling (the faster
    shard lanes under the straggler) never get selected — they are slack,
    not critical.  Returns the selected children in time order.
    """
    sel: List[SpanNode] = []
    cursor = node.end + 1.0          # tolerate child.end == node.end
    for c in sorted(node.children, key=lambda c: -c.end):
        if c.end <= cursor:
            sel.append(c)
            cursor = c.t0
    return list(reversed(sel))


def critical_path(dag: SpanDag) -> List[PathSeg]:
    """The critical path as a depth-annotated pre-order list of segments.

    Each segment's ``self_us`` is its duration minus the selected on-path
    children — so ``sum(self_us)`` accounts the full wall clock with
    nothing double-counted (up to the microsecond attach slack of
    cross-track children).
    """
    segs: List[PathSeg] = []

    def walk(node: SpanNode, depth: int) -> None:
        chain = _select_chain(node)
        covered = sum(
            max(0.0, min(c.end, node.end) - max(c.t0, node.t0))
            for c in chain
        )
        self_us = max(0.0, node.dur - covered)
        segs.append(PathSeg(
            name=node.name, track=node.track, depth=depth,
            t0_us=node.t0, dur_us=node.dur, self_us=self_us,
            args=node.args,
        ))
        for c in chain:
            walk(c, depth + 1)

    walk(dag.root, 0)
    return segs


def path_table(
    segs: List[PathSeg], top_n: int = 10
) -> List[Dict[str, object]]:
    """Aggregate on-path self-time by span name, largest first.

    The top-N answer to "where did the wall clock go": every row carries
    the share of the total wall it was critical for.
    """
    total = sum(s.self_us for s in segs) or 1.0
    acc: Dict[str, Dict[str, float]] = {}
    for s in segs:
        row = acc.setdefault(
            s.name, {"self_ms": 0.0, "count": 0, "tracks": set()}
        )
        row["self_ms"] += s.self_us / 1e3
        row["count"] += 1
        if s.track:
            row["tracks"].add(s.track)
    rows = [
        {
            "name": name,
            "self_ms": r["self_ms"],
            "count": int(r["count"]),
            "share": r["self_ms"] * 1e3 / total,
            "tracks": ",".join(sorted(r["tracks"])),
        }
        for name, r in acc.items()
    ]
    rows.sort(key=lambda r: (-r["self_ms"], r["name"]))
    return rows[:top_n]


def analyze(trace: Optional[dict], top_n: int = 10) -> Optional[dict]:
    """One-call digest: DAG + critical path + tables, plain-dict shaped.

    ``{"wall_ms", "path": [seg dicts], "table": [...], "exclusive": {...}}``
    — what ``obs_report critpath``/``doctor`` render and tests assert on.
    Returns None when the trace has no complete spans.
    """
    dag = build(trace)
    if dag is None:
        return None
    segs = critical_path(dag)
    return {
        "wall_ms": dag.wall_us / 1e3,
        "path": [
            {
                "name": s.name, "track": s.track, "depth": s.depth,
                "t0_ms": s.t0_us / 1e3, "dur_ms": s.dur_us / 1e3,
                "self_ms": s.self_us / 1e3,
            }
            for s in segs
        ],
        "table": path_table(segs, top_n),
        "exclusive": exclusive_totals(dag),
    }

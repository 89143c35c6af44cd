"""Round-granular checkpoints of the distributed mining executor.

The port keeps the JAX package's format (``cluster-ckpt-v1``: the same
``CHECKPOINT.json``, the same ``round_NNNNNN.npz`` payload, the same CRC32C
and the same plan fingerprint), so a checkpoint written by either package
resumes in the other.

A multi-round distributed mine is a long-running job; the paper's contract
is an *exact* FITable, so a mid-run death must not force a silent partial
result or a full restart.  The executor's state between rounds is small
and entirely host-side — the FIs merged so far, the per-shard class queues
(post-donation), the load ledger's rates, the overflow counters, and the
round index — so after every ``all_to_all``/Phase-4 round it can be
persisted in one atomic step and a resumed run replays the remaining
rounds **bit-exactly**: round ``r``'s PRNG keys are derived from the round
index, the chunk width is a pure function of the plan, and donations are a
deterministic function of the ledger, all of which the checkpoint carries.

Disk layout (reusing the store's atomic-manifest pattern)::

    ckpt/
      CHECKPOINT.json        # tiny: round, payload name, CRC32C, plan hash
      round_000003.npz       # the arrays (published before the json points
                             # at it; older payloads deleted after publish)

The payload is guarded by the same CRC32C as store blocks, and the
``plan_hash`` — a SHA-256 fingerprint of the :class:`MiningPlan`'s
semantic content — refuses a resume against a different database, support
threshold, shard count, or schedule: a checkpoint is only ever replayed
into the exact run that wrote it.
"""
from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from typing import List, Optional

import numpy as np

from repro_torch.cluster.rebalance import Donation
from repro_torch.store.checksum import crc32c

META_NAME = "CHECKPOINT.json"
FORMAT = "cluster-ckpt-v1"


class CheckpointError(RuntimeError):
    """A checkpoint is unreadable, corrupt, or belongs to a different run."""


def plan_fingerprint(plan) -> str:
    """SHA-256 over the plan's semantic content (not its object identity).

    Two plans with the same fingerprint schedule the same classes of the
    same database at the same support onto the same shards — the
    precondition for a checkpoint to be replayable.
    """
    h = hashlib.sha256()
    h.update(
        f"{FORMAT}|{plan.n_items}|{plan.n_tx}|{plan.P}|{plan.abs_minsup}|"
        f"{plan.scheduler_used}|{len(plan.classes)}".encode()
    )
    for c in plan.classes:
        h.update(np.packbits(np.asarray(c.prefix, bool)).tobytes())
        h.update(np.packbits(np.asarray(c.ext, bool)).tobytes())
    h.update(np.asarray(plan.est_sizes, np.float64).tobytes())
    h.update(np.asarray(plan.assignment, np.int64).tobytes())
    h.update(np.packbits(np.asarray(plan.ancestor_masks, bool)).tobytes())
    return h.hexdigest()


@dataclasses.dataclass
class RoundState:
    """Everything ``execute`` accumulates across rounds (host-side only)."""

    round_index: int                    # rounds completed so far
    queues: List[List[int]]             # per-shard pending class ids
    fi_masks: np.ndarray                # uint32 [F, IW] merged so far
    fi_supports: np.ndarray             # int64 [F]
    anc_supports: Optional[np.ndarray]  # int64 [A] (None before round 0)
    observed: np.ndarray                # ledger: float [P]
    est_mined: np.ndarray               # ledger: float [P]
    exchange_overflow: int
    mine_overflow: int
    rounds: List["object"]              # executor RoundStats telemetry
    donations: List[Donation]


def _rounds_to_json(rounds) -> list:
    return [
        dict(
            round_index=r.round_index,
            classes_mined=[int(x) for x in r.classes_mined],
            work_iters=np.asarray(r.work_iters).astype(np.int64).tolist(),
            est_mined=np.asarray(r.est_mined).astype(float).tolist(),
            replication=float(r.replication),
            donations=[list(d) for d in r.donations],
            mine_ms=float(getattr(r, "mine_ms", 0.0)),
        )
        for r in rounds
    ]


def _rounds_from_json(data: list) -> list:
    from repro_torch.cluster.executor import RoundStats

    return [
        RoundStats(
            round_index=int(d["round_index"]),
            classes_mined=[int(x) for x in d["classes_mined"]],
            work_iters=np.asarray(d["work_iters"], np.int64),
            est_mined=np.asarray(d["est_mined"], np.float64),
            replication=float(d["replication"]),
            donations=[
                Donation(*map(int, t)) for t in d["donations"]
            ],
            mine_ms=float(d.get("mine_ms", 0.0)),
        )
        for d in data
    ]


def save(directory: str, state: RoundState, plan_hash: str) -> str:
    """Persist one round's state atomically; returns the payload path.

    Publish order is payload-then-pointer: the ``.npz`` lands fully (via
    temp + ``os.replace``) before ``CHECKPOINT.json`` names it, so a crash
    at any instant leaves either the previous checkpoint or the new one —
    never a pointer to a torn payload.  Older payloads are deleted after
    the pointer moves.
    """
    os.makedirs(directory, exist_ok=True)
    name = f"round_{state.round_index:06d}.npz"
    path = os.path.join(directory, name)
    tmp = path + ".tmp.npz"
    flat = [cid for q in state.queues for cid in q]
    qlens = [len(q) for q in state.queues]
    with open(tmp, "wb") as f:
        np.savez(
            f,
            fi_masks=np.asarray(state.fi_masks, np.uint32),
            fi_supports=np.asarray(state.fi_supports, np.int64),
            anc_supports=(
                np.zeros(0, np.int64) if state.anc_supports is None
                else np.asarray(state.anc_supports, np.int64)
            ),
            has_anc=np.asarray([state.anc_supports is not None]),
            queue_flat=np.asarray(flat, np.int64),
            queue_lens=np.asarray(qlens, np.int64),
            observed=np.asarray(state.observed, np.float64),
            est_mined=np.asarray(state.est_mined, np.float64),
        )
    os.replace(tmp, path)
    with open(path, "rb") as f:
        payload_crc = crc32c(np.frombuffer(f.read(), np.uint8))
    meta = dict(
        format=FORMAT,
        round=state.round_index,
        payload=name,
        payload_crc32c=payload_crc,
        plan_hash=plan_hash,
        exchange_overflow=int(state.exchange_overflow),
        mine_overflow=int(state.mine_overflow),
        rounds=_rounds_to_json(state.rounds),
        donations=[list(d) for d in state.donations],
    )
    meta_path = os.path.join(directory, META_NAME)
    meta_tmp = meta_path + ".tmp"
    with open(meta_tmp, "w") as f:
        json.dump(meta, f, indent=1)
        f.write("\n")
    os.replace(meta_tmp, meta_path)
    for other in os.listdir(directory):
        if other.startswith("round_") and other.endswith(".npz") \
                and other != name:
            os.remove(os.path.join(directory, other))
    return path


def load(directory: str, plan_hash: Optional[str] = None
         ) -> Optional[RoundState]:
    """Read the latest checkpoint, or None if the directory holds none.

    Verifies the payload CRC32C and (when given) the plan fingerprint;
    raises :class:`CheckpointError` on corruption or a cross-run mismatch
    rather than resuming into a wrong — and therefore inexact — state.
    """
    meta_path = os.path.join(directory, META_NAME)
    if not os.path.exists(meta_path):
        return None
    try:
        with open(meta_path) as f:
            meta = json.load(f)
    except (OSError, json.JSONDecodeError) as e:
        raise CheckpointError(f"unreadable checkpoint meta {meta_path}: {e}")
    if meta.get("format") != FORMAT:
        raise CheckpointError(
            f"not a {FORMAT} checkpoint: {meta.get('format')!r}"
        )
    if plan_hash is not None and meta["plan_hash"] != plan_hash:
        raise CheckpointError(
            f"checkpoint {directory} belongs to a different run: plan hash "
            f"{meta['plan_hash'][:12]}… != current {plan_hash[:12]}… — "
            f"same DB/support/P/scheduler required for an exact resume"
        )
    path = os.path.join(directory, meta["payload"])
    if not os.path.exists(path):
        raise CheckpointError(f"checkpoint payload missing: {path}")
    with open(path, "rb") as f:
        raw = f.read()
    got = crc32c(np.frombuffer(raw, np.uint8))
    if got != int(meta["payload_crc32c"]):
        raise CheckpointError(
            f"checkpoint payload corrupt: CRC32C {got:#010x} != recorded "
            f"{int(meta['payload_crc32c']):#010x} at {path}"
        )
    with np.load(path) as z:
        flat = z["queue_flat"].tolist()
        qlens = z["queue_lens"].tolist()
        queues, off = [], 0
        for ln in qlens:
            queues.append([int(c) for c in flat[off:off + ln]])
            off += ln
        anc = z["anc_supports"] if bool(z["has_anc"][0]) else None
        state = RoundState(
            round_index=int(meta["round"]),
            queues=queues,
            fi_masks=z["fi_masks"],
            fi_supports=z["fi_supports"],
            anc_supports=anc,
            observed=z["observed"],
            est_mined=z["est_mined"],
            exchange_overflow=int(meta["exchange_overflow"]),
            mine_overflow=int(meta["mine_overflow"]),
            rounds=_rounds_from_json(meta["rounds"]),
            donations=[
                Donation(*map(int, t))
                for t in meta["donations"]
            ],
        )
    return state

"""Store integrity checker CLI of the port — scan, repair, or quarantine a TxStore.

Read-only by default: classifies every damage class the failure model
names (missing / truncated / bit-flip / stale-manifest / orphan) and exits
non-zero if anything is wrong, so it slots into cron jobs and CI the way a
filesystem fsck does.  ``--repair`` adopts the contiguous valid blocks a
crashed writer left unindexed and deletes torn ones; ``--quarantine`` also
moves damaged indexed blocks into ``quarantine/`` and recounts the
manifest exactly from the survivors.  ``--shallow`` skips payload reads
(stat-level checks only — what ``StoreWriter(resume=True)`` runs).

This is a pure host tool: it imports no torch, so it runs on storage
hosts that have no accelerator stack at all.

  python -m repro_torch.launch.fsck /data/txstore            # scan, exit 1 if bad
  python -m repro_torch.launch.fsck /data/txstore --repair   # + adopt crash residue
  python -m repro_torch.launch.fsck /data/txstore --quarantine  # + salvage
"""
from __future__ import annotations

import argparse
import sys


def main():
    from repro_torch.store.fsck import fsck

    ap = argparse.ArgumentParser(
        description="check / repair an on-disk transaction store"
    )
    ap.add_argument("store", help="TxStore directory (holds manifest.json)")
    ap.add_argument("--repair", action="store_true",
                    help="adopt a crashed writer's unindexed blocks, delete "
                         "torn ones")
    ap.add_argument("--quarantine", action="store_true",
                    help="also move damaged indexed blocks to quarantine/ "
                         "and recount the manifest (implies --repair)")
    ap.add_argument("--shallow", action="store_true",
                    help="stat-level checks only (no payload reads/CRC)")
    args = ap.parse_args()

    try:
        rep = fsck(
            args.store,
            repair=args.repair,
            quarantine=args.quarantine,
            deep=not args.shallow,
        )
    except FileNotFoundError as e:
        print(f"fsck: no store at {args.store}: {e}", file=sys.stderr)
        sys.exit(2)
    except ValueError as e:
        print(f"fsck: unreadable manifest: {e}", file=sys.stderr)
        sys.exit(2)

    print(rep.summary())
    if rep.damages and not rep.clean:
        print("fsck: damage remains (re-run with --repair / --quarantine "
              "to act on it)", file=sys.stderr)
        sys.exit(1)
    if rep.damages:
        print(f"fsck: {len(rep.damages)} finding(s) handled; store is "
              f"consistent ({rep.n_blocks} blocks, {rep.n_tx} tx)")
    sys.exit(0)


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""What is live at a dry-run cell's peak of live bytes.

  PYTHONPATH=src python probes/dryrun_peak.py ARCH SHAPE MESH [--top 15]

Runs the port's step of one cell on its fake world, as
``python -m repro_torch.launch.dryrun`` does (``dryrun.dry_run``), with a
``StepMeter`` that also notes, for each storage it counts, the op that made
it, its shape and its dtype.  When the live bytes reach their peak it keeps
the set of storages live then, and prints the record's ``memory`` and the
largest groups of that set by (op, shape, dtype): bytes, count.  CPU only;
under ``FakeTensorMode`` nothing is allocated.
"""
from __future__ import annotations

import argparse
import collections
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.launch import dryrun  # noqa: E402


class PeakMeter(dryrun.StepMeter):
    """``StepMeter`` that keeps ``at_peak``: ``(op, shape, dtype, bytes)``
    of each storage live when the live bytes last reached their peak."""

    def __init__(self, *args, **kwargs):
        super().__init__(*args, **kwargs)
        self.made = {}
        self.at_peak = []
        self._func = None
        self._rose = False

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._func = func
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _track(self, t):
        key = self._key(t)
        if key not in self._refs and key not in self._args:
            self.made[key] = (str(self._func), tuple(t.shape), str(t.dtype).removeprefix("torch."),
                              t.untyped_storage().nbytes())
        peak = self.peak
        super()._track(t)
        self._rose = self._rose or self.peak > peak

    def _release(self, key, own):
        if self._rose:     # the set live at the peak, taken before it shrinks
            self.at_peak = [self.made[k] for k in self._refs]
            self._rose = False
        super()._release(key, own)
        if key not in self._refs:
            self.made.pop(key, None)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("arch")
    ap.add_argument("shape")
    ap.add_argument("mesh", choices=["single", "multi"])
    ap.add_argument("--top", type=int, default=15)
    args = ap.parse_args()
    meters = []

    class Meter(PeakMeter):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            meters.append(self)

    dryrun.StepMeter = Meter
    run = dryrun.dry_run(dryrun.plan(args.arch, args.shape, args.mesh))
    meter = meters[0]
    print("memory", run.record["memory"], "peak of live bytes", meter.peak)
    size, count = collections.Counter(), collections.Counter()
    for op, shape, dtype, n in meter.at_peak:
        size[(op, shape, dtype)] += n
        count[(op, shape, dtype)] += 1
    print("live at the peak (bytes, count, op, shape, dtype):")
    for key, n in size.most_common(args.top):
        print(f"  {n}  x{count[key]}  {key[0]}  {list(key[1])}  {key[2]}")


if __name__ == "__main__":
    main()

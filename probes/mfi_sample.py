#!/usr/bin/env python3
"""The MFI DFS of the ``seq`` variant on a sample of the thesis database.

  python3 probes/mfi_sample.py [--device cpu|cuda] [--rows 2048] [--seed 0]

Generates T500I0.1P50PL10TL40 (``chip_smoke.py``'s thesis database), draws
``--rows`` transactions i.i.d. with numpy's generator from ``--seed`` (the
launchers' database sample is 2,048 rows), and runs
``mfi.mine_all_candidates`` on it at support 0.2 twice: with the launchers'
``MFIConfig(max_out=2048, max_stack=2048)``, and with an output buffer large
enough to keep every candidate.  Prints one JSON object a run: DFS trips,
candidates kept, dropped (``overflow``), the seconds and the seconds a trip
on the device it ran on.  Runs on the card unless ``--device cpu`` is given,
and raises where no card is present.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None, choices=["cpu", "cuda"])
    ap.add_argument("--rows", type=int, default=2048)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch import device as device_mod
    from repro_torch.core import bitmap as bm
    from repro_torch.core import mfi
    from repro_torch.data import ibm_gen

    dev = device_mod.resolve(args.device)
    dense = ibm_gen.generate_dense(ibm_gen.params_from_name("T500I0.1P50PL10TL40", seed=0))
    rows = dense[np.random.default_rng(args.seed).integers(0, len(dense), args.rows)]
    db = bm.BitmapDB.from_dense(torch.from_numpy(rows).to(dev))
    min_support = int(np.ceil(0.2 * args.rows))
    for max_out in (2048, 1 << 16):
        config = mfi.MFIConfig(max_out=max_out, max_stack=2048)
        t0 = time.perf_counter()
        r = mfi.mine_all_candidates(db, min_support, config=config)
        device_mod.synchronize(dev)
        seconds = time.perf_counter() - t0
        print(json.dumps({"device": str(dev), "rows": args.rows, "min_support": min_support,
                          "max_out": max_out, "trips": r.n_iters, "kept": r.n_out,
                          "dropped": r.overflow, "seconds": seconds,
                          "seconds_a_trip": seconds / max(r.n_iters, 1)}))


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""The walls of the ``main`` and ``cluster`` paths, taken several times in one
process, for one checkout.

  python3 probes/walls.py [--tree DIR] [--repeats 5]   # one card

``DIR`` is the root of the checkout whose ``src/`` is mined (this one by
default; the parent's as an unpacked ``git archive``, say).  The thesis
database of ``chip_smoke.py`` (T500I0.1P50PL10TL40 at support 0.2, P = 4) is
generated once; then ``mine.mine_dense`` (K = 16) and
``cluster_mine.run_once`` (K = 16, B1 in Phase 4) each run ``--repeats``
times, in turns, after one untimed run of each that builds the kernels and
warms the card.  It prints one JSON object with each run's wall in seconds,
the cluster runs' plan and mine times in milliseconds, their medians, and
the card's ``nvidia-smi`` line.  To compare two checkouts, run it once a
process for each, in the order parent, change, change, parent: a call's
first process runs slower than the later ones.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", type=Path, default=ROOT, help="root of the checkout to mine with")
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    tree = args.tree.resolve()
    sys.path[:0] = [str(tree / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.data import ibm_gen
    from repro_torch.launch import cluster_mine, mine

    if not torch.cuda.is_available():
        chip_smoke.fail("CUDA is not available")
    dev = torch.device("cuda")
    dense = ibm_gen.generate_dense(ibm_gen.params_from_name(chip_smoke.THESIS_DB, seed=0))
    cargs = chip_smoke.cluster_args(chip_smoke.THESIS_DB, "--frontier", "16")
    runs = {"main": [], "cluster": [], "cluster_plan_ms": [], "cluster_mine_ms": []}
    for r in range(args.repeats + 1):
        res, main_s = mine.mine_dense(dense, support=chip_smoke.SUPPORT, P=4, frontier=16,
                                      device=dev)
        cres, cluster_s = cluster_mine.run_once(dense, 4, cargs, dev)
        if r == 0:  # the warm-up
            continue
        runs["main"].append(main_s)
        runs["cluster"].append(cluster_s)
        runs["cluster_plan_ms"].append(cres.report.phase_ms["plan"])
        runs["cluster_mine_ms"].append(cres.report.phase_ms["mine"])
    print(json.dumps({"tree": str(tree), "n_fis": res.n_fis, **runs,
                      "median": {k: statistics.median(v) for k, v in runs.items()}}), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()

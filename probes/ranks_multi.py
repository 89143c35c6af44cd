#!/usr/bin/env python3
"""The miners across N cards: ``mine`` and ``cluster_mine`` with ``-P N
--devices N`` (one miner a rank, NCCL) against the same launchers with the N
miners stacked on one card (``--devices 0``), on the thesis database.

  python3 probes/ranks_multi.py [--ranks 4] [--db T500I0.1P50PL10TL40] \\
      [--support 0.2] [--device cuda]              # N cards (cpu: gloo ranks)

The kernel library is built first, so no child pays for ``nvcc``.  Then four
child processes run one after the other: ``mine`` local, ``mine`` ranks,
``cluster_mine`` local, ``cluster_mine`` ranks, each generating the database
itself and printing its FITable's SHA-256 (``--digest``); the two
``cluster_mine`` runs are traced (``--trace``), and their ``cluster/exchange``
and ``cluster/mine`` spans give each round's milliseconds.  The probe fails
unless all four print one digest and the rank runs report the backend of
their device (``nccl`` or ``gloo``).  It prints one JSON object: each run's
backend, |F|, wall (the launcher's own, the mine alone), its phase seconds
or milliseconds, the rounds' exchange and mine ms, its kernel launches and
the child's seconds, and the cards' ``nvidia-smi`` lines.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def run(module: str, argv: list, timeout: float) -> dict:
    t0 = time.perf_counter()
    done = subprocess.run([sys.executable, "-m", module, *argv], capture_output=True, text=True,
                          cwd=ROOT, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")),
                          timeout=timeout)
    out = done.stdout
    if done.returncode != 0:
        raise SystemExit(f"ranks_multi: {module} {argv} exited {done.returncode}:\n"
                         f"{out[-2000:]}\n{done.stderr[-3000:]}")
    head = re.search(r"^\|F\| = (\d+)\s+in ([\d.]+)s\s+backend=(\w+)", out, re.M)
    digest = re.search(r"^FITable sha256=(\w+)$", out, re.M)
    launches = re.search(r"^kernel launches: (.*)$", out, re.M)
    phases = (re.search(r"^phase seconds: (\{.*\})$", out, re.M)
              or re.search(r"^per-phase ms: (.*)$", out, re.M))
    phase = phases.group(1) if phases else ""
    return {"backend": head.group(3), "n_fis": int(head.group(1)),
            "wall_s": float(head.group(2)), "digest": digest.group(1),
            "phases": json.loads(phase) if phase.startswith("{") else
            {k: float(v) for k, v in (kv.split("=") for kv in phase.split())},
            "launches": {k: int(n) for k, n in (kv.split("=") for kv in
                                                launches.group(1).split())},
            "child_s": time.perf_counter() - t0}


def round_spans(run_dir: str) -> dict:
    """Each round's ``cluster/exchange`` and ``cluster/mine`` ms on the
    launcher's own track (the modeled per-miner lanes carry ``trips``)."""
    with open(Path(run_dir) / "trace.json") as f:
        events = json.load(f)["traceEvents"]
    out = {"exchange_ms": [], "mine_ms": []}
    for ev in events:
        if ev.get("ph") == "X" and ev["name"] in ("cluster/exchange", "cluster/mine") \
                and "trips" not in ev.get("args", {}):
            out[ev["name"].split("/")[1] + "_ms"].append(ev["dur"] / 1e3)
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--db", default="T500I0.1P50PL10TL40")
    ap.add_argument("--support", type=float, default=0.2)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--timeout", type=float, default=600)
    args = ap.parse_args()
    n = args.ranks
    if args.device == "cuda":
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import build

        build.build()
    common = ["--db", args.db, "--support", str(args.support), "-P", str(n), "--frontier",
              "16", "--digest", "--device", args.device]
    runs = {}
    with tempfile.TemporaryDirectory() as tmp:
        for name, module in (("mine", "repro_torch.launch.mine"),
                             ("cluster_mine", "repro_torch.launch.cluster_mine")):
            for kind, devices in (("local", 0), ("ranks", n)):
                key = f"{name}_{kind}"
                trace = ["--trace", f"{tmp}/{key}"] if name == "cluster_mine" else []
                runs[key] = run(module, common + ["--devices", str(devices), *trace],
                                args.timeout)
                if trace:
                    runs[key]["rounds"] = round_spans(f"{tmp}/{key}")
    backend = "nccl" if args.device == "cuda" else "gloo"
    digests = {r["digest"] for r in runs.values()}
    bad = [k for k, r in runs.items()
           if r["backend"] != (backend if k.endswith("_ranks") else "local")]
    smi = ""
    if args.device == "cuda":
        smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=60).stdout.strip().splitlines()
    print(json.dumps({"probe": "ranks_multi", "ranks": n, "db": args.db,
                      "support": args.support, "device": args.device, "nvidia_smi": smi,
                      "same_fitable": len(digests) == 1, "runs": runs}), flush=True)
    if len(digests) != 1 or bad:
        raise SystemExit(f"ranks_multi: {len(digests)} digests; wrong backend in {bad}")


if __name__ == "__main__":
    main()

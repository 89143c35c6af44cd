#!/usr/bin/env python3
"""The whole dry-run sweep, the port's against the JAX package's, on the CPU.

  PYTHONPATH=src python probes/dryrun_sweep.py [--jobs 4] [--steps] [--timeout 3600]

Every cell of the reference's sweep (each arch, ``shapes_for``, ``single``
and ``multi``), with ``REPRO_ZERO1`` unset and set:

  * the port's argument bytes a device (``repro_torch.launch.dryrun.
    argument_bytes``, from the shapes) beside the reference's
    ``memory.argument_bytes`` (the JAX package's own dry-run launcher, one
    subprocess a cell, ``--jobs`` at a time, into ``results/dryrun/``; a
    record already there is read) and whether the two are equal, with the
    reference's collective wire bytes a device and its ``loops`` against the
    port's;
  * with ``--steps``, the port's own record of each cell without
    ``REPRO_ZERO1`` (``python -m repro_torch.launch.dryrun``, one process a
    cell, ``--jobs`` at a time, into ``results/dryrun_torch/``; a record
    already there is read, not remade): its wire bytes, temp and step time
    beside the reference's, or why it did not finish.

It writes everything to ``results/dryrun_sweep.json``, prints a markdown
table, and exits 1 if any cell's argument bytes or loops differ.  The JAX
package runs only in the reference's subprocesses; this process imports
nothing of it.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))


def env_for(zero1: bool) -> dict:
    env = {k: v for k, v in os.environ.items() if k != "REPRO_ZERO1"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    if zero1:
        env["REPRO_ZERO1"] = "1"
    return env


def reference(cell, zero1: bool, timeout: float) -> dict:
    """The JAX package's record of ``cell``: its own launcher in a
    subprocess (``--tag zero1`` under ``REPRO_ZERO1``), which writes
    ``results/dryrun/<cell>.json``; a record already there is read."""
    tag = "zero1" if zero1 else ""
    out = ROOT / "results" / "dryrun" / (f"{cell[0]}__{cell[1]}__{cell[2]}"
                                         + (f"__{tag}" if tag else "") + ".json")
    if not out.exists():
        cmd = [sys.executable, "-m", "repro.launch.dryrun", "--arch", cell[0], "--shape",
               cell[1], "--mesh", cell[2]] + (["--tag", tag] if tag else [])
        try:
            r = subprocess.run(cmd, cwd=ROOT, env=env_for(zero1), capture_output=True,
                               text=True, timeout=timeout)
        except subprocess.TimeoutExpired:
            return {"error": f"timeout {timeout} s"}
        if r.returncode != 0 or not out.exists():
            return {"error": r.stderr[-2000:]}
    return json.loads(out.read_text())


def port_step(cell, results: Path, timeout: float) -> dict:
    from repro_torch.launch import dryrun

    out = results / dryrun.cell_filename(*cell).name
    if not out.exists():
        env = dict(env_for(False), REPRO_TORCH_DRYRUN_DIR=str(results))
        t0 = time.time()
        try:
            r = subprocess.run([sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
                                cell[0], "--shape", cell[1], "--mesh", cell[2]], env=env,
                               capture_output=True, text=True, timeout=timeout)
        except subprocess.TimeoutExpired:
            return {"error": f"timeout {timeout} s"}
        if r.returncode != 0 or not out.exists():
            tail = [ln for ln in r.stderr.splitlines() if ln.strip() and not ln.startswith(" ")]
            return {"error": " | ".join(tail[-3:])[-600:], "wall_s": time.time() - t0}
        rep = [ln for ln in r.stdout.splitlines() if ln.startswith("replicated ops:")]
        out.with_suffix(".replicated").write_text(rep[0][len("replicated ops: "):] if rep
                                                  else "{}")
    rec = json.loads(out.read_text())
    rep = out.with_suffix(".replicated")
    rec["replicated_ops"] = json.loads(rep.read_text()) if rep.exists() else None
    return rec


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--jobs", type=int, default=4)
    ap.add_argument("--steps", action="store_true", help="also run the port's step of each cell")
    ap.add_argument("--timeout", type=float, default=3600)
    args = ap.parse_args()

    from repro_torch.configs.base import shapes_for
    from repro_torch.configs.registry import all_archs, get_config
    from repro_torch.launch import dryrun

    cells = [(a, s, m) for a in all_archs() for s in shapes_for(get_config(a))
             for m in ("single", "multi")]
    rows = {}
    for zero1 in (False, True):
        os.environ.pop("REPRO_ZERO1", None)
        if zero1:
            os.environ["REPRO_ZERO1"] = "1"
        for cell in cells:
            c = dryrun.plan(*cell)
            rows[(cell, zero1)] = {
                "port_argument_bytes": dryrun.argument_bytes(c)["total"],
                "port_loops": {"accum": c.accum, "attn_chunk": c.attn_chunk,
                               "layer_scan_trips": dryrun.layer_scan_trips(c.cfg)}}
    os.environ.pop("REPRO_ZERO1", None)
    results = ROOT / "results" / "dryrun_torch"
    results.mkdir(parents=True, exist_ok=True)
    t0 = time.time()
    with ThreadPoolExecutor(args.jobs) as pool:
        refs = {key: pool.submit(reference, key[0], key[1], args.timeout) for key in rows}
        steps = {cell: pool.submit(port_step, cell, results, args.timeout)
                 for cell in cells} if args.steps else {}
        for key, fut in refs.items():
            rows[key]["reference"] = fut.result()
        for cell, fut in steps.items():
            rows[(cell, False)]["port_step"] = fut.result()
    bad = 0
    for row in rows.values():
        ref = row["reference"]
        row["equal"] = (ref.get("memory", {}).get("argument_bytes") == row["port_argument_bytes"]
                        and ref.get("loops") == row["port_loops"])
        bad += not row["equal"]

    def wire(rec):
        if "collectives" in rec:
            return f"{rec['collectives']['total_wire_bytes_per_device']:.0f}"
        return "failed" if "error" in rec else "not run"

    print("| arch | shape | argument B a device, 16×16 | 2×16×16 | equal to the reference "
          "(both meshes, ZeRO-1 too) | reference wire B, 16×16 | 2×16×16 | port wire B, "
          "16×16 | 2×16×16 |")
    print("|---|---|---|---|---|---|---|---|---|")
    for cell in cells:
        if cell[2] != "single":
            continue
        multi = (cell[0], cell[1], "multi")
        one, two = rows[(cell, False)], rows[(multi, False)]
        same = all(rows[(c, z)]["equal"] for c in (cell, multi) for z in (False, True))
        print(f"| {cell[0]} | {cell[1]} | {one['port_argument_bytes']} | "
              f"{two['port_argument_bytes']} | {'yes' if same else 'NO'} | "
              f"{wire(one['reference'])} | {wire(two['reference'])} | "
              f"{wire(one.get('port_step', {}))} | {wire(two.get('port_step', {}))} |")
    for (cell, zero1), row in rows.items():
        if not row["equal"]:
            print(f"DIFFERS: {cell} zero1={zero1}: port {row['port_argument_bytes']} "
                  f"{row['port_loops']}, reference {row['reference'].get('memory')} "
                  f"{row['reference'].get('loops')} {row['reference'].get('error', '')[:300]}")
        step = row.get("port_step", {})
        if "error" in step:
            print(f"STEP FAILED: {cell}: {step['error'][:400]}")
    out = ROOT / "results" / "dryrun_sweep.json"
    out.write_text(json.dumps([{"cell": list(cell), "zero1": zero1, **row}
                               for (cell, zero1), row in rows.items()], indent=1))
    print(f"{len(rows)} cells, {bad} differ; {time.time() - t0:.0f} s; {out.relative_to(ROOT)}")
    sys.exit(1 if bad else 0)


if __name__ == "__main__":
    main()

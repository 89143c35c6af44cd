"""The JAX package's dry run, for the port's dry-run tests
(``test_torch_dryrun*.py``).

:func:`records` runs ``repro.launch.dryrun.run_cell`` for each cell in one
JAX subprocess (its import forks 512 host devices, so it cannot share this
process's JAX) and returns the records it prints.  ``run_cell`` writes
nothing; the subprocess runs in a temporary directory all the same, with
``REPRO_ZERO1`` as the caller asks (unset by default).
"""
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

_SCRIPT = """
import json, sys
from repro.launch import dryrun
for arch, shape, mesh in json.loads(sys.argv[1]):
    print("RECORD " + json.dumps(dryrun.run_cell(arch, shape, mesh)), flush=True)
"""


def records(cells, zero1: bool = False, timeout: float = 300):
    """``{(arch, shape, mesh): the reference's record}``."""
    env = {k: v for k, v in os.environ.items() if k != "REPRO_ZERO1"}
    env.update(PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu")
    if zero1:
        env["REPRO_ZERO1"] = "1"
    with tempfile.TemporaryDirectory() as tmp:
        r = subprocess.run([sys.executable, "-c", _SCRIPT, json.dumps([list(c) for c in cells])],
                           cwd=tmp, env=env, capture_output=True, text=True, timeout=timeout)
    if r.returncode != 0:
        raise RuntimeError(f"the reference's dry run failed:\n{r.stderr[-4000:]}")
    recs = [json.loads(line[len("RECORD "):]) for line in r.stdout.splitlines()
            if line.startswith("RECORD ")]
    return {tuple(c): rec for c, rec in zip(cells, recs)}

"""Build and load the port's CUDA kernels.

The ``.cu`` sources under ``csrc/`` are compiled by ``nvcc`` for ``sm_90a``,
one process per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build happens
at first use, into ``build/repro_torch/`` at the root of the
checkout (git-ignored), under a name keyed by a hash of the sources and the
flags, so a changed source is rebuilt and an unchanged one is reused.
Nothing here runs at import time: the CPU tests import every module.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = (CSRC / "support.cu", CSRC / "mxu_support.cu", CSRC / "subset_query.cu",
           CSRC / "delta_support.cu", CSRC / "pair_support.cu")
# included by the sources: part of what the library is built from
HEADERS = (CSRC / "bmma.cuh", CSRC / "occupancy.cuh")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_P, _I = ctypes.c_void_p, ctypes.c_int
# C entry points of the sources: argument types of each (all return int).
SIGNATURES = {
    "multi_extension_supports": (_P, _P, _P, _I, _I, _I, _I, _P),
    "multi_extension_supports_facts": (_I, _I, _I, _I, _P),
    "extension_supports": (_P, _P, _P, _I, _I, _P),
    "multi_extension_supports_mxu": (_P, _P, _P, _I, _I, _I, _I, _P),
    "multi_extension_supports_mxu_facts": (_I, _I, _I, _I, _P),
    "subset_superset_counts": (_P, _P, _P, _P, _I, _I, _I, _P),
    "block_itemset_supports": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "block_itemset_supports_facts": (_P, _I, _I, _I, _I, _I, _P),
    "pair_supports": (_P, _P, _P, _I, _I, _I, _P),
    "pair_supports_mxu": (_P, _P, _P, _I, _I, _I, _P),
    "pair_supports_mxu_facts": (_I, _I, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built with the CUDA toolkit")


def library_path() -> Path:
    """Where the library for the current sources and headers lives (built or
    not)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in SOURCES + HEADERS:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return BUILD_DIR / f"libfimi_support_{h.hexdigest()[:16]}.so"


def _run(cmds) -> None:
    """Run the commands side by side; raise with the output of any that fails."""
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for cmd in cmds]
    outs = [(p.communicate()[0], p.returncode) for p in procs]
    for out, code in outs:
        if code != 0:
            raise RuntimeError(f"nvcc failed ({code}):\n{out}")


def build() -> Path:
    """Compile the sources unless a library for them exists; return its path."""
    target = library_path()
    if target.exists():
        return target
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in SOURCES]
        _run([[nvcc, *NVCC_FLAGS, "-c", "-o", str(o), str(src)]
              for o, src in zip(objs, SOURCES)])
        lib = Path(tmp) / target.name
        _run([[nvcc, *NVCC_FLAGS, "-shared", "-o", str(lib), *map(str, objs)]])
        os.replace(lib, target)  # atomic: a concurrent build never sees half a file
    return target


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib


def check(status: int, name: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if status != 0:
        raise RuntimeError(f"CUDA kernel {name} failed: cudaError_t {status}")

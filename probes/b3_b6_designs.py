#!/usr/bin/env python3
"""The designs tried for B3 and B6 on the H100, timed against the port's own.

B3's and B6's launch shapes and the designs that lost to them, timed against
the port's own and, where given, a parent checkout's.

  python3 probes/b3_b6_designs.py [--parent DIR]   # from the root of a checkout, one card

``DIR`` is the root of another checkout (an unpacked ``git archive`` of the
parent commit, say); its ``support.cu`` and ``pair_support.cu`` are built into
a library named ``parent``.  B3 (``single_support_kernel``, ``csrc/
support.cu``) and B6 (``pair_support_kernel``, ``csrc/pair_support.cu``) are
the port's; these are the designs that lost to them, kept so that their times
can be taken again:

  mid_long            middle rows (64 < W < 8192) on the long rows' form,
                      256 threads over 2 rows, with a cluster of 1;
  no_short            short rows (W <= 64) on the middle rows' form, 256
                      threads over a row, four words a step;
  long_one_row        long rows with one row a cluster, not two;
  unroll2, unroll8    two or eight words a step on middle and long rows;
  threads128          128-thread blocks on middle and long rows;
  cluster_from_4096, cluster_from_16384
                      clusters from W = 4096 or 16384 words, not 8192;
  b6_one_word, b6_three_words
                      B6 with one or three words a thread a step, not two;
  b6_wide256          B6's wide blocks of 256 threads, not 128.

A design is the port's ``csrc`` with the hunks of ``b3_b6_designs/<name>.diff``
applied to it (``mxu_designs.apply_diff``), and only the sources it changes
built, into a library of its own (one ``nvcc`` a source, every build started
together).  Each library is checked bit-equal to the plain versions on ragged
shapes and timed in turns: the parent, the port, each design, each design
again in reverse order, the port again, the parent again, each time from a
CUDA graph of 100 launches (``chip_smoke.device_ms``).  It prints one JSON
object for the builds and checks, the port's launch facts at each timed
shape, one object a timed shape (microseconds a launch, two times for each
library), and the card's ``nvidia-smi`` line; a design that does not build or
disagrees is reported and not timed.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DESIGNS = Path(__file__).resolve().parent / "b3_b6_designs"
NAMES = ("mid_long", "no_short", "long_one_row", "unroll2", "unroll8", "threads128",
         "cluster_from_4096", "cluster_from_16384", "b6_one_word", "b6_three_words",
         "b6_wide256")
SOURCES = ("support.cu", "pair_support.cu")

# B3 on both sides of its launch shapes (64 and 8192 words) and at the paths'
# I = 100, W in {64, 15625}; B6 at the repl_min tidlists' C = 100, W = 64 and
# at the profiled demo's I = 100, W = 15625; B1 at K = 1 as B3's yardstick
B3_TIMED = ((100, 64), (100, 65), (100, 128), (100, 255), (100, 1000), (100, 4096),
            (100, 8191), (100, 8192), (100, 15625), (7, 64), (7, 15625), (1000, 64),
            (1000, 15625))
B6_TIMED = ((100, 64), (100, 15625), (300, 15625))
B1_TIMED = ((1, 100, 15625),)


def sources_of(name: str, base: Path, dest: Path) -> list[Path]:
    """The sources a design changes: the port's ``base`` (its ``csrc``) copied
    to ``dest / name`` with the design's hunks applied."""
    import shutil

    import mxu_designs

    csrc = dest / name
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(base, csrc)
    diff = DESIGNS / f"{name}.diff"
    mxu_designs.apply_diff(csrc, diff)
    return [csrc / line[6:].strip() for line in diff.read_text().splitlines()
            if line.startswith("+++ b/")]


def build_all(build, parent: Path | None) -> tuple[dict, dict]:
    """Every design's library and the parent's, built side by side, each with
    the sources it holds; and the ones that failed."""
    nvcc, procs = build._nvcc(), {}
    dest = build.BUILD_DIR.parent / "b3_b6_designs"
    plan = {name: sources_of(name, build.CSRC, dest) for name in NAMES}
    if parent is not None:
        plan["parent"] = [parent / "src" / "repro_torch" / "kernels" / "csrc" / s
                          for s in SOURCES]
    for name, srcs in plan.items():
        out = dest / name
        out.mkdir(parents=True, exist_ok=True)
        procs[name] = [(out / f"{src.stem}.o", src.name, subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-c", "-o", str(out / f"{src.stem}.o"), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for src in srcs]
    libs, failed = {}, {}
    for name, objs in procs.items():
        outs = [(p.communicate()[0], p.returncode) for _, _, p in objs]
        if any(code for _, code in outs):
            failed[name] = "\n".join(out for out, code in outs if code)[-2000:]
            continue
        lib = dest / name / "lib.so"
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(lib),
                        *(str(o) for o, _, _ in objs)], check=True)
        libs[name] = typed(ctypes.CDLL(str(lib)), build, {s for _, s, _ in objs})
    return libs, failed


def typed(lib, build, sources):
    """``lib`` with the entry points of its ``sources`` typed; ``lib.kernels``
    names the kernels it holds."""
    entries = {"support.cu": ("B1", "multi_extension_supports", "B3", "extension_supports"),
               "pair_support.cu": ("B6", "pair_supports")}
    lib.kernels = set()
    for src in sources:
        kernels = entries[src]
        for kernel, name in zip(kernels[::2], kernels[1::2]):
            fn = getattr(lib, name)
            fn.argtypes = list(build.SIGNATURES[name])
            fn.restype = ctypes.c_int
            lib.kernels.add(kernel)
    return lib


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", type=Path, help="root of a checkout to time beside this one")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT), str(Path(__file__).resolve().parent)]
    import torch

    import chip_smoke
    from repro_torch.kernels import bitmap_support as bs
    from repro_torch.kernels import build
    from repro_torch.kernels import pair_support as ps

    if not torch.cuda.is_available():
        chip_smoke.fail("CUDA is not available")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs, failed = build_all(build, args.parent.resolve() if args.parent else None)
    libs["port"] = typed(build.library(), build, SOURCES)
    gen = torch.Generator(device=dev).manual_seed(0)

    def words(*shape):
        return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32, device=dev,
                             generator=gen)

    def stream():
        return torch.cuda.current_stream().cuda_stream

    def b1(lib, items, tids):
        (I, W), K = items.shape, tids.shape[0]
        out = torch.empty((K, I), dtype=torch.int32, device=dev)
        build.check(lib.multi_extension_supports(items.data_ptr(), tids.data_ptr(),
                                                 out.data_ptr(), K, I, W, sms, stream()),
                    "multi_extension_supports")
        return out

    def b3(lib, items, tid):
        I, W = items.shape
        out = torch.empty(I, dtype=torch.int32, device=dev)
        build.check(lib.extension_supports(items.data_ptr(), tid.data_ptr(), out.data_ptr(),
                                           I, W, stream()), "extension_supports")
        return out

    def b6(lib, items, valid):
        I, W = items.shape
        out = torch.empty((I, I), dtype=torch.int32, device=dev)
        build.check(lib.pair_supports(items.data_ptr(), valid.data_ptr(), out.data_ptr(), I,
                                      W, sms, stream()), "pair_supports")
        return out

    # every library bit-equal to the plain versions on ragged shapes
    ragged_w = (1, 63, 64, 65, 255, 1025, 4097, 8191, 8192, 8193, 15625)
    cases = [("B3", b3, (words(i, w), words(w)), bs.extension_supports_plain)
             for i in (1, 7, 8, 9, 17, 100, 131) for w in ragged_w]
    for i in (1, 7, 8, 9, 17, 100, 131):
        for w in ragged_w:
            valid = words(w)
            valid[::3], valid[1::5], valid[-1] = -1, 0, (1 << 13) - 1
            cases.append(("B6", b6, (words(i, w), valid), ps.pair_supports_plain))
    wrong = {}
    for name, lib in libs.items():
        for kernel_name, kernel, kargs, plain in cases:
            if kernel_name not in lib.kernels:
                continue
            try:
                same = torch.equal(kernel(lib, *kargs), plain(*kargs))
            except RuntimeError as e:
                same = False
                wrong.setdefault(name, []).append(str(e))
            if not same:
                wrong.setdefault(name, []).append([list(a.shape) for a in kargs])
    for name in wrong:
        libs.pop(name)
    if "port" not in libs:
        chip_smoke.fail(f"the port's B3 or B6 disagrees with its plain version: {wrong['port']}")
    print(json.dumps({"built": sorted(libs), "build_failed": failed, "checked": len(cases),
                      "disagree": {n: w[:5] for n, w in wrong.items()}}), flush=True)

    facts = [{"kernel": "B3", "shape": {"I": i, "W": w},
              **build.launch_facts("extension_supports_facts", build.CLUSTER_FACTS, dev, i, w)}
             for i, w in B3_TIMED]
    facts += [{"kernel": "B6", "shape": {"I": i, "W": w},
               **build.launch_facts("pair_supports_facts", build.CLUSTER_FACTS, dev, i, w, sms)}
              for i, w in B6_TIMED]
    print(json.dumps({"port_launch_facts": facts}), flush=True)

    designs = [n for n in NAMES if n in libs]
    order = ["port", *designs, *designs[::-1], "port"]
    if "parent" in libs:
        order = ["parent", *order, "parent"]
    ones = {w: torch.full((w,), -1, dtype=torch.int32, device=dev) for _, w in B6_TIMED}
    timed = [("B3", {"I": i, "W": w}, b3, (words(i, w), words(w))) for i, w in B3_TIMED]
    timed += [("B6", {"I": i, "W": w}, b6, (words(i, w), ones[w])) for i, w in B6_TIMED]
    timed += [("B1", {"K": k, "I": i, "W": w}, b1, (words(i, w), words(k, w)))
              for k, i, w in B1_TIMED]
    for kernel_name, shape, kernel, kargs in timed:
        us = {}
        for name in order:
            if kernel_name in libs[name].kernels:
                us.setdefault(name, []).append(1e3 * chip_smoke.device_ms(
                    torch, lambda: kernel(libs[name], *kargs), launches=100))
        print(json.dumps({"kernel": kernel_name, "shape": shape, "us": us}), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()

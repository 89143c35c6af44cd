#!/usr/bin/env python3
"""The redesigns tried for B2 and B7 on the H100, timed against the port's own.

  python3 probes/mxu_designs.py        # from the root of a checkout, one card

B2 (``csrc/mxu_support.cu``) and B7 (``csrc/pair_support.cu``) keep the bodies
they were ported with.  These are the redesigns that lost to them, kept so
that their times can be taken again:

  cluster_tile  a block of 8 warps holds a whole output tile (B2 64 x 128, B7
                128 x 128) over one chunk of W, staged with 16-byte cp.async
                into a ring of 4 slots; the chunks of a tile form a cluster of
                8 that pushes each slice's counts to its owner with st.async,
                and the owner adds them into the output;
  ring          4 warps a block over a 64 x 32 tile (B2) or a pair of 32-row
                tiles (B7), staged through the same ring, one atomic a chunk
                and output;
  tile32        the port's B2 with tiles of 32 prefixes (two m-tiles a block);
  bps2 .. bps12 the port's B2 and B7 sized for 2, 6, 8 or 12 blocks an SM
                instead of 4;
  prefetch2, prefetch3  the port's B2 and B7 with 2 or 3 stages loaded into
                registers ahead instead of 1.

A design is the port's ``csrc`` with the files of ``mxu_designs/<name>/`` laid
over it, or the hunks of ``mxu_designs/<name>.diff`` applied to it.  Each is
built into a library of its own (one ``nvcc`` a source, every build started
together), checked bit-equal to the plain versions on ragged shapes, and timed
in turns with the port's library: the port, each design, each design again in
reverse order, the port again, each time from a CUDA graph of 100 launches
(``chip_smoke.device_ms``).  It prints one JSON object for the builds and
checks, one a timed shape (milliseconds a launch, two times for each), and the
card's ``nvidia-smi`` line; a design that does not build or disagrees is
reported and not timed.
"""
from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DESIGNS = Path(__file__).resolve().parent / "mxu_designs"
NAMES = ("cluster_tile", "ring", "tile32", "bps2", "bps6", "bps8", "bps12", "prefetch2",
         "prefetch3")
SOURCES = ("mxu_support.cu", "pair_support.cu")

# B2 at K=16 and at the cluster path's K=64, B7 at the demo's I=100 and at the
# larger I of its checks, all over the thesis database's 15,625 words or less
B2_TIMED = ((16, 100, 15625), (64, 100, 15625))
B7_TIMED = ((100, 15625), (300, 15625), (1000, 4096))


def apply_diff(csrc: Path, diff: Path) -> None:
    """Apply each hunk of a unified diff by its exact text (it must occur once)."""
    target, old, new = None, [], []

    def flush():
        if old or new:
            path = csrc / target
            text, before = path.read_text(), "".join(old)
            if text.count(before) != 1:
                raise ValueError(f"{diff.name}: a hunk does not match {target} once")
            path.write_text(text.replace(before, "".join(new)))
        old.clear()
        new.clear()

    for line in diff.read_text().splitlines(keepends=True):
        if line.startswith("+++ b/"):
            target = line[6:].strip()
        elif line.startswith("--- ") or line.startswith("@@"):
            flush()
        elif line[:1] in " -":
            old.append(line[1:])
            if line[0] == " ":
                new.append(line[1:])
        elif line[:1] == "+":
            new.append(line[1:])
    flush()


def sources_of(name: str, base: Path, dest: Path) -> Path:
    """The design's sources: a copy of the port's ``base`` (its ``csrc``) in
    ``dest / name`` with the design laid over it."""
    csrc = dest / name
    if csrc.exists():
        shutil.rmtree(csrc)
    shutil.copytree(base, csrc)
    if (DESIGNS / name).is_dir():
        for f in (DESIGNS / name).iterdir():
            shutil.copy(f, csrc / f.name)
    else:
        apply_diff(csrc, DESIGNS / f"{name}.diff")
    return csrc


def build_all(build) -> tuple[dict, dict]:
    """Every design's library, built side by side; and the ones that failed."""
    nvcc, procs = build._nvcc(), {}
    for name in NAMES:
        csrc = sources_of(name, build.CSRC, build.BUILD_DIR.parent / "mxu_designs")
        procs[name] = [(csrc / f"{src}.o", subprocess.Popen(
            [nvcc, *build.NVCC_FLAGS, "-c", "-o", str(csrc / f"{src}.o"), str(csrc / src)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)) for src in SOURCES]
    libs, failed = {}, {}
    for name, objs in procs.items():
        outs = [(p.communicate()[0], p.returncode) for _, p in objs]
        if any(code for _, code in outs):
            failed[name] = "\n".join(out for out, code in outs if code)[-2000:]
            continue
        lib = objs[0][0].parent / "lib.so"
        subprocess.run([nvcc, *build.NVCC_FLAGS, "-shared", "-o", str(lib),
                        *(str(o) for o, _ in objs)], check=True)
        libs[name] = typed(ctypes.CDLL(str(lib)), build)
    return libs, failed


def typed(lib, build):
    for name in ("multi_extension_supports_mxu", "pair_supports_mxu"):
        fn = getattr(lib, name)
        fn.argtypes = list(build.SIGNATURES[name])
        fn.restype = ctypes.c_int
    return lib


def main() -> None:
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke
    from repro_torch.kernels import build
    from repro_torch.kernels import multi_support as ms
    from repro_torch.kernels import pair_support as ps

    if not torch.cuda.is_available():
        chip_smoke.fail("CUDA is not available")
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    libs, failed = build_all(build)
    libs["port"] = build.library()
    gen = torch.Generator(device=dev).manual_seed(0)

    def words(*shape):
        return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32, device=dev,
                             generator=gen)

    def b2(lib, items, tids):
        (I, W), K = items.shape, tids.shape[0]
        out = torch.empty((K, I), dtype=torch.int32, device=dev)
        status = lib.multi_extension_supports_mxu(
            items.data_ptr(), tids.data_ptr(), out.data_ptr(), K, I, W, sms,
            torch.cuda.current_stream().cuda_stream)
        build.check(status, "multi_extension_supports_mxu")
        return out

    def b7(lib, items, valid):
        I, W = items.shape
        out = torch.empty((I, I), dtype=torch.int32, device=dev)
        status = lib.pair_supports_mxu(items.data_ptr(), valid.data_ptr(), out.data_ptr(), I, W,
                                       sms, torch.cuda.current_stream().cuda_stream)
        build.check(status, "pair_supports_mxu")
        return out

    # every design bit-equal to the plain versions on ragged shapes
    cases = [(b2, (words(i, w), words(k, w)), ms.multi_extension_supports_mxu_plain)
             for k in (1, 16, 17, 64, 65) for i in (1, 9, 100, 129) for w in (1, 119, 15625)]
    for i in (1, 9, 100, 129, 300):
        for w in (1, 119, 15625):
            valid = words(w)
            valid[::3], valid[1::5], valid[-1] = -1, 0, (1 << 13) - 1
            cases.append((b7, (words(i, w), valid), ps.pair_supports_plain))
    wrong = {}
    for name, lib in libs.items():
        for kernel, args, plain in cases:
            try:
                same = torch.equal(kernel(lib, *args), plain(*args))
            except RuntimeError as e:
                same = False
                wrong.setdefault(name, []).append(str(e))
            if not same:
                wrong.setdefault(name, []).append([list(a.shape) for a in args])
    for name in wrong:
        libs.pop(name)
    if "port" not in libs:
        chip_smoke.fail(f"the port's B2 or B7 disagrees with its plain version: {wrong['port']}")
    print(json.dumps({"built": sorted(libs), "build_failed": failed, "checked": len(cases),
                      "disagree": {n: w[:5] for n, w in wrong.items()}}), flush=True)

    order = [n for n in NAMES if n in libs]
    order = ["port", *order, *order[::-1], "port"]
    timed = [("B2", {"K": k, "I": i, "W": w}, b2, (words(i, w), words(k, w)))
             for k, i, w in B2_TIMED]
    timed += [("B7", {"I": i, "W": w}, b7, (words(i, w), torch.full((w,), -1, dtype=torch.int32,
                                                                      device=dev)))
              for i, w in B7_TIMED]
    for kernel_name, shape, kernel, args in timed:
        ms_ = {}
        for name in order:
            ms_.setdefault(name, []).append(chip_smoke.device_ms(
                torch, lambda: kernel(libs[name], *args), launches=100))
        print(json.dumps({"kernel": kernel_name, "shape": shape, "ms": ms_}), flush=True)
    print(chip_smoke.nvidia_smi(), flush=True)


if __name__ == "__main__":
    main()

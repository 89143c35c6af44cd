#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA GPU.

  python3 chip_smoke.py

Run from the root of a checkout, on a machine with one card.  Every phase
prints one JSON object on a line of its own:

  device   the card (``nvidia-smi`` name and power limit), torch and CUDA;
  build    seconds to compile the kernels from ``src/repro_torch/kernels/csrc``
           (and the probes ``probes/bmma_rate.cu`` and
           ``probes/launch_floor.cu`` beside them), the tensor-core MMA
           instructions in B2's and B7's SASS, the 1-bit MMA's issue rate
           (the probe's register-only loop of ``mma_b1`` on one SM and on all
           of them, in MMAs an SM a clock), and the launch floor (an empty
           kernel of one block of 32 threads, timed as every kernel is);
  kernels  each kernel bit-equal to its plain torch version on ragged shapes
           and the main path's shapes (B1 also for K in {1, 7, 16, 17, 64}, I
           in {1, 100, 129} and W around its chunks and block sizes;
           B2 to B1's kernel too; B4 and B5 for Q, F, T in {1, 7, 129, 1000}
           and 1, 4, 9 and 40 item words, B5 also for both word forms, S in
           {1, 2, 3} and T, F off its tiles; B2 to its plain version and B1
           for K in {1, 15, 16, 17, 63, 64, 65, 129}, I in {1, 7, 8, 9, 100,
           127, 128, 129, 131} and W in {1, 7, 8, 9, 118, 119, 15625, 16384};
           B3 for I in {1, 9, 100, 131} and W around 64, 1024 and 8192;
           B6 and B7, and B7 to B6, for I in {1, 7, 8, 17, 33, 100, 131} and W
           in {1, 2, 33, 1025, 15625}, and for I in {1, 7, 8, 9, 100, 127,
           128, 129, 131, 300} and the W above, B6's edges (W around 512 and
           4096), under a valid mask with zero words and a ragged last
           word), with its device time, the plain
           version's, and the least time the card could take (``bound_ms``;
           for B2 and B7 with the MMAs at the rate measured in ``build``); for
           B1, B2, B3, B6 and B7 also one PyTorch call that computes the same
           product (``library_ms``); for B3 and B6 also the empty kernel at
           the same grid, threads and cluster (``empty_ms``);
  main     the launcher's path on the thesis database T500I0.1P50PL10TL40 at
           support 0.2, P=4, K=16, with the kernels' launch counts in that run;
  exact    the FITable on the card is the same for K in {1, 16, 64} and P in
           {1, 4} and with the DB-Repl-Min scheduler (whose profit matrix is
           B6, equal to the CPU's on the run's own tidlists and timed on
           them), equals the port's own CPU run on a 20k-row database, and
           equals brute force on T1I0.032P20PL6TL10 at 0.08;
  cluster  the cluster launcher's path (planner, rounds, rebalancing) on the
           thesis database at P=4, K=16: the same FITable as ``main``;
  cluster_mxu  the same with ``ClusterParams(use_mxu=True)`` at K=64: Phase 4
           on B2, one launch per DFS trip, B1 only in the planner; how many
           of B2's launches took each K and W (it fails if most of them take
           a shape at which ``kernels`` does not time B2);
  resume   on T20I0.1P50PL10TL40, a run killed after round 0 and resumed
           from its checkpoint gives the unbroken run's FITable, row for row,
           with B1 and with B2;
  serve    the mine-then-serve launcher's path on the thesis database at
           support 0.2 with its defaults (minconf 0.5, 1024 queries, batch
           256): the FITable of ``main``, R rules, QPS, batch latency, cache
           hit rate, B4's launches and the peak memory; every answer of the
           replay equals the same engine's on the CPU (B4's plain version);
           then B4 timed at the path's shapes, F = |F| and F = 2R;
  stream   the streaming launcher's path on the T…I0.1P50PL10TL40 family: a
           window of 8 blocks × 65,536 rows at support 0.2, 24 blocks with a
           drift at block 12: 0 torn-index failures, the delta-maintained
           supports equal to a full recompute after every block, a re-mine
           triggered by the drift, B4's and B5's launches; then B5 timed at
           the delta's shape, S=2, T=65,536, for the stream's last index and
           for F = |F| of the thesis database;
  profile_demo  the profiled demo mine on the thesis database at 0.2, P=4,
           with a run record (``--trace --profile``): measured time in all five
           dispatch families (B3, B1, B7, B4, B5), B7's output equal to B6's
           plain version, |F| of ``main``, the four phase spans in the trace;
  profile  the main path, both cluster paths and the serve replay once more
           under ``torch.profiler``: the card's busy time and share of the
           wall, and the kernels' share of that.
  launch_facts  how B1, B2, B3, B5, B6 and B7 were launched at each shape
           they were timed at: grid, threads, cluster size (B1, B3, B6),
           chunk, shared bytes, resident blocks an SM, waves, registers and
           spilled bytes a thread; it fails if B3 or B6 spills or takes more
           than one wave at a timed shape.

Then the ``{"kernels": [...], "launch_floor_ms": ...}`` summary, the
``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``.  Any failure exits non-zero before that
line.  Without CUDA, or outside a checkout, it exits 1 and prints no result.
The script imports nothing of JAX.
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import json
import shutil
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"
_P, _I = ctypes.c_void_p, ctypes.c_int
# the probes, each built into a library of its own: source, entry point and its
# argument types.  The 1-bit MMA's rate, for B2's and B7's bound; an empty
# kernel, the launch floor.
PROBES = {"bmma_rate": (ROOT / "probes" / "bmma_rate.cu", "bmma_issue_rate",
                        (_I, _I, _I, _P, _P, _P)),
          "launch_floor": (ROOT / "probes" / "launch_floor.cu", "empty_launch",
                           (_I, _I, _I, _P))}

THESIS_DB = "T500I0.1P50PL10TL40"
SUPPORT = 0.2
MID_DB = "T20I0.1P50PL10TL40"         # 20k rows, 100 items: also mined on the CPU
SMALL_DB, SMALL_SUPPORT = "T1I0.032P20PL6TL10", 0.08  # small enough for brute force

# The card's rates (memory, integer and POPC issue, int8 tensor cores) are
# those of ``repro_torch/obs/machine.py``, the one yardstick the port's
# profiler prices with too; the SM count is read from the device.

# The serving and streaming paths (launchers' defaults, thesis widths)
SERVE_ARGS = ["--db", THESIS_DB, "--support", str(SUPPORT)]
STREAM_ARGS = ["--db", THESIS_DB, "--support", str(SUPPORT), "--blocks", "8",
               "--blocktx", "65536", "--stream", "24", "--breaks", "12", "--minconf", "0.6",
               "--eps", "0.1", "--queries", "512", "--batch", "256"]

# Each kernel at the shape where its path spends its time in it: B1 in
# Phase 4 on the miners' slabs (K=16, W=15625 words), B3 in Phases 1 and 2 on
# the 2048-row sample (W=64), B2 in the cluster executor's Phase 4 at K=64,
# B7 at the profiled demo's I=100, W=15625; B6 on its own path, the
# DB-Repl-Min profit matrix of the run's classes over the sample's 64 words
# (its time at the demo's shape stands beside it).
# B2 is timed at K=16 and at the cluster path's K=64, where all its launches
# fall (``phase_cluster`` fails if most of them move elsewhere)
B2_TIMED = ((16, 100, 15625), (64, 100, 15625))
KERNELS = {
    "multi_extension_supports": {
        "replaces": "src/repro/kernels/multi_support.py:86", "main_shape": (16, 100, 15625),
        "source": "src/repro_torch/kernels/csrc/support.cu"},
    "extension_supports": {
        "replaces": "src/repro/kernels/bitmap_support.py:67", "main_shape": (1, 100, 64),
        "source": "src/repro_torch/kernels/csrc/support.cu"},
    "multi_extension_supports_mxu": {
        "replaces": "src/repro/kernels/multi_support.py:146", "main_shape": (64, 100, 15625),
        "source": "src/repro_torch/kernels/csrc/mxu_support.cu"},
    # B4 at the rules query (Q=256 against the [2R, IW] slab) and B5 at the
    # delta (S=2 blocks of 65,536 rows against |F|): shapes of the run
    "subset_superset_counts": {
        "replaces": "src/repro/kernels/subset_query.py:94", "main_shape": None,
        "source": "src/repro_torch/kernels/csrc/subset_query.cu"},
    "block_itemset_supports": {
        "replaces": "src/repro/kernels/delta_support.py:101", "main_shape": None,
        "source": "src/repro_torch/kernels/csrc/delta_support.cu"},
    "pair_supports": {
        "replaces": "src/repro/kernels/pair_support.py:74", "main_shape": None,
        "source": "src/repro_torch/kernels/csrc/pair_support.cu"},
    "pair_supports_mxu": {
        "replaces": "src/repro/kernels/pair_support.py:133", "main_shape": (100, 15625),
        "source": "src/repro_torch/kernels/csrc/pair_support.cu"},
}


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def device_ms(torch, fn, launches: int, reps: int = 7) -> float:
    """Median device time of one call of ``fn``, from CUDA events around a
    CUDA graph of ``launches`` calls (so host overhead is not in it).  The
    inputs stay in the 50 MB L2 from one call to the next, as the main path's
    item bitmaps do from one DFS trip to the next."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(launches):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        stop.record()
        stop.synchronize()
        times.append(start.elapsed_time(stop) / launches)
    return statistics.median(times)


def bound(K: int, I: int, W: int, sms: int):
    """Least time for ``S[k, i] = sum_w popc(items[i, w] & tids[k, w])``:
    each input word read once and each output written once, against one POPC
    per (k, i, w) at its own issue rate and one AND and one ADD at the 32-bit
    integer rate, whichever pipe takes longer."""
    return popc_bound(4 * (I * W + K * W + K * I), K * I * W, sms)


def popc_bound(n_bytes: int, n_popc: int, sms: int):
    """Least time to move ``n_bytes`` and issue ``n_popc`` POPC, each with an
    AND and an ADD beside it at the 32-bit integer rate."""
    from repro_torch.obs import machine as hw

    bytes_ms = n_bytes / hw.HBM_BYTES_PER_S * 1e3
    popc_ms = n_popc / (hw.POPC_PER_CLOCK_SM * sms * hw.SM_CLOCK_HZ) * 1e3
    alu_ms = 2 * n_popc / (hw.INT32_PER_CLOCK_SM * sms * hw.SM_CLOCK_HZ) * 1e3
    ops_ms = max(popc_ms, alu_ms)
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms else "operations"), n_bytes, n_popc


def mxu_bound(K: int, I: int, W: int, mma_per_s: float):
    """Least time for B2's product on the tensor cores: the packed bytes
    (each input word read once, each output written once) over the memory
    rate, or the product's K·I·32·W bit products in 1-bit MMAs (m16n8k256,
    32,768 products each) at ``mma_per_s``, the rate this run measured (the
    data sheet gives none for the 1-bit form B2 uses)."""
    return mma_bound(4 * (I * W + K * W + K * I), K * I * W / 1024, mma_per_s)


def mma_bound(n_bytes: int, n_mma: float, mma_per_s: float):
    """Least time to move ``n_bytes`` and issue ``n_mma`` 1-bit MMAs at
    ``mma_per_s``, whichever takes longer."""
    from repro_torch.obs import machine as hw

    bytes_ms = n_bytes / hw.HBM_BYTES_PER_S * 1e3
    mma_ms = n_mma / mma_per_s * 1e3
    return max(bytes_ms, mma_ms), ("bytes" if bytes_ms >= mma_ms else "operations"), n_bytes, n_mma


def int8_bound_ms(n_bytes: int, n_mma: float) -> float:
    """The bound with each MMA's 65,536 operations on 0/1 values priced at the
    tensor cores' dense int8 rate instead: below the card's 1-bit rate, so it
    is reported beside the bound, not as it."""
    from repro_torch.obs import machine as hw

    return max(n_bytes / hw.HBM_BYTES_PER_S, n_mma * 65536 / hw.INT8_TENSOR_OPS_PER_S) * 1e3


def pair_bound(I: int, W: int, sms: int, mma_per_s: float | None = None):
    """Least time for B6's or B7's ``[I, I]`` counts: the item words and the
    valid mask read once and the output written once, against the work of the
    I(I+1)/2 distinct pairs (S is symmetric): a POPC per pair and word for B6,
    32 bit products per pair and word in 1-bit MMAs at the measured
    ``mma_per_s`` for B7 (given only for B7)."""
    n_bytes = 4 * (I * W + W + I * I)
    pairs = I * (I + 1) // 2
    if mma_per_s:
        return mma_bound(n_bytes, pairs * W / 1024, mma_per_s)
    return popc_bound(n_bytes, pairs * W, sms)


def subset_bound(Q: int, F: int, IW: int, sms: int):
    """Least time for B4's two ``[Q, F]`` counts: each input word read once
    and both int32 outputs written once, against two POPC per (q, f, w) at
    their issue rate, whichever takes longer."""
    from repro_torch.obs import machine as hw

    n_bytes = 4 * IW * (Q + F) + 8 * Q * F
    n_popc = 2 * Q * F * IW
    bytes_ms = n_bytes / hw.HBM_BYTES_PER_S * 1e3
    popc_ms = n_popc / (hw.POPC_PER_CLOCK_SM * sms * hw.SM_CLOCK_HZ) * 1e3
    by = "bytes" if bytes_ms >= popc_ms else "operations"
    return max(bytes_ms, popc_ms), by, n_bytes, n_popc


def block_bound(S: int, T: int, F: int, IW: int, sms: int):
    """Least time for B5's ``[S, F]`` counts: each input word read once and
    each output written once, against the containment test, which needs one
    32-bit logic operation per (s, t, f, w) (an AND-NOT folded into an OR, a
    LOP3) at the integer rate, and no population count."""
    from repro_torch.obs import machine as hw

    n_bytes = 4 * IW * (S * T + F) + 4 * S * F
    n_ops = S * T * F * IW
    bytes_ms = n_bytes / hw.HBM_BYTES_PER_S * 1e3
    ops_ms = n_ops / (hw.INT32_PER_CLOCK_SM * sms * hw.SM_CLOCK_HZ) * 1e3
    by = "bytes" if bytes_ms >= ops_ms else "operations"
    return max(bytes_ms, ops_ms), by, n_bytes, n_ops


def cuobjdump() -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/cuobjdump")
    if not default.exists():
        fail("cuobjdump not found: B2's SASS cannot be read")
    return str(default)


def sass_of(lib_path: Path, symbol: str) -> str:
    """The SASS of the one function in the library whose name holds ``symbol``."""
    out = subprocess.run([cuobjdump(), "-sass", str(lib_path)], capture_output=True,
                         text=True, timeout=120)
    if out.returncode != 0:
        fail(f"cuobjdump -sass failed: {out.stderr.strip()}")
    sections = out.stdout.split("Function : ")[1:]
    found = [sec for sec in sections if symbol in sec.splitlines()[0]]
    if len(found) != 1:
        fail(f"{len(found)} functions named like {symbol} in {lib_path.name}")
    return found[0]


def start_probe_build(build, name):
    """Start ``nvcc`` on the source of the probe ``PROBES[name]``, which is not
    part of the port's library, into a library of its own; returns the process
    and the library's path."""
    lib = build.BUILD_DIR / f"lib{name}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib.unlink(missing_ok=True)
    cmd = [build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-shared", "-o", str(lib),
           str(PROBES[name][0])]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib


def load_probe(name, proc, lib_path):
    """The probe's library once its build has ended, with its entry point
    typed."""
    source, entry, argtypes = PROBES[name]
    out = proc.communicate()[0]
    if proc.returncode != 0:
        fail(f"nvcc failed on {source.relative_to(ROOT)}:\n{out}")
    lib = ctypes.CDLL(str(lib_path))
    fn = getattr(lib, entry)
    fn.argtypes = list(argtypes)
    fn.restype = ctypes.c_int
    return lib


def empty_ms(torch, build, floor, blocks, threads, cluster):
    """Device time of one launch of the empty kernel (``probes/launch_floor.cu``)
    over ``blocks`` blocks of ``threads`` threads in clusters of ``cluster``,
    timed as every kernel is (``device_ms``, a graph of 100 launches)."""
    def launch():
        build.check(floor.empty_launch(blocks, threads, cluster,
                                       torch.cuda.current_stream().cuda_stream), "empty_launch")

    return device_ms(torch, launch, launches=100)


def mma_rate(torch, build, probe, sms):
    """The issue rate of the 1-bit MMA ``mma_b1`` alone: the probe's
    ``bmma_issue_rate`` runs 16 warps a block, each 4096 rounds of 8
    independent MMAs on registers, on one block (one SM) and on one block an
    SM; each block reads its SM clocks, and CUDA events time the whole
    launch.  An MMA is m16n8k256: 16·8·256 products of bits, 65,536
    operations at the int8 pricing."""
    from repro_torch.obs import machine as hw

    threads, iters = 512, 4096
    mmas = threads // 32 * iters * 8
    out = {}
    for label, blocks in (("one_sm", 1), ("all_sms", sms)):
        cycles = torch.zeros(blocks, dtype=torch.int64, device="cuda")
        sink = torch.zeros(1, dtype=torch.int32, device="cuda")

        def launch():
            build.check(probe.bmma_issue_rate(
                blocks, threads, iters, cycles.data_ptr(), sink.data_ptr(),
                torch.cuda.current_stream().cuda_stream), "bmma_issue_rate")

        launch()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        start.record()
        launch()
        stop.record()
        stop.synchronize()
        ms_ = start.elapsed_time(stop)
        per_clock = mmas / cycles.double()
        out[label] = {"blocks": blocks, "threads": threads, "mmas_a_block": mmas,
                      "mma_per_sm_clock": float(per_clock.mean()),
                      "mma_per_sm_clock_min": float(per_clock.min()), "ms": ms_,
                      "mma_per_s": blocks * mmas / (ms_ * 1e-3),
                      "ops_per_s": blocks * mmas * 65536 / (ms_ * 1e-3)}
    out["int8_ops_per_s"] = hw.INT8_TENSOR_OPS_PER_S
    return out


def phase_kernels(torch, dev, mma_per_s):
    """Each kernel against its plain version on ragged shapes, then timed;
    ``mma_per_s`` is the measured rate of the 1-bit MMA on the whole card."""
    from repro_torch.kernels import bitmap_support as bs
    from repro_torch.kernels import multi_support as ms

    gen = torch.Generator(device=dev).manual_seed(0)

    def words(*shape):
        return torch.randint(-(2**31), 2**31, shape, dtype=torch.int32, device=dev,
                             generator=gen)

    multi_shapes = [(1, 7, 2), (3, 16, 1), (8, 33, 9), (13, 40, 130), (5, 130, 33),
                    (64, 24, 17), (17, 131, 4097), (9, 5, 1025), (0, 10, 8), (4, 0, 8),
                    (4, 10, 0), (1, 100, 15625), (16, 100, 64), (16, 100, 15625),
                    (64, 100, 15625)]
    # B1's edges: W around its chunks and the switch to 512-thread blocks, K
    # and I around the 8 x 4 tile; clusters of 1 to 8
    multi_shapes += [(k, i, w) for k in (1, 7, 16, 17, 64) for i in (1, 100, 129)
                     for w in (1, 3, 5, 4096, 4097, 15625, 16384, 16385)]
    single_shapes = [(7, 2), (16, 1), (33, 9), (130, 33), (53, 300), (257, 4097),
                     (1, 1), (0, 9), (9, 0), (100, 64), (100, 15625)]
    # B3's edges: I around its row groups, W around its launch shapes (64
    # and 8192 words) and its chunks of 1024
    single_shapes += [(i, w) for i in (1, 9, 100, 131)
                      for w in (63, 65, 1025, 8191, 8192, 8193, 16385)]
    for K, I, W in multi_shapes:
        items, tids = words(I, W), words(K, W)
        got = ms.multi_extension_supports_cuda(items, tids)
        if not torch.equal(got, ms.multi_extension_supports_plain(items, tids)):
            fail(f"multi_extension_supports differs from its plain version at K={K} I={I} W={W}")
    for I, W in single_shapes:
        items, tid = words(I, W), words(W)
        got = bs.extension_supports_cuda(items, tid)
        if not torch.equal(got, bs.extension_supports_plain(items, tid)):
            fail(f"extension_supports differs from its plain version at I={I} W={W}")
    mxu_shapes = [(K, I, W) for K in (1, 13, 16, 17, 64) for I in (1, 7, 8, 33, 100, 131)
                  for W in (1, 2, 33, 1025)] + [(0, 10, 8), (4, 0, 8), (4, 10, 0)]
    # B2's edges: K around its m-tiles of 16 and tiles of 64, I around its
    # n-tiles of 8 and tiles, W around its slots and chunks, odd and 1 mod 4
    mxu_shapes += [(K, I, W) for K in (1, 15, 16, 17, 63, 64, 65, 129)
                   for I in (1, 7, 8, 9, 100, 127, 128, 129, 131)
                   for W in (1, 7, 8, 9, 118, 119, 15625, 16384)]
    for K, I, W in mxu_shapes:
        items, tids = words(I, W), words(K, W)
        got = ms.multi_extension_supports_mxu_cuda(items, tids)
        if not torch.equal(got, ms.multi_extension_supports_mxu_plain(items, tids)):
            fail(f"multi_extension_supports_mxu differs from its plain version at "
                 f"K={K} I={I} W={W}")
        if not torch.equal(got, ms.multi_extension_supports_cuda(items, tids)):
            fail(f"multi_extension_supports_mxu differs from B1's kernel at K={K} I={I} W={W}")
    n_sweep = check_sweeps(torch, words, dev, gen)
    n_pair = check_pairs(torch, words)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    torch.cuda.synchronize()

    def timed(name, kernel, plain, K, I, W, args):
        out = kernel(*args)
        err = int((out.long() - plain(*args).long()).abs().max())
        b_ms, b_by, n_bytes, n_popc = bound(K, I, W, sms)
        # B3 is B1 at K=1: the same product with one tidlist
        items, tids = args[0], args[1].reshape(K, W)
        lib = library_call(torch, items, tids, out.reshape(K, I))
        facts = ms.launch_facts(items, tids) if kernel is ms.multi_extension_supports_cuda \
            else bs.launch_facts(*args)
        return {"name": name, "shape": {"K": K, "I": I, "W": W}, "max_abs_err": err,
                "launch": facts,
                "ms": device_ms(torch, lambda: kernel(*args), launches=100),
                "plain_ms": device_ms(torch, lambda: plain(*args), launches=5, reps=3),
                "library_ms": lib["ms"], "library": lib,
                "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes, "popc": n_popc}

    timings = []
    for K, W in ((16, 15625), (16, 64), (16, 16384), (1, 15625), (64, 15625)):
        timings.append(timed("multi_extension_supports", ms.multi_extension_supports_cuda,
                             ms.multi_extension_supports_plain, K, 100, W,
                             (words(100, W), words(K, W))))
    for W in (64, 15625):
        timings.append(timed("extension_supports", bs.extension_supports_cuda,
                             bs.extension_supports_plain, 1, 100, W,
                             (words(100, W), words(W))))
    for K, I, W in B2_TIMED:
        timings.append(time_mxu(torch, words(I, W), words(K, W), mma_per_s))
    # both at the demo's shape, every transaction valid as in the demo's
    # whole database (B6's own path, repl_min, is timed in ``phase_exact``)
    for mxu in (False, True):
        timings.append(time_pair(torch, words(100, 15625),
                                 torch.full((15625,), -1, dtype=torch.int32, device=dev),
                                 sms, mxu, mma_per_s))
    if any(t["max_abs_err"] or t.get("library", {}).get("max_abs_err") for t in timings):
        fail(f"a timed kernel or its library call disagrees with its plain version: {timings}")
    emit({"phase": "kernels",
          "checked_shapes": len(multi_shapes) + len(single_shapes) + len(mxu_shapes) + n_sweep
          + n_pair, "bit_equal": True, "timed": timings})
    return timings


def time_mxu(torch, items, tids, mma_per_s):
    """B2 on these operands: device time, the plain version's and B1's, the
    bound at the measured 1-bit MMA rate ``mma_per_s`` (and the int8-priced
    one beside it), its launch facts, and ``torch._int_mm`` as the
    yardstick."""
    from repro_torch.kernels import multi_support as ms

    (I, W), K = items.shape, tids.shape[0]
    out = ms.multi_extension_supports_mxu_cuda(items, tids)
    err = int((out.long() - ms.multi_extension_supports_mxu_plain(items, tids).long()).abs().max())
    b_ms, b_by, n_bytes, n_mma = mxu_bound(K, I, W, mma_per_s)
    lib = library_call(torch, items, tids, out)
    return {"name": "multi_extension_supports_mxu", "shape": {"K": K, "I": I, "W": W},
            "max_abs_err": err, "launch": ms.mxu_launch_facts(items, tids),
            "ms": device_ms(torch, lambda: ms.multi_extension_supports_mxu_cuda(items, tids),
                            launches=100),
            "plain_ms": device_ms(torch, lambda: ms.multi_extension_supports_mxu_plain(
                items, tids), launches=3, reps=3),
            "b1_ms": device_ms(torch, lambda: ms.multi_extension_supports_cuda(items, tids),
                               launches=100),
            "library_ms": lib["ms"], "library": lib,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes, "mma": n_mma,
            "mma_ms": n_mma / mma_per_s * 1e3, "int8_bound_ms": int8_bound_ms(n_bytes, n_mma)}


def check_sweeps(torch, words, dev, gen) -> int:
    """B4 and B5 bit-equal to their plain versions for Q, F and T in {1, 7,
    129, 1000} and 1, 4 (100 items), 9 and 40 item words, with ∅ the first
    itemset, plus empty axes and a mask of 300 words; returns the count."""
    from repro_torch.kernels import delta_support as ds
    from repro_torch.kernels import subset_query as sq

    def sets_of(rows, n):
        """``n`` itemsets: ∅, subsets and supersets of random rows, and
        random words, so every count, zero included, occurs."""
        iw = rows.shape[-1]
        flat = rows.flatten(0, -2)
        sets = words(n, iw)
        if n and flat.shape[0]:
            picked = flat[torch.randint(0, flat.shape[0], (n,), device=dev, generator=gen)]
            sparse = words(n, iw) & words(n, iw) & words(n, iw)
            kind = (torch.arange(n, device=dev) % 3)[:, None]
            sets = torch.where(kind == 1, picked & sparse,
                               torch.where(kind == 2, picked | sparse, sets))
        if n:
            sets[0] = 0
        return sets.contiguous()

    sizes, widths = (1, 7, 129, 1000), (1, 4, 9, 40)
    subset_shapes = [(q, f, iw) for q in sizes for f in sizes for iw in widths] + [
        (0, 5, 4), (5, 0, 4), (3, 5, 0)]
    for Q, F, IW in subset_shapes:
        queries = words(Q, IW)
        sets = sets_of(queries, F)
        got = sq.subset_superset_counts_cuda(queries, sets)
        want = sq.subset_superset_counts_plain(queries, sets)
        if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
            fail(f"subset_superset_counts differs from its plain version at Q={Q} F={F} IW={IW}")
    block_shapes = [(b, t, f, iw) for b in (1, 2) for t in sizes for f in sizes
                    for iw in widths] + [(2, 0, 5, 4), (2, 4, 0, 4), (1, 33, 7, 0),
                                         (3, 50, 20, 300)]
    # B5's edges: both word forms (IW <= 4, wider), T off the row tile
    # and a block's rows, F off a block's itemsets, S = 1 to 3
    block_shapes += [(b, t, f, iw) for b in (1, 2, 3) for iw in (1, 3, 4, 5, 8, 9, 33)
                     for t, f in ((70001, 1025), (257, 3))]
    for S, T, F, IW in block_shapes:
        tx = words(S, T, IW) | words(S, T, IW)
        sets = sets_of(tx, F)
        got = ds.block_itemset_supports_cuda(tx, sets)
        if not torch.equal(got, ds.block_itemset_supports_plain(tx, sets)):
            fail(f"block_itemset_supports differs from its plain version at S={S} T={T} F={F} "
                 f"IW={IW}")
        if F and not bool((got[:, 0] == T).all()):
            fail(f"block_itemset_supports: the empty itemset missed rows at S={S} T={T} IW={IW}")
    return len(subset_shapes) + len(block_shapes)


def check_pairs(torch, words) -> int:
    """B6 and B7 bit-equal to their plain versions, and B7 to B6, for I in
    {1, 7, 8, 17, 33, 100, 131} and W in {1, 2, 33, 1025, 15625}, for B7's
    edges (I in {1, 7, 8, 9, 100, 127, 128, 129, 131, 300}, W in {1, 7, 8, 9,
    118, 119, 15625, 16384}), for B6's (I in {9, 100, 131}, W in {511, 512,
    1025, 4095, 4096, 4097}), plus empty I and W, under a valid mask with
    whole words, zero words and a ragged last word; returns the count."""
    from repro_torch.kernels import pair_support as ps

    shapes = [(i, w) for i in (1, 7, 8, 17, 33, 100, 131) for w in (1, 2, 33, 1025, 15625)]
    shapes += [(i, w) for i in (1, 7, 8, 9, 100, 127, 128, 129, 131, 300)
               for w in (1, 7, 8, 9, 118, 119, 15625, 16384)]
    # B6's edges: W around its block sizes (512 words) and clusters (1024, 4096)
    shapes += [(i, w) for i in (9, 100, 131) for w in (511, 512, 1025, 4095, 4096, 4097)]
    shapes += [(0, 8), (9, 0)]
    for I, W in shapes:
        items, valid = words(I, W), words(W)
        valid[::3] = -1
        valid[1::5] = 0
        if W:
            valid[-1] = (1 << 13) - 1
        got = ps.pair_supports_cuda(items, valid)
        got_mxu = ps.pair_supports_mxu_cuda(items, valid)
        if not torch.equal(got, ps.pair_supports_plain(items, valid)):
            fail(f"pair_supports differs from its plain version at I={I} W={W}")
        if not torch.equal(got_mxu, ps.pair_supports_mxu_plain(items, valid)):
            fail(f"pair_supports_mxu differs from its plain version at I={I} W={W}")
        if not torch.equal(got_mxu, got):
            fail(f"pair_supports_mxu differs from pair_supports at I={I} W={W}")
    return len(shapes)


def time_pair(torch, items, valid, sms, mxu, mma_per_s=None):
    """B6 or B7 on ``items`` under ``valid``, with its launch facts and
    ``torch._int_mm`` of the masked bits with themselves as the yardstick; for
    B7 also its bound at the measured 1-bit MMA rate ``mma_per_s`` and the
    int8-priced one beside it."""
    from repro_torch.kernels import pair_support as ps

    kernel = ps.pair_supports_mxu_cuda if mxu else ps.pair_supports_cuda
    plain = ps.pair_supports_mxu_plain if mxu else ps.pair_supports_plain
    I, W = items.shape
    out = kernel(items, valid)
    err = int((out.long() - plain(items, valid).long()).abs().max())
    b_ms, b_by, n_bytes, n_ops = pair_bound(I, W, sms, mma_per_s if mxu else None)
    masked = items & valid
    lib = library_call(torch, masked, masked, out)
    extra = {"launch": ps.mxu_launch_facts(items, valid), "mma_ms": n_ops / mma_per_s * 1e3,
             "int8_bound_ms": int8_bound_ms(n_bytes, n_ops)} if mxu \
        else {"launch": ps.launch_facts(items, valid)}
    return {"name": "pair_supports_mxu" if mxu else "pair_supports",
            "shape": {"I": I, "W": W}, "max_abs_err": err, **extra,
            "ms": device_ms(torch, lambda: kernel(items, valid), launches=100),
            "plain_ms": device_ms(torch, lambda: plain(items, valid), launches=3, reps=3),
            "library_ms": lib["ms"], "library": lib,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes,
            ("mma" if mxu else "popc"): n_ops}


def time_subset(torch, queries, sets, sms):
    """B4 at one shape of the serving path: device time, the plain version's,
    the bound, and ``torch._int_mm`` as the yardstick."""
    from repro_torch.kernels import subset_query as sq

    (Q, IW), F = queries.shape, sets.shape[0]
    miss, extra = sq.subset_superset_counts_cuda(queries, sets)
    p_miss, p_extra = sq.subset_superset_counts_plain(queries, sets)
    err = max(int((miss.long() - p_miss.long()).abs().max()),
              int((extra.long() - p_extra.long()).abs().max()))
    del p_miss, p_extra
    b_ms, b_by, n_bytes, n_popc = subset_bound(Q, F, IW, sms)
    lib = subset_library(torch, queries, sets, miss, extra)
    return {"name": "subset_superset_counts", "shape": {"Q": Q, "F": F, "IW": IW},
            "max_abs_err": err,
            "ms": device_ms(torch, lambda: sq.subset_superset_counts_cuda(queries, sets),
                            launches=20),
            "plain_ms": device_ms(torch, lambda: sq.subset_superset_counts_plain(queries, sets),
                                  launches=3, reps=3),
            "library_ms": lib["ms"], "library": lib,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes, "popc": n_popc}


def subset_library(torch, queries, sets, miss, extra):
    """B4's yardstick: one ``torch._int_mm`` on the 0/1 bits unpacked to int8
    beforehand gives |q ∩ f|; then miss = |f| − |q ∩ f| and extra = |q| −
    |q ∩ f|, checked against the kernel.  Neither the unpack nor the two
    subtractions are in its time, and the port never calls it."""
    from repro_torch.kernels.multi_support import unpack_bits

    Q, F = miss.shape
    a = unpack_bits(queries).to(torch.int8)
    b = torch.zeros((-(-F // 8) * 8, a.shape[1]), dtype=torch.int8, device=sets.device)
    b[:F] = unpack_bits(sets).to(torch.int8)
    bt = b.t()
    out = {"call": "torch._int_mm (int8, int32 out)", "shape": [Q, a.shape[1], b.shape[0]],
           "unpack_included": False}
    try:
        inter = torch._int_mm(a, bt)[:, :F]
    except RuntimeError as e:   # a shape the library refuses: no yardstick
        return {**out, "ms": None, "error": str(e).splitlines()[0]}
    f_size = b[:F].sum(dim=1, dtype=torch.int32)[None, :]
    q_size = a.sum(dim=1, dtype=torch.int32)[:, None]
    err = max(int((f_size - inter - miss).abs().max()), int((q_size - inter - extra).abs().max()))
    return {**out, "max_abs_err": err, "ms": device_ms(torch, lambda: torch._int_mm(a, bt),
                                                       launches=20)}


def time_block(torch, tx, sets, sms):
    """B5 at one shape of the streaming path: device time, the plain
    version's and the bound; no single PyTorch call counts the rows that
    contain each itemset, so there is no yardstick."""
    from repro_torch.kernels import delta_support as ds

    (S, T, IW), F = tx.shape, sets.shape[0]
    out = ds.block_itemset_supports_cuda(tx, sets)
    err = int((out.long() - ds.block_itemset_supports_plain(tx, sets).long()).abs().max())
    b_ms, b_by, n_bytes, n_ops = block_bound(S, T, F, IW, sms)
    return {"name": "block_itemset_supports", "shape": {"S": S, "T": T, "F": F, "IW": IW},
            "max_abs_err": err, "launch": ds.launch_facts(tx, sets),
            "ms": device_ms(torch, lambda: ds.block_itemset_supports_cuda(tx, sets), launches=20),
            "plain_ms": device_ms(torch, lambda: ds.block_itemset_supports_plain(tx, sets),
                                  launches=2, reps=3),
            "library_ms": None,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": n_bytes, "logic_ops": n_ops}


def library_call(torch, items, tids, want):
    """The yardstick of B1, B2, B3 (K=1), B6 and B7 (both operands the masked
    items): one PyTorch call that computes the same product on
    operands unpacked beforehand (the unpack is not in its time, and the port
    never calls it).  ``torch._int_mm`` (int8 in, int32 out) where its shape
    rules allow, with the rows padded to more than 16 and the columns to a
    multiple of 8; else a bf16 ``torch.mm`` with float32 output."""
    from repro_torch.kernels.multi_support import unpack_bits

    K, I = want.shape
    Kp, Ip = max(32, -(-K // 8) * 8), -(-I // 8) * 8
    a = torch.zeros((Kp, tids.shape[1] * 32), dtype=torch.int8, device=tids.device)
    b = torch.zeros((Ip, items.shape[1] * 32), dtype=torch.int8, device=items.device)
    a[:K] = unpack_bits(tids).to(torch.int8)
    b[:I] = unpack_bits(items).to(torch.int8)
    bt = b.t()
    try:
        got = torch._int_mm(a, bt)
        call, fn = "torch._int_mm (int8, int32 out)", lambda: torch._int_mm(a, bt)
    except RuntimeError:
        a16, b16 = a.to(torch.bfloat16), bt.to(torch.bfloat16)
        got = torch.mm(a16, b16, out_dtype=torch.float32)
        call = "torch.mm (bf16, float32 out)"

        def fn():
            return torch.mm(a16, b16, out_dtype=torch.float32)
    err = int((got[:K, :I].double() - want.double()).abs().max())
    return {"call": call, "shape": [Kp, a.shape[1], Ip], "max_abs_err": err,
            "unpack_included": False, "ms": device_ms(torch, fn, launches=20)}


def launch_counts():
    from repro_torch.kernels import ops

    return ops.kernel_launches()


def reset_launch_counts():
    from repro_torch.kernels import bitmap_support as bs
    from repro_torch.kernels import multi_support as ms

    from repro_torch.kernels import delta_support as ds
    from repro_torch.kernels import pair_support as ps
    from repro_torch.kernels import subset_query as sq

    ms.multi_extension_supports_cuda.launches = 0
    ms.multi_extension_supports_mxu_cuda.launches = 0
    bs.extension_supports_cuda.launches = 0
    sq.subset_superset_counts_cuda.launches = 0
    ds.block_itemset_supports_cuda.launches = 0
    ps.pair_supports_cuda.launches = 0
    ps.pair_supports_mxu_cuda.launches = 0


def phase_main(torch, dev, dense, db_name, gen_s):
    """The launcher's path once, with the launch counts of exactly that run."""
    from repro_torch.launch import mine

    print(f"{db_name} |D|={dense.shape[0]} |B|={dense.shape[1]} sup={SUPPORT} P=4 "
          f"frontier=16 device={dev}  (generated in {gen_s:.2f}s)", flush=True)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res, wall_s = mine.mine_dense(dense, support=SUPPORT, P=4, frontier=16, device=dev)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated() if dev.type == "cuda" else None
    mine.report(res, wall_s)
    others = {k: n for k, n in launches.items()
              if k not in ("multi_extension_supports", "extension_supports")}
    if launches["multi_extension_supports"] <= 0 or launches["extension_supports"] <= 0 \
            or any(others.values()):
        fail(f"the main path did not launch B1 and B3 alone: {launches}")
    if res.launches != launches:
        fail(f"the run counted {res.launches} launches, its wrappers {launches}")
    if res.n_fis <= 0 or res.exchange_overflow or res.phase1_overflow.any() \
            or res.phase4_overflow.any():
        fail("the main path overflowed or found nothing")
    emit({"phase": "main", "db": db_name, "n_tx": int(dense.shape[0]),
          "n_items": int(dense.shape[1]), "support": SUPPORT, "P": 4, "K": 16,
          "generate_s": gen_s, "n_fis": res.n_fis, "classes": len(res.classes),
          "replication": res.replication, "exchange_overflow": res.exchange_overflow,
          "phase1_trips": res.phase1_iters.tolist(), "phase4_trips": res.work_iters.tolist(),
          "phase_s": res.phase_s, "wall_s": wall_s, "peak_mem_bytes": peak,
          "launches": launches})
    return res, launches


def same_answer(a, b) -> bool:
    """One query's answer in two runs: a support, or (rows, values) with
    float32 confidences bit-equal and NaN in the same slots."""
    if not isinstance(a, tuple):
        return int(a) == int(b)
    rows_a, rows_b = np.asarray(a[0]), np.asarray(b[0])
    va, vb = np.asarray(a[1]), np.asarray(b[1])
    if va.dtype != vb.dtype or not np.array_equal(rows_a, rows_b):
        return False
    if va.dtype == np.float32:
        return (np.array_equal(np.isnan(va), np.isnan(vb))
                and np.array_equal(np.nan_to_num(va).view(np.uint32),
                                   np.nan_to_num(vb).view(np.uint32)))
    return np.array_equal(va, vb)


def phase_serve(torch, dev, dense, want, sms):
    """The mine-then-serve launcher's path once, with the launch counts and
    peak memory of exactly that run; every answer of the replay held against
    the same engine on the CPU (B4's plain version), answer for answer; then
    B4 timed at the path's shapes with the replay's first batch of queries."""
    from repro_torch.core.rules import int32_words
    from repro_torch.launch import serve_mine
    from repro_torch.serve import QueryCache, QueryEngine

    args = serve_mine.build_parser().parse_args(SERVE_ARGS)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    run = serve_mine.run(dense, args, dev)
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if run.fis != want:
        fail(f"serve: the FITable ({len(run.fis)}) differs from main's ({len(want)})")
    if launches["subset_superset_counts"] <= 0 or launches["block_itemset_supports"] \
            or launches["subset_superset_counts"] != run.launches["subset_superset_counts"]:
        fail(f"serve: B4 must carry every query and B5 none: {launches}, run {run.launches}")

    t0 = time.perf_counter()
    cpu = QueryEngine(run.fi_index.to("cpu"), run.rule_index.to("cpu"), batch=args.batch,
                      top_k=args.topk, cache=QueryCache(args.cache))
    serve_mine.warm(run.stream, cpu)
    _, n_cpu, cpu_answers = serve_mine.replay(run.stream, cpu, cpu.cache, args.batch)
    cpu_s = time.perf_counter() - t0
    differ = [i for i, (a, b) in enumerate(zip(run.answers, cpu_answers)) if not same_answer(a, b)]
    if differ or n_cpu != run.n_dispatched or len(cpu_answers) != len(run.answers):
        fail(f"serve: {len(differ)} answers differ from the CPU engine's (first {differ[:5]}), "
             f"{run.n_dispatched} dispatched against {n_cpu}")

    queries = torch.from_numpy(int32_words(np.stack([m for _, m in run.stream[:args.batch]])))
    queries = queries.to(dev)
    timings = [time_subset(torch, queries, run.fi_index.masks, sms),
               time_subset(torch, queries, run.rule_index.ant_con, sms)]
    if any(t["max_abs_err"] for t in timings):
        fail(f"serve: B4 disagrees with its plain version at the path's shapes: {timings}")
    lat = np.asarray(run.latencies) * 1e3
    s = run.cache.stats
    emit({"phase": "serve", "db": THESIS_DB, "support": SUPPORT, "minconf": args.minconf,
          "queries": len(run.stream), "batch": args.batch, "topk": args.topk,
          "n_fis": run.fi_index.n_fis, "n_rules": run.rule_index.n_rules,
          "mine_s": run.mine_s, "index_s": run.index_s, "serve_s": run.serve_s,
          "qps": len(run.stream) / run.serve_s,
          "batch_ms": {"p50": float(np.percentile(lat, 50)), "p95": float(np.percentile(lat, 95)),
                       "p99": float(np.percentile(lat, 99)), "max": float(lat.max())},
          "cache_hit_rate": s.hit_rate, "dispatched": run.n_dispatched,
          "answers_equal_cpu": True, "cpu_replay_s": cpu_s, "wall_s": wall_s,
          "peak_mem_bytes": peak, "launches": launches, "timed": timings})
    return run, launches, timings


def phase_stream(torch, dev, sms, thesis_masks):
    """The streaming launcher's path once, with the launch counts of exactly
    that run, then B5 timed at the delta's shape, S=2 blocks of the window
    (its two newest), against the last index the stream served and against
    ``thesis_masks``, the thesis database's |F| itemsets: the size of the
    stream's indexes before the drift, whose deltas take the longest."""
    from repro_torch.launch import stream_mine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    res = stream_mine.main(STREAM_ARGS + ["--device", dev.type])
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if res is None:
        fail("stream: the window never filled")
    sm = res.miner
    n_blocks = int(STREAM_ARGS[STREAM_ARGS.index("--stream") + 1])
    window = int(STREAM_ARGS[STREAM_ARGS.index("--blocks") + 1])
    if res.torn or res.delta_mismatches or res.delta_checks != n_blocks - window + 1:
        fail(f"stream: {res.torn} torn-index failures, {res.delta_mismatches} of "
             f"{res.delta_checks} blocks with delta supports unequal to the recompute")
    drift = [r for r in res.remine_log if r[1] >= 1 and r[2] in ("error", "border")]
    if not drift:
        fail(f"stream: no drift-triggered re-mine after the break: {res.remine_log}")
    if res.launches != launches or launches["subset_superset_counts"] <= 0 \
            or launches["block_itemset_supports"] <= 0:
        fail(f"stream: B4 and B5 must both launch: {launches}, run {res.launches}")

    idx = sm.engine.index
    newest = sm.window.stacked()[-2:].contiguous()
    timings = [time_block(torch, newest, idx.masks[: idx.n_fis], sms),
               time_block(torch, newest, thesis_masks, sms)]
    if any(t["max_abs_err"] for t in timings):
        fail(f"stream: B5 disagrees with its plain version at the delta's shape: {timings}")
    st = sm.stats
    emit({"phase": "stream", "db_family": THESIS_DB, "argv": STREAM_ARGS,
          "window_rows": sm.window.n_tx, "blocks": st.blocks_in, "tx_in": st.tx_in,
          "ingest_s": res.ingest_s, "ingest_rows_per_s": st.tx_in / res.ingest_s,
          "remines": st.remines,
          "remines_by_reason": {"initial": st.remines - st.fired_error - st.fired_border
                                - st.fired_recovery, "error": st.fired_error,
                                "border": st.fired_border, "recovery": st.fired_recovery},
          "remine_log": [{"block": b, "segment": seg, "reason": why, "mine_ms": m_ms,
                          "swap_ms": s_ms, "n_fis": f} for b, seg, why, m_ms, s_ms, f
                         in res.remine_log],
          "swap_ms_max": max(st.swap_ms), "max_staleness": res.max_staleness,
          "served": res.n_served, "serve_s": res.serve_s, "qps": res.n_served / res.serve_s,
          "cache_hit_rate": sm.cache.stats.hit_rate, "torn": res.torn,
          "delta_checks": res.delta_checks, "delta_mismatches": res.delta_mismatches,
          "wall_s": wall_s, "peak_mem_bytes": peak, "launches": launches, "timed": timings})
    return launches, timings


def phase_profile(torch, dev, dense, serve_run):
    """The main path, the cluster path with B1 and with B2, and the serve
    replay once more under ``torch.profiler``: how much of the wall the card
    is busy, and with what.  Only the trace's device-side events (kernels,
    copies, sets) are summed: a CPU operator's device time repeats that of
    the kernels it launched.  One stream, so they do not overlap."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import cluster_mine, mine, serve_mine
    from repro_torch.serve import QueryCache, QueryEngine

    def serve_replay():
        args = serve_mine.build_parser().parse_args(SERVE_ARGS)
        engine = QueryEngine(serve_run.fi_index, serve_run.rule_index, batch=args.batch,
                             top_k=args.topk, cache=QueryCache(args.cache))
        serve_mine.warm(serve_run.stream, engine)
        serve_mine.replay(serve_run.stream, engine, engine.cache, args.batch)

    paths = {
        "main": lambda: mine.mine_dense(dense, support=SUPPORT, P=4, frontier=16, device=dev),
        "cluster": lambda: cluster_mine.run_once(dense, 4, cluster_args(THESIS_DB), dev),
        "cluster_mxu": lambda: cluster_mine.run_once(
            dense, 4, cluster_args(THESIS_DB, "--frontier", "64"), dev, use_mxu=True),
        "serve": serve_replay,
    }
    symbols = (("multi_extension_supports", "multi_support_kernel"),
               ("extension_supports", "single_support_kernel"),
               ("multi_extension_supports_mxu", "mxu_support_kernel"),
               ("subset_superset_counts", "subset_query_kernel"),
               ("block_itemset_supports", "block_support_kernel"),
               ("pair_supports", "pair_support_kernel"),
               ("pair_supports_mxu", "pair_support_mxu_kernel"))
    for path, run in paths.items():
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        rows = [(e.key, e.self_device_time_total, e.count) for e in prof.key_averages()
                if e.device_type == torch.autograd.DeviceType.CUDA]
        busy_ms = sum(us for _, us, _ in rows) / 1e3
        ours = {name: [(us / 1e3, n) for key, us, n in rows if symbol in key]
                for name, symbol in symbols}
        top = sorted(rows, key=lambda r: -r[1])[:8]
        # a trace without device times says nothing of the card: not measured
        emit({"phase": "profile", "path": path, "wall_s": wall_s,
              "device_busy_ms": busy_ms or None,
              "device_busy_share": busy_ms / 1e3 / wall_s if busy_ms else None,
              "device_events": sum(n for _, _, n in rows),
              "kernels_ms": {k: sum(ms for ms, _ in v) for k, v in ours.items()},
              "kernels_count": {k: sum(n for _, n in v) for k, v in ours.items()},
              "top_device_ms": [{"name": k[:80], "ms": us / 1e3, "count": n}
                                for k, us, n in top]})


def fitable(dense, support, **kw):
    """The materialised FITable of one mine, after checking what came out."""
    from repro_torch.launch import mine

    r, _ = mine.mine_dense(dense, support=support, materialize=True, **kw)
    if r.exchange_overflow or r.phase1_overflow.any() or r.phase4_overflow.any():
        fail(f"overflow while mining with {kw}")
    if len(r.fi_dict) != r.n_fis:
        fail(f"|F|={r.n_fis} but {len(r.fi_dict)} itemsets materialised ({kw})")
    n_tx = dense.shape[0] // kw["P"] * kw["P"]
    minsup = int(np.ceil(support * n_tx))
    if any(not s or not minsup <= v <= n_tx for s, v in r.fi_dict.items()):
        fail(f"an itemset is empty or its support lies outside [{minsup}, {n_tx}]")
    return r.fi_dict


def phase_exact(torch, dev, sms, dense, n_fis, mid_db, small_db):
    """One FITable whatever K, P and device, and the brute-force oracle; the
    repl_min run's profit matrix (B6) equal to the CPU's on the same
    tidlists, and B6 timed on them."""
    from repro_torch.core import eclat, schedule
    from repro_torch.data import ibm_gen
    from repro_torch.launch import mine

    t0 = time.perf_counter()
    want = fitable(dense, SUPPORT, P=4, frontier=16, device=dev)
    if len(want) != n_fis:
        fail(f"|F| {len(want)} differs from the main run's {n_fis}")
    n_by = {}
    for K in (1, 16, 64):
        for P in (1, 4):
            got = want if (K, P) == (16, 4) else fitable(dense, SUPPORT, P=P, frontier=K,
                                                          device=dev)
            if got != want:
                fail(f"the FITable at K={K} P={P} differs from K=16 P=4")
            n_by[f"K{K}_P{P}"] = len(got)
    sweep_s = time.perf_counter() - t0

    # mine --scheduler repl_min: the DB-Repl-Min profit matrix on B6, with
    # the tidlists it was given and what it returned kept for the check below
    profits = []
    on_path = schedule.pairwise_shared_transactions

    def recording(tids):
        out = on_path(tids)
        profits.append((tids, out))
        return out

    schedule.pairwise_shared_transactions = recording
    try:
        reset_launch_counts()
        repl = fitable(dense, SUPPORT, P=4, frontier=16, device=dev, scheduler="repl_min")
        repl_launches = launch_counts()
    finally:
        schedule.pairwise_shared_transactions = on_path
    if repl != want:
        fail(f"the FITable with the repl_min scheduler ({len(repl)}) differs from main's")
    if repl_launches["pair_supports"] < 1 or repl_launches["pair_supports_mxu"]:
        fail(f"the repl_min path did not launch B6 for its profit matrix: {repl_launches}")
    if len(profits) != 1:
        fail(f"the repl_min run computed {len(profits)} profit matrices, not one")
    tids, profit = profits[0]
    if not np.array_equal(profit, on_path(tids.cpu())):
        fail("the repl_min run's profit matrix (B6) differs from the CPU's on its tidlists")
    repl_timing = time_pair(torch, tids.contiguous(),
                            torch.full((tids.shape[1],), -1, dtype=torch.int32, device=dev),
                            sms, mxu=False)
    if repl_timing["max_abs_err"] or repl_timing["library"]["max_abs_err"]:
        fail(f"B6 or its library call disagrees on the repl_min tidlists: {repl_timing}")

    mid = ibm_gen.generate_dense(ibm_gen.params_from_name(mid_db, seed=0))
    mid_dev = fitable(mid, SUPPORT, P=4, frontier=16, device=dev)
    if mid_dev != fitable(mid, SUPPORT, P=4, frontier=16, device="cpu"):
        fail(f"{mid_db}: the FITable on {dev} differs from the CPU's")

    small = ibm_gen.generate_dense(ibm_gen.params_from_name(small_db, seed=0))
    oracle = eclat.brute_force_fis(small, int(np.ceil(SMALL_SUPPORT * small.shape[0])))
    if fitable(small, SMALL_SUPPORT, P=4, frontier=16, device=dev) != oracle:
        fail(f"{small_db}: the FITable on {dev} differs from brute force")
    cli = mine.main(["--db", small_db, "--support", str(SMALL_SUPPORT), "--device", dev.type])
    if cli.n_fis != len(oracle):
        fail(f"the launcher's CLI found |F|={cli.n_fis}, brute force {len(oracle)}")
    emit({"phase": "exact", "n_fis_by_K_P": n_by, "sweep_s": sweep_s,
          "repl_min": {"n_fis": len(repl), "equals_main": True, "launches": repl_launches,
                       "profit_matrix_equals_cpu": True, "classes": int(tids.shape[0]),
                       "timed": repl_timing},
          "mid": {"db": mid_db, "n_fis": len(mid_dev), "equals_cpu": True},
          "brute_force": {"db": small_db, "support": SMALL_SUPPORT, "n_fis": len(oracle),
                          "equal": True}})
    return want, mid, repl_launches, repl_timing


def phase_profile_demo(torch, dev, dense, n_fis):
    """The profiled demo mine once on the thesis database at 0.2, P=4, with a
    run record (``--trace --profile``), with the launch counts of exactly that
    run: measured time in all five families, B7 launched once a rep and equal
    to B6's plain version on the demo's operands, |F| of ``main``, and the
    four ``fimi/phase*`` spans and the ``kernels/*`` gauges in the record."""
    from repro_torch.kernels import pair_support as ps
    from repro_torch.launch import profile_demo
    from repro_torch.obs import profile as obs_profile
    from repro_torch.obs.runlog import load_run

    with tempfile.TemporaryDirectory() as rec:
        args = profile_demo.build_parser().parse_args(
            ["--db", THESIS_DB, "--support", str(SUPPORT), "-P", "4", "--device", dev.type,
             "--trace", rec, "--profile"])
        torch.cuda.synchronize()
        reset_launch_counts()
        t0 = time.perf_counter()
        demo = profile_demo.run(dense, args)
        wall_s = time.perf_counter() - t0
        launches = launch_counts()
        record = load_run(rec)
    fams = demo.report["families"]
    if demo.missing:
        fail(f"profile_demo: families without measured time: {demo.missing}")
    if launches != demo.launches:
        fail(f"profile_demo: the run counted {demo.launches} launches, its wrappers {launches}")
    if launches["pair_supports_mxu"] != args.reps or launches["pair_supports"]:
        fail(f"profile_demo: B7 must carry the pair family, once a rep: {launches}")
    if not torch.equal(demo.pair_out, ps.pair_supports_plain(demo.item_bits, demo.all_tids)):
        fail("profile_demo: B7's output differs from B6's plain version on the demo's operands")
    if demo.result.n_fis != n_fis:
        fail(f"profile_demo: |F| = {demo.result.n_fis}, main found {n_fis}")
    spans = {e["name"] for e in record["trace"]["traceEvents"] if e["ph"] == "X"}
    phases = {"fimi/phase1_sample", "fimi/phase2_partition", "fimi/phase3_exchange",
              "fimi/phase4_mine"}
    if not phases <= spans:
        fail(f"profile_demo: the trace lacks {sorted(phases - spans)}")
    gauges = record["metrics"]["gauges"]
    if any(gauges.get(f"kernels/{f}/measured_ms", 0.0) <= 0.0 for f in obs_profile.FAMILIES):
        fail("profile_demo: the run record lacks a family's measured time")
    emit({"phase": "profile_demo", "db": THESIS_DB, "support": SUPPORT, "P": 4,
          "reps": args.reps, "n_fis": demo.result.n_fis, "eager_s": demo.eager_s,
          "wall_s": wall_s, "progress": demo.result.progress.line(),
          "machine": demo.report["machine"],
          "families": {f: {"calls": fams[f]["calls"], "measured_ms": fams[f]["measured_ms"],
                           "modeled_ms": fams[f]["modeled_ms"],
                           "achieved_frac": fams[f]["achieved_frac"],
                           "bound": "memory" if fams[f]["mem_bound"] else "compute"}
                       for f in obs_profile.FAMILIES},
          "record": {"spans": sorted(phases), "manifest_backend": record["manifest"]["backend"],
                     "device_kind": record["manifest"]["device_kind"]},
          "launches": launches})
    return launches


@contextlib.contextmanager
def recorded_mxu_shapes():
    """The (K, I, W) of every launch of B2 inside the block, read where its
    wrapper launches (``multi_support._launch``) and recorded for this
    script only; the wrapper's launch count is untouched."""
    from repro_torch.kernels import multi_support as ms

    shapes, inner = [], ms._launch

    def recording(name, item_bits, prefix_tids):
        out, launched = inner(name, item_bits, prefix_tids)
        if launched and name == "multi_extension_supports_mxu":
            shapes.append((int(prefix_tids.shape[0]), *map(int, item_bits.shape)))
        return out, launched

    ms._launch = recording
    try:
        yield shapes
    finally:
        ms._launch = inner


def cluster_args(db_name, *extra):
    from repro_torch.launch import cluster_mine

    return cluster_mine.build_parser().parse_args(
        ["--db", db_name, "--support", str(SUPPORT), "-P", "4", *extra])


def phase_cluster(torch, dev, dense, db_name, want, use_mxu):
    """The cluster launcher's path once (planner, rounds, rebalancing), with
    the launch counts of exactly that run; with ``use_mxu`` Phase 4 runs on
    B2 at K=64, and B1 only in the planner, whose launches a second planner
    run with the same seed counts, and the run records how many of B2's
    launches took each K, I and W."""
    from repro_torch import cluster
    from repro_torch.core import fimi
    from repro_torch.launch import cluster_mine

    name = "cluster_mxu" if use_mxu else "cluster"
    K = 64 if use_mxu else 16
    args = cluster_args(db_name, "--frontier", str(K))
    print(f"{name}: {db_name} sup={SUPPORT} P=4 K={K} rebalance=True "
          f"scheduler={args.scheduler} use_mxu={use_mxu}", flush=True)
    torch.cuda.synchronize()
    reset_launch_counts()
    with recorded_mxu_shapes() as shapes:
        res, wall_s = cluster_mine.run_once(dense, 4, args, dev, use_mxu=use_mxu)
    launches = launch_counts()
    cluster_mine.report(res, wall_s)
    rep = res.report
    if res.launches != launches:
        fail(f"{name}: the run counted {res.launches} launches, its wrappers {launches}")
    if rep.exchange_overflow or rep.mine_overflow:
        fail(f"{name}: overflow")
    got = res.table.to_dict()
    if len(got) != res.table.n_fis or got != want:
        fail(f"{name}: the FITable ({res.table.n_fis}) differs from main's ({len(want)})")
    trips = int(rep.observed_loads.sum())
    planner_b1 = None
    if use_mxu:
        reset_launch_counts()
        params = cluster_mine.cluster_params(args, dense.shape[0], use_mxu=True)
        cluster.plan(fimi.shard_db(dense, 4, dev), dense.shape[1], params.planner,
                     seed=args.seed, device=dev)
        planner_b1 = launch_counts()["multi_extension_supports"]
        if launches["multi_extension_supports_mxu"] != trips:
            fail(f"{name}: B2 launched {launches['multi_extension_supports_mxu']} times, "
                 f"Phase 4 took {trips} trips")
        if launches["multi_extension_supports"] != planner_b1:
            fail(f"{name}: B1 launched {launches['multi_extension_supports']} times, "
                 f"the planner alone {planner_b1}")
    elif launches["multi_extension_supports_mxu"] or launches["multi_extension_supports"] <= 0:
        fail(f"{name}: B1 must carry the sweeps, not B2: {launches}")
    if launches["extension_supports"] <= 0:
        fail(f"{name}: the planner did not launch B3: {launches}")
    b2_shapes = None
    if use_mxu:
        if len(shapes) != launches["multi_extension_supports_mxu"]:
            fail(f"{name}: {len(shapes)} B2 shapes recorded for "
                 f"{launches['multi_extension_supports_mxu']} launches")
        b2_shapes = {axis: {str(v): n for v, n in sorted(collections.Counter(
            shape[j] for shape in shapes).items())} for j, axis in enumerate(("K", "I", "W"))}
        modal = collections.Counter(shapes).most_common(1)[0][0]
        if modal not in B2_TIMED:  # the kernels phase must time B2 where its path runs
            fail(f"{name}: most B2 launches took (K, I, W) = {modal}, which is not timed")
    emit({"phase": name, "db": db_name, "support": SUPPORT, "P": 4, "K": K,
          "use_mxu": use_mxu, "n_fis": res.table.n_fis, "equals_main": True,
          "wall_s": wall_s, "phase_ms": rep.phase_ms, "rounds": rep.n_rounds,
          "round_trips": [r.work_iters.tolist() for r in rep.rounds],
          "round_mine_ms": [r.mine_ms for r in rep.rounds],
          "donations": len(rep.donations), "imbalance": rep.imbalance,
          "makespan_trips": rep.makespan_trips,
          "estimation_error": rep.estimation_error(),
          "scheduler": res.plan.scheduler_used, "classes": len(res.plan.classes),
          "phase4_trips": trips, "planner_b1_launches": planner_b1, "launches": launches,
          "b2_launch_shapes": b2_shapes})
    return launches


def phase_resume(dev, mid_db, mid):
    """Kill after round 0 and resume from the checkpoint: the unbroken run's
    FITable row for row, once through the launcher's command line with B1,
    once with ``use_mxu=True`` (B2), which the command line has no flag for."""
    from repro_torch.launch import cluster_mine

    out = {}
    for use_mxu in (False, True):
        with tempfile.TemporaryDirectory() as ck:
            flags = ["--checkpoint", ck]
            if use_mxu:
                def run(*extra):
                    return cluster_mine.run_once(mid, 4, cluster_args(mid_db, *flags, *extra),
                                                 dev, use_mxu=True)[0]
            else:
                def run(*extra):
                    argv = ["--db", mid_db, "--support", str(SUPPORT), "-P", "4",
                            "--device", dev.type, *flags, *extra]
                    return cluster_mine.main(argv)
            whole = cluster_mine.run_once(mid, 4, cluster_args(mid_db), dev, use_mxu=use_mxu)[0]
            try:
                run("--kill-after-round", "0")
                fail("the run with --kill-after-round 0 was not killed")
            except SystemExit as e:
                if e.code not in (0, None):
                    raise
            resumed = run("--resume")
            if not (np.array_equal(resumed.table.masks, whole.table.masks)
                    and np.array_equal(resumed.table.supports, whole.table.supports)):
                fail(f"{mid_db}: the resumed FITable differs from the unbroken run's "
                     f"(use_mxu={use_mxu})")
            if whole.report.n_rounds < 2 or resumed.report.n_rounds != whole.report.n_rounds:
                fail(f"{mid_db}: {whole.report.n_rounds} rounds unbroken, "
                     f"{resumed.report.n_rounds} resumed (use_mxu={use_mxu})")
            out["mxu" if use_mxu else "b1"] = {
                "n_fis": whole.table.n_fis, "rounds": whole.report.n_rounds,
                "resumed_launches": resumed.launches, "bit_exact": True}
    emit({"phase": "resume", "db": mid_db, "support": SUPPORT, "P": 4, **out})


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from the root of a checkout")
    sys.path.insert(0, str(SRC))
    import torch

    if not torch.cuda.is_available():
        fail("CUDA is not available")

    from repro_torch.data import ibm_gen
    from repro_torch.kernels import build

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = nvidia_smi()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "nvidia_smi": smi, "name": kind,
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda})

    # build from the sources in the checkout, never from a library left behind
    t0 = time.perf_counter()
    build.library_path().unlink(missing_ok=True)
    probe_builds = {name: start_probe_build(build, name) for name in PROBES}
    lib_path = build.build()
    build.library()
    probe, floor = (load_probe(name, *probe_builds[name]) for name in PROBES)
    build_s = time.perf_counter() - t0
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    mma = {}
    for kernel, symbol in (("b2", "mxu_support_kernel"), ("b7", "pair_support_mxu_kernel")):
        sass = sass_of(lib_path, symbol)
        mma[kernel] = {op: sass.count(op) for op in ("IMMA", "BMMA")}
        if not sum(mma[kernel].values()):
            fail(f"{symbol}'s SASS holds no tensor-core MMA instruction")
    rate = mma_rate(torch, build, probe, sms)
    launch_floor_ms = empty_ms(torch, build, floor, 1, 32, 1)
    emit({"phase": "build", "seconds": build_s,
          "sources": [s.name for s in build.SOURCES] + [p[0].name for p in PROBES.values()],
          "library": str(lib_path.relative_to(ROOT)), "nvcc_flags": list(build.NVCC_FLAGS),
          "sass_mma": mma, "mma_b1_rate": rate, "launch_floor_ms": launch_floor_ms,
          "nvidia_smi": smi})

    timings = phase_kernels(torch, dev, rate["all_sms"]["mma_per_s"])

    t0 = time.perf_counter()
    dense = ibm_gen.generate_dense(ibm_gen.params_from_name(THESIS_DB, seed=0))
    res, launches = phase_main(torch, dev, dense, THESIS_DB, time.perf_counter() - t0)
    want, mid, repl_launches, repl_timing = phase_exact(torch, dev, sms, dense, res.n_fis,
                                                        MID_DB, SMALL_DB)
    launches["pair_supports"] = repl_launches["pair_supports"]
    demo_launches = phase_profile_demo(torch, dev, dense, res.n_fis)
    launches["pair_supports_mxu"] = demo_launches["pair_supports_mxu"]
    phase_cluster(torch, dev, dense, THESIS_DB, want, use_mxu=False)
    launches_mxu = phase_cluster(torch, dev, dense, THESIS_DB, want, use_mxu=True)
    launches["multi_extension_supports_mxu"] = launches_mxu["multi_extension_supports_mxu"]
    phase_resume(dev, MID_DB, mid)
    serve_run, launches_serve, serve_timings = phase_serve(torch, dev, dense, want, sms)
    launches["subset_superset_counts"] = launches_serve["subset_superset_counts"]
    fi = serve_run.fi_index
    launches_stream, stream_timings = phase_stream(torch, dev, sms, fi.masks[: fi.n_fis])
    stream_timing = stream_timings[1]
    launches["block_itemset_supports"] = launches_stream["block_itemset_supports"]
    phase_profile(torch, dev, dense, serve_run)

    # B3 and B6: one wave and no spills at every timed shape, and the empty
    # kernel at the same launch beside each
    for t in timings + [repl_timing]:
        f = t.get("launch")
        if t["name"] in ("extension_supports", "pair_supports"):
            if f["local_bytes"] or f["waves"] != 1:
                fail(f"{t['name']} spills or takes more than one wave at {t['shape']}: {f}")
            t["empty_ms"] = empty_ms(torch, build, floor, f["grid_x"], f["threads"], f["cluster"])
    emit({"phase": "launch_facts", "nvidia_smi": smi, "launch_floor_ms": launch_floor_ms,
          "shapes": [{"name": t["name"], "shape": t["shape"], **t["launch"],
                      **({"empty_ms": t["empty_ms"]} if "empty_ms" in t else {})}
                     for t in timings + [repl_timing] + stream_timings if t.get("launch")]})

    # each kernel at the shape where its path spends its time: B4 at the rules
    # query (F = 2R), B5 at the delta (S = 2) of a thesis-sized index, B6 on
    # the repl_min tidlists, B7 at the profiled demo's I=100, W=15625
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "shape",
            "empty_ms")
    b6_demo = next(t for t in timings if t["name"] == "pair_supports")
    repl_timing["at_demo_shape"] = {key: b6_demo[key] for key in keys if key in b6_demo}
    summary = []
    for t in [t for t in timings if t is not b6_demo] + [repl_timing] + serve_timings[1:] \
            + [stream_timing]:
        k = KERNELS[t["name"]]
        if k["main_shape"] is None or tuple(t["shape"].values()) == k["main_shape"]:
            summary.append({"name": t["name"], "route": "cuda", "source": k["source"],
                            "replaces": k["replaces"], "launches": launches[t["name"]],
                            **{key: t[key] for key in keys + ("at_demo_shape",)
                               if key in t}})
    emit({"kernels": summary, "launch_floor_ms": launch_floor_ms})
    print(f"chip_smoke: total {time.perf_counter() - t_start:.1f}s", file=sys.stderr)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

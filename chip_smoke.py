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
  variants the launcher's path with the thesis' other Phase-1 methods,
           ``--variant seq`` (Method 1: one miner mines D̃'s MFI candidates
           on B3, one launch a DFS node) and ``--variant par`` (Method 2:
           each miner its classes' candidates), on the thesis database at
           0.2, P=4, K=16: the FITable of ``exact``, B3 and B1 the only
           kernels launched, B3 at least once a Phase-1 trip; the Phase-1
           trips, MFI candidates kept and dropped (reported, not failed on:
           the reference's buffer drops the same ones), |M|, the plan, the
           trip shares and ``fimi/load/estimation_error``, phase seconds,
           wall, peak memory; for ``seq`` the card's candidate buffer equal,
           trip for trip, to the CPU's (plain B3) on the same sample rows;
  cluster  the cluster launcher's path (planner, rounds, rebalancing) on the
           thesis database at P=4, K=16: the same FITable as ``main``;
  cluster_mxu  the same with ``ClusterParams(use_mxu=True)`` at K=64: Phase 4
           on B2, one launch per DFS trip, B1 only in the planner; how many
           of B2's launches took each K and W (it fails if most of them take
           a shape at which ``kernels`` does not time B2);
  resume   on T20I0.1P50PL10TL40, a run killed after round 0 and resumed
           from its checkpoint gives the unbroken run's FITable, row for row,
           with B1 and with B2;
  store    out-of-core mining: the thesis database spilled by the port's
           ``write_ibm_store`` in 8 blocks of 65,536 rows (8,000,000 packed
           bytes, 3.8 times the 2-block host budget), mined through
           ``fimi.run(store, P=4)`` (the double-buffered pinned reader, then
           B3 and B1) at 0.2, K=16: its FITable equal to the dense in-RAM
           mine of ``store.to_dense()``, the reader's host high-water within
           the budget, then ``streamed_itemset_supports`` of the FITable over
           the store (one B5 launch a block) equal to its supports, B5 timed
           at S=1, T=65,536 against the store's |F|, and ``mine --dataset
           examples/retail_tiny.dat --parity`` through the launcher; spill
           seconds, the assembly's time and bytes a second, the prefetch
           stall, blocks read, both mines' phase seconds and walls, launches
           and peak memory;
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
  service  the serving service under open-loop load (``serve_load``'s harness)
           over the ``serve`` phase's index pair: the micro-batched capacity
           (``compare_dispatch``), then 2 replicas, batch 64, deadline 4 ms,
           the cache on, Poisson arrivals (Zipf 1.3, drifting hot set) at half
           that capacity for 10 s after a 2 s ramp, traced, while a second
           thread swaps every replica to the stream's last index pair and
           back (each pair copied on its own CUDA stream): 0 errors, 0
           unresolved, every answer equal to the CPU engine's at its flush's
           generation; offered and served QPS, windowed p50/p95/p99, shed
           rate, burn, flushes, batch fill, replica lanes, queue wait and
           sweep times from the flush spans, B4's launches, peak memory, the
           micro-batch speedup.  Then ``serve_load`` at its defaults behind
           ``--gate`` (exit 0), and an overload at 4 times the capacity into
           a queue of 64 (exit 1, sheds, an alert in the measured phase),
           open-loop first and, if that offered too little to shed, with a
           closed loop of 256 callers beside it;
  stream_cluster  the ``stream`` phase's path with ``--cluster 4 --spill``:
           the cluster executor re-mines the window (B1, B3, B6), the window
           spills its 16 evicted blocks (1,048,576 rows) into a store; the
           same re-mine log as ``stream``, 0 torn, the delta check equal;
           the store mined from disk (``fimi.run(store, P=4)``) within the
           2-block host budget equal to the dense mine of the same 16 blocks
           as the host generated them for the stream; ingest rows/s beside
           the ``stream`` phase's, the spill's seconds, the re-mine walls and
           the launches;
  cluster_obs  the cluster launcher through its ``main`` at the ``cluster``
           phase's settings with ``--trace --profile --doctor`` (the database
           the one already generated): the FITable of ``main``, the speedup
           waterfall's terms summing to its gap within 0.05x, the port's
           ``obs_report`` reading the record (``summary``, ``critpath`` with
           ``cluster/mine`` on it, ``doctor``); then with ``--force-skew``:
           ``rebalance-not-engaging`` at ``error``, ``doctor --gate`` exit 1;
           the findings, the waterfall's terms and the critical path of both;
  ranks    ``mine`` and ``cluster_mine`` with ``-P 1 --devices 1`` in child
           processes, each miner a rank of a one-rank NCCL group on the card:
           ``backend=nccl``, |F| and the FITable's SHA-256 those of ``main``;
           beside them ``mine --store`` on the ``store`` phase's store, a
           rank reading its own shard off disk: ``backend=nccl``, |F| and the
           SHA-256 of the dense mine of the store's rows, B1 and B3 launched;
  lm_serve the LM substrate's serving path (``repro_torch.launch.serve``'s
           ``generate``): llama3.2-3b at its full config (bf16 weights drawn
           from seed 0), batch 4, a prompt of 16 and 32 generated tokens; then
           olmoe-1b-7b and mamba2-1.3b at their full configs with 8 tokens:
           the parameter count (equal to ``models.model.n_params`` of the
           config, the spec tree's; the config's analytic count beside it),
           peak memory, prefill and decode walls, tokens a second, every token
           below the vocabulary, finite logits, and the decode logits at
           every prompt position against ``forward``'s, reported (the
           reference's init law makes attention near one-hot, so at full
           depth rounding flips keys and decode and forward part by O(1)).
           Checked at the same width cut to 4 layers, on f32 weights from
           seed 0: the decode against ``forward`` within 5e-2 x max |logit|
           with the greedy token at the prompt's end equal from both (and
           from ``make_prefill_step``).
           Then each of the ten architectures at its ``smoke()`` config,
           its weights drawn on the CPU and copied to the card, in f32 and in
           bf16: a forward of 8 tokens and 8 decode steps on the card against
           the same on the CPU within 1e-3 (f32) and 0.25 (bf16: MoE routing
           flips with the summation order) x max |logit|;
  lm_train the LM substrate's training path (``repro_torch.launch.train``'s
           loop): llama3.2-3b at its full config (bf16 parameters from seed 0,
           f32 AdamW state, ``remat="block"``), batch 8 x seq 128, accum 1, 6
           steps, no checkpoint: the parameter count (the spec tree's), each
           step's wall, tokens a second, loss, grad norm and lr (equal to
           ``lr_at``), peak memory, every loss and norm finite; at the same
           width cut to 4 layers one batch's gradients with ``remat="block"``
           and ``"none"``: less memory held after the forward and a lower peak
           with ``block``, equal losses; each of
           the ten ``smoke()`` configs (and llama3.2-3b at accum 2) one f32
           step on the card against the CPU, within the CPU tests' bounds
           (loss 1e-5 nats, each leaf's gradient 1e-3 of its max |g| and the
           grad norm 1e-4 relative, whisper 1e-2 for both; the parameters
           after the step within 2 lr); then ``tests/test_checkpoint_train.py``'s
           drill: llama smoke memorizes one batch in 25 steps (last loss
           below 0.8 of the first) and a checkpoint after step 9, restored by
           the port's manager, replays step 10's loss within 1e-4;
  lm_shard the sharding group, in a child process that is one rank of a
           one-rank NCCL group (``--lm-shard-child``): llama3.2-3b at its
           full config (bf16 from seed 0) with its parameters DTensors on a
           1x1 ``("data", "model")`` mesh under the dry run's layout
           (``sharding.step_layout``: FSDP rules, ``batch_spec``,
           ``act_spec``), batch 8 x 128 at accum 2: the step's gradients, a
           prefill, a decode step (cache under ``cache_shardings``) and a
           train step, each against the same call on plain tensors on the
           card within ``lm_train`` (c)'s bounds (logits and cache 1e-4 of
           their max; each gradient in its parameter's placements); each
           call's wall, the peak memory, the ops run on replicated copies,
           the backend; then each full config's bytes a rank (parameters and
           AdamW state) on the 16x16 production mesh: the dry run's argument
           bytes of its ``train_4k`` cell, from the shapes;
  dryrun   the dry run (``repro_torch.launch.dryrun``) in three child
           processes at once, each with its own fake process group (none
           meets an NCCL group): ``run_cell`` for llama3.2-3b ``decode_32k``
           on the 16x16 fake world (argument bytes 1,986,743,716, the JAX
           package's) and olmoe-1b-7b ``decode_32k`` on 2x16x16; the train
           step of the ``train_4k`` cell's policy (accum 8, batch 256 x
           4096, 16x16) on llama3.2-3b's smoke config; and ``lm_train``'s own
           step (llama3.2-3b at full config, bf16, f32 AdamW, block remat,
           batch 8 x 128, accum 1) on a 1x1 fake world, whose argument bytes
           must equal the bytes the caching allocator was asked for with the
           same parameters, state and batch placed on the card (one block a
           tensor), and ``torch.cuda.memory_allocated()`` within the
           allocator's rounding (512 B a block, and the unsplit rest of a
           segment, at most 1 MiB, a block over 1 MiB); its estimated peak
           stands beside ``lm_train``'s ``max_memory_allocated``; each record
           must have the reference's keys;
  profile  the main path, both cluster paths, the store mine and the serve
           replay once more under ``torch.profiler``: the card's busy time
           and share of the wall, and the kernels' share of that.
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
import gc
import json
import os
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
# the store phase: the thesis database spilled in blocks of 65,536 rows,
# streamed from a host budget of 2 blocks
STORE_BLOCK_TX, STORE_BUDGET_BLOCKS = 65536, 2
RETAIL_TINY = ROOT / "examples" / "retail_tiny.dat"

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
    stream's indexes before the drift, whose deltas take the longest.  The
    stream's host blocks are kept, for ``stream_cluster`` to replay."""
    from repro_torch.launch import stream_mine

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    generate, blocks = stream_mine.drifting_stream, []

    def keeping(*a, **kw):
        for block in generate(*a, **kw):
            blocks.append(block)
            yield block

    stream_mine.drifting_stream = keeping
    t0 = time.perf_counter()
    try:
        res = stream_mine.main(STREAM_ARGS + ["--device", dev.type])
    finally:
        stream_mine.drifting_stream = generate
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
    return launches, timings, res, blocks


SERVICE_ARGS = ["--replicas", "2", "--batch", "64", "--deadline-ms", "4", "--cache", "2048",
                "--duration", "10", "--ramp", "2", "--no-dashboard", "--bench-out", ""]
OVERLOAD_CALLERS = 256     # the closed loop's callers, 4 x --max-queue 64


def copy_pair(torch, pair, stream):
    """An index pair with every tensor copied on ``stream`` (device to
    device): a standby pair built on another thread's own stream."""
    import dataclasses

    with torch.cuda.stream(stream):
        return tuple(dataclasses.replace(x, **{
            f.name: getattr(x, f.name).clone() for f in dataclasses.fields(x)
            if isinstance(getattr(x, f.name), torch.Tensor)}) for x in pair)


def cpu_answers(pair, asked, batch):
    """Each distinct (kind, mask bytes) of ``asked`` answered by the engine
    over ``pair`` on the CPU (B4's plain version)."""
    from repro_torch.serve import QueryEngine

    eng = QueryEngine(pair[0].to("cpu"), pair[1].to("cpu"), batch=batch, top_k=5)
    call = {"support": lambda m: list(eng.support(m)),
            "rules": lambda m: list(zip(*eng.rules_for(m))),
            "superset": lambda m: list(zip(*eng.supersets(m)))}
    out = {}
    for kind in call:
        keys = sorted({m for k, m in asked if k == kind})
        for lo in range(0, len(keys), batch):
            part = keys[lo: lo + batch]
            masks = np.stack([np.frombuffer(m, np.uint32) for m in part])
            out.update({(kind, m): v for m, v in zip(part, call[kind](masks))})
    return out


@contextlib.contextmanager
def gc_account():
    """The collector's passes and seconds by generation while the block
    runs: ``{"passes": [n0, n1, n2], "s": [s0, s1, s2]}``."""
    acc, t0 = {"passes": [0, 0, 0], "s": [0.0, 0.0, 0.0]}, [0.0]

    def on_gc(phase, info):
        if phase == "start":
            t0[0] = time.perf_counter()
        else:
            acc["s"][info["generation"]] += time.perf_counter() - t0[0]
            acc["passes"][info["generation"]] += 1
    gc.callbacks.append(on_gc)
    try:
        yield acc
    finally:
        gc.callbacks.remove(on_gc)


def pctl(values, qs=(50, 95, 99)):
    v = np.asarray(values, dtype=np.float64)
    return {f"p{q}": float(np.percentile(v, q)) for q in qs} if v.size else None


def loaded_run(torch, dev, dense, serve_run, stream_pair, qps):
    """One traced ``serve_load`` run of the service over the serve phase's
    index pair at ``qps``, while a second thread swaps every replica to
    ``stream_pair`` and back (each pair copied on that thread's own stream),
    with every answer held against the CPU engine at its flush's generation.
    Returns what it measured, with the launch counts of exactly that run."""
    import threading

    from repro_torch.launch import serve_load
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.obs import trace as obs_trace
    from repro_torch.serve import Failed, Shed

    fi, rl = serve_run.fi_index, serve_run.rule_index
    thesis = (fi, rl)
    args = serve_load.build_parser().parse_args(SERVICE_ARGS + ["--qps", str(qps)])
    asked, swaps, swap_errors = {}, [], []

    def on_start(svc):
        submit = svc.submit

        def recording(kind, mask):
            ticket = submit(kind, mask)
            asked[ticket.id] = (kind, np.ascontiguousarray(mask, np.uint32).tobytes())
            return ticket
        svc.submit = recording
        t0 = time.monotonic()

        def swapper():
            side = torch.cuda.Stream(dev)
            try:
                for k, pair in ((1, stream_pair), (2, thesis)):
                    standby = copy_pair(torch, pair, side)
                    time.sleep(max(0.0, t0 + args.ramp + k * args.duration / 3
                                   - time.monotonic()))
                    with torch.cuda.stream(side):
                        swaps.append((svc.swap_indexes(*standby), time.monotonic() - t0))
            except Exception as e:   # reported below: the phase fails on it
                swap_errors.append(f"{type(e).__name__}: {e}")
        threading.Thread(target=swapper, name="swapper", daemon=True).start()

    tr = obs_trace.tracer()
    tr.clear()
    tr.set_max_events(8_000_000)
    obs_metrics.reset()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    heap_objects = len(gc.get_objects())
    tr.enable()
    try:
        with gc_account() as gc_acc:
            run = serve_load.serve(args, serve_run.fis, dense, fi, rl, on_start=on_start)
    finally:
        tr.disable()
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    st = run.svc.stats()
    events = tr.export()["traceEvents"]
    dropped = tr.dropped_events
    tr.clear()
    tr.set_max_events(obs_trace.DEFAULT_MAX_EVENTS)
    gen_of = {}
    for e in events:
        if e.get("ph") == "X" and e["name"] == "service/flush":
            for rid in e["args"]["reqs"]:
                if rid in gen_of:
                    fail(f"service: request {rid} in two flushes")
                gen_of[rid] = e["args"]["generation"]
    values = [(t.id, t.result(0)) for t in run.tickets]
    failed = [v for _, v in values if isinstance(v, Failed) or v is None]
    if swap_errors or [g for g, _ in swaps] != [1, 2]:
        fail(f"service: the swaps from the second thread: {swaps}, {swap_errors}")
    if st["errors"] or failed or run.unresolved or dropped:
        fail(f"service: {st['errors']} errors, {len(failed)} failed, {run.unresolved} "
             f"unresolved tickets, {dropped} trace events dropped")
    served = [(i, v) for i, v in values if not isinstance(v, Shed)]
    if set(gen_of) != {i for i, _ in served} or set(gen_of.values()) != {0, 1, 2}:
        fail(f"service: {len(gen_of)} requests in flushes against {len(served)} served, "
             f"generations {sorted(set(gen_of.values()))}")
    if launches["subset_superset_counts"] <= 0 or any(
            n for k, n in launches.items() if k != "subset_superset_counts"):
        fail(f"service: B4 must carry every flush and nothing else launch: {launches}")
    t0 = time.perf_counter()
    cpu = {g: cpu_answers(pair, asked.values(), args.batch)
           for g, pair in ((0, thesis), (1, stream_pair))}
    differ = [i for i, v in served if not same_answer(v, cpu[gen_of[i] % 2][asked[i]])]
    check_s = time.perf_counter() - t0
    if differ:
        fail(f"service: {len(differ)} of {len(served)} answers differ from the CPU engine's "
             f"at their generation (first {differ[:5]})")

    fin = run.final
    spans = collections.defaultdict(list)
    for e in events:
        if e.get("ph") == "X" and e["name"].startswith("service/"):
            spans[e["name"]].append(e["dur"] / 1e3)
    return {
        "target_qps": qps, "offered": len(run.tickets),
        "offered_qps": len(run.tickets) / (args.ramp + args.duration),
        "served": len(served), "served_qps": len(served) / (args.ramp + args.duration),
        "window_offered_qps": fin.offered_qps, "window_served_qps": fin.qps,
        "window_ms": {"p50": fin.p50_ms, "p95": fin.p95_ms, "p99": fin.p99_ms},
        "shed": st["shed"], "shed_rate": fin.shed_rate, "burn_rate": fin.burn_rate,
        "gate_ok": run.slo_keys["slo_gate_ok"], "alerts": len(run.measure_alerts),
        "flushes": st["flushes"],
        "batch_fill": obs_metrics.registry().histogram("service/batch_fill").summary(),
        "per_replica_flushes": st["per_replica_flushes"],
        "per_replica_requests": st["per_replica_requests"],
        "cache_hit_rate": st["cache"]["hit_rate"], "swaps": swaps,
        "queue_wait_ms": pctl(spans["service/enqueue"]),
        "sweep_ms": pctl(spans["service/sweep"]), "flush_ms": pctl(spans["service/flush"]),
        "answers_checked": len(served), "answers_equal_cpu": True, "cpu_check_s": check_s,
        "heap_tracked_objects": heap_objects, "gc_passes": gc_acc["passes"],
        "gc_s": gc_acc["s"], "trace_events": len(events),
        "wall_s": run.wall_s, "peak_mem_bytes": peak, "launches": launches}


def phase_service(torch, dev, dense, serve_run, stream_pair, smi, tmp):
    """The serving service under open-loop load (``serve_load``'s harness)
    over the serve phase's index pair: the micro-batched capacity
    (``compare_dispatch``), then 2 replicas at half of it for 10 s after a
    2 s ramp (``loaded_run``: two swaps from a second thread, every answer
    checked).  Then the launcher at its defaults behind ``--gate`` (exit 0),
    and an overload at 4 times the capacity with ``--max-queue 64`` (exit 1,
    sheds, an alert in the measured phase).  Returns the launch counts of
    the loaded run."""
    from repro_torch.launch import serve_load
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.serve import QueryEngine

    fi, rl = serve_run.fi_index, serve_run.rule_index
    args = serve_load.build_parser().parse_args(SERVICE_ARGS)
    pools = serve_load.build_pools(np.random.default_rng(args.seed), serve_run.fis, dense,
                                   fi.n_items, pool=args.pool)
    capacity = serve_load.compare_dispatch(
        QueryEngine(fi, rl, batch=args.batch, top_k=args.topk),
        serve_load.Workload(np.random.default_rng(args.seed), pools, zipf_a=args.zipf,
                            drift_every=args.drift_every))
    half = loaded_run(torch, dev, dense, serve_run, stream_pair, capacity["batched_qps"] / 2)

    # the launcher at its defaults, behind its gate; files into a temp directory.
    # Each run starts from a fresh registry: a service's stats are its own
    obs_metrics.reset()
    with contextlib.chdir(tmp):
        defaults = serve_load.run(["--gate", "--no-dashboard",
                                   "--bench-out", f"{tmp}/BENCH_torch_serve.json"])
    dst = defaults.svc.stats()
    if defaults.rc != 0 or dst["errors"] or defaults.unresolved:
        fail(f"service: serve_load at its defaults: exit {defaults.rc}, {dst['errors']} "
             f"errors, {defaults.unresolved} unresolved")
    defaults_gate = {
        "rc": defaults.rc, "db": serve_load.build_parser().get_default("db"),
        "target_qps": defaults.slo_keys["slo_target_qps"],
        "window_served_qps": defaults.final.qps,
        "window_ms": {"p50": defaults.final.p50_ms, "p95": defaults.final.p95_ms,
                      "p99": defaults.final.p99_ms},
        "shed": dst["shed"], "errors": dst["errors"], "flushes": dst["flushes"]}

    # the overload: 4 times the measured capacity into a 64-deep queue
    attempts = []
    for mode in ("open", "closed"):
        argv = SERVICE_ARGS + ["--qps", str(4 * capacity["batched_qps"]), "--max-queue", "64",
                               "--gate"]
        if mode == "closed":
            argv += ["--closed", str(OVERLOAD_CALLERS)]
        obs_metrics.reset()
        with contextlib.chdir(tmp):
            over = serve_load.serve(serve_load.build_parser().parse_args(argv), serve_run.fis,
                                    dense, fi, rl)
        ost = over.svc.stats()
        attempts.append({
            "mode": mode, "rc": over.rc, "target_qps": 4 * capacity["batched_qps"],
            "offered": len(over.tickets), "offered_qps": len(over.tickets) / over.wall_s,
            "window_served_qps": over.final.qps, "shed": ost["shed"], "errors": ost["errors"],
            "alerts_all": len(over.slo.alerts), "alerts_measured": len(over.measure_alerts),
            "alert_kinds": sorted({a["objective"] for a in over.measure_alerts}),
            "window_p99_ms": over.final.p99_ms,
            "closed_callers": OVERLOAD_CALLERS if mode == "closed" else 0})
        if ost["errors"]:
            fail(f"service: the overload raised {ost['errors']} errors")
        if over.rc == 1 and ost["shed"] > 0 and over.measure_alerts:
            break
    else:
        fail(f"service: the overload did not trip the gate: {attempts}")
    emit({"phase": "service", "nvidia_smi": smi, "db": THESIS_DB, "support": SUPPORT,
          "minconf": 0.5, "n_fis": fi.n_fis, "n_rules": rl.n_rules,
          "swap_to": {"n_fis": stream_pair[0].n_fis, "n_rules": stream_pair[1].n_rules},
          "argv": SERVICE_ARGS, "switch_interval_s": sys.getswitchinterval(),
          "capacity": capacity, "microbatch_speedup": capacity["speedup"],
          "half_capacity": half, "defaults_gate": defaults_gate,
          "overload": attempts[-1], "overload_attempts": attempts})
    return half["launches"]


def phase_stream_cluster(torch, dev, stream_res, stream_blocks, smi, tmp):
    """The streaming launcher with the cluster executor as re-miner
    (``--cluster 4``) and the window's spill (``--spill``) on the ``stream``
    phase's blocks, replayed as the host generated them there (the same
    arguments give the same blocks): the stream phase's re-mine log, 0 torn,
    16 blocks spilled, then the spilled store mined from disk
    (``fimi.run(store, P=4)``) equal to the dense mine of those 16 blocks."""
    from repro_torch.launch import mine, stream_mine
    from repro_torch.store import BlockReader, TxStore
    from repro_torch.stream import window as window_mod

    spill_dir = f"{tmp}/spill"
    spill_s = []
    append, generate = window_mod.WindowSpill.append, stream_mine.drifting_stream
    window = int(STREAM_ARGS[STREAM_ARGS.index("--blocks") + 1])
    n_blocks = int(STREAM_ARGS[STREAM_ARGS.index("--stream") + 1])
    blocks = [block for block, _ in stream_blocks[: n_blocks - window]]

    def timed_append(self, expired):
        t0 = time.perf_counter()
        out = append(self, expired)
        spill_s.append(time.perf_counter() - t0)
        return out

    def replaying(*a, **kw):
        yield from stream_blocks

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    window_mod.WindowSpill.append, stream_mine.drifting_stream = timed_append, replaying
    t0 = time.perf_counter()
    try:
        res = stream_mine.main(STREAM_ARGS + ["--device", dev.type, "--cluster", "4",
                                              "--spill", spill_dir])
    finally:
        window_mod.WindowSpill.append, stream_mine.drifting_stream = append, generate
    wall_s = time.perf_counter() - t0
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    if res is None or res.torn or res.delta_mismatches \
            or res.delta_checks != n_blocks - window + 1:
        fail(f"stream_cluster: {res and res.torn} torn, {res and res.delta_mismatches} delta "
             f"mismatches of {res and res.delta_checks}")
    log = [(b, seg, why, f) for b, seg, why, _, _, f in res.remine_log]
    want = [(b, seg, why, f) for b, seg, why, _, _, f in stream_res.remine_log]
    gens = [ev.generation for ev, _ in res.events if ev.remined]
    if log != want or gens != list(range(len(want))):
        fail(f"stream_cluster: re-mine log {log} (generations {gens}) against the stream "
             f"phase's {want}")
    needed = ("multi_extension_supports", "extension_supports", "subset_superset_counts",
              "block_itemset_supports", "pair_supports")
    if any(launches[k] <= 0 for k in needed) or res.launches != launches:
        fail(f"stream_cluster: B1, B3, B4, B5 and B6 must all launch: {launches}, "
             f"run {res.launches}")

    store = TxStore.open(spill_dir)
    spilled = n_blocks - window
    block_tx = int(STREAM_ARGS[STREAM_ARGS.index("--blocktx") + 1])
    if store.n_blocks != spilled or store.n_tx != spilled * block_tx \
            or len(spill_s) != spilled or len(blocks) != spilled:
        fail(f"stream_cluster: {store.n_blocks} blocks ({store.n_tx} rows) spilled, "
             f"{len(spill_s)} appends, want {spilled}")
    reader = BlockReader(store, STORE_BUDGET_BLOCKS, device=dev)
    got, got_wall = mine.mine_store(store, support=SUPPORT, P=4, frontier=16, device=dev,
                                    materialize=True, reader=reader)
    if not 0 < reader.peak_host_bytes <= reader.budget_bytes:
        fail(f"stream_cluster: host high-water {reader.peak_host_bytes}B against a budget "
             f"of {reader.budget_bytes}B")
    ref, ref_wall = mine.mine_dense(np.concatenate(blocks), support=SUPPORT, P=4, frontier=16,
                                    device=dev, materialize=True)
    if not got.fi_dict or not mine.parity(got.fi_dict, ref.fi_dict):
        fail(f"stream_cluster: the spilled store's FITable ({len(got.fi_dict)}) differs from "
             f"the dense mine of its blocks ({len(ref.fi_dict)})")
    st = res.miner.stats
    emit({"phase": "stream_cluster", "nvidia_smi": smi, "db_family": THESIS_DB,
          "argv": STREAM_ARGS + ["--cluster", "4", "--spill", "DIR"],
          "blocks": st.blocks_in, "tx_in": st.tx_in, "ingest_s": res.ingest_s,
          "ingest_rows_per_s": st.tx_in / res.ingest_s,
          "stream_ingest_rows_per_s": stream_res.miner.stats.tx_in / stream_res.ingest_s,
          "spill_s": sum(spill_s), "spill_ms_per_block": pctl(np.asarray(spill_s) * 1e3),
          "remine_log": [{"block": b, "segment": seg, "reason": why, "mine_ms": m_ms,
                          "swap_ms": s_ms, "n_fis": f} for b, seg, why, m_ms, s_ms, f
                         in res.remine_log],
          "stream_remine_ms": [m_ms for _, _, _, m_ms, _, _ in stream_res.remine_log],
          "same_remine_log_as_stream": True, "torn": res.torn,
          "delta_checks": res.delta_checks, "delta_mismatches": res.delta_mismatches,
          "spilled_blocks": store.n_blocks, "spilled_rows": store.n_tx,
          "store_bytes": store.total_bytes,
          "store_mine": {"n_fis": got.n_fis, "wall_s": got_wall, "phase_s": got.phase_s,
                         "peak_host_bytes": reader.peak_host_bytes,
                         "budget_bytes": reader.budget_bytes, "equals_dense": True,
                         "dense_wall_s": ref_wall},
          "wall_s": wall_s, "peak_mem_bytes": peak, "launches": launches})
    return launches


def cluster_obs_run(dev, dense, run_dir, *extra):
    """``cluster_mine.main`` on the thesis database with ``--trace --profile
    --doctor`` (and ``extra``), its database the one already generated; its
    result, wall, output and the launches of exactly that run."""
    import contextlib
    import io

    from repro_torch.launch import cluster_mine

    resolve = cluster_mine.resolve_source
    out = io.StringIO()
    cluster_mine.resolve_source = lambda *a, **kw: (None, dense, f"db={THESIS_DB}")
    reset_launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(out):
            res = cluster_mine.main(["--db", THESIS_DB, "--support", str(SUPPORT), "-P", "4",
                                     "--frontier", "16", "--device", dev.type, "--trace",
                                     run_dir, "--profile", "--doctor", *extra])
    finally:
        cluster_mine.resolve_source = resolve
    wall_s = time.perf_counter() - t0
    return res, wall_s, out.getvalue(), launch_counts()


def obs_report_run(*argv):
    """The port's ``obs_report`` in-process: (exit code, output)."""
    import contextlib
    import io

    from repro_torch.launch import obs_report

    out = io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(io.StringIO()):
        code = obs_report.main(list(argv))
    return code, out.getvalue()


def phase_cluster_obs(torch, dev, dense, want, smi, tmp):
    """The cluster launcher through its ``main`` at the ``cluster`` phase's
    settings with ``--trace --profile --doctor``: the FITable of ``main``, the
    speedup waterfall's terms summing to its gap within 0.05x, the port's
    ``obs_report`` reading the record (``summary``, ``critpath`` with
    ``cluster/mine`` on it, ``doctor``); then the same with ``--force-skew``,
    which the doctor must report as ``rebalance-not-engaging`` at ``error``
    and ``obs_report doctor --gate`` must fail.  The findings and the terms
    are this card's result, not pass conditions of the healthy run."""
    from repro_torch.obs import doctor, runlog, speedup

    history = ["--history", f"{tmp}/no_history.jsonl"]
    out = {}
    for name, extra in (("healthy", ()), ("force_skew", ("--force-skew",))):
        run_dir = f"{tmp}/cluster_obs_{name}"
        torch.cuda.synchronize()
        res, wall_s, text, launches = cluster_obs_run(dev, dense, run_dir, *extra)
        got = res.table.to_dict()
        if len(got) != res.table.n_fis or got != want:
            fail(f"cluster_obs ({name}): the FITable ({res.table.n_fis}) differs from "
                 f"main's ({len(want)})")
        # the skewed run plans before execute(), which counts only its own launches
        if launches["multi_extension_supports"] <= 0 or launches["extension_supports"] <= 0 \
                or (res.launches != launches if name == "healthy" else
                    any(res.launches[k] > n for k, n in launches.items())):
            fail(f"cluster_obs ({name}): B1 and B3 must launch: {launches}, run {res.launches}")
        if "doctor:" not in text or "speedup waterfall (run)" not in text:
            fail(f"cluster_obs ({name}): --doctor printed no report")
        record = runlog.load_run(run_dir)
        wf = speedup.from_run(record)
        if wf is None or abs(sum(t.loss_x for t in wf.terms) - wf.gap_x) > 0.05:
            fail(f"cluster_obs ({name}): the waterfall's terms do not sum to its gap: "
                 f"{wf and [(t.name, t.loss_x) for t in wf.terms]} against "
                 f"{wf and wf.gap_x}")
        report = doctor.diagnose(record)
        codes = {}
        for cmd in ("summary", "critpath", "doctor"):
            codes[cmd], _ = obs_report_run(cmd, run_dir, *(history if cmd == "doctor" else ()))
        _, cp_json = obs_report_run("critpath", run_dir, "--format", "json")
        table = [r["name"] for r in json.loads(cp_json)["table"]]
        gate, _ = obs_report_run("doctor", run_dir, "--gate", *history)
        if any(codes.values()) or "cluster/mine" not in table:
            fail(f"cluster_obs ({name}): obs_report exit codes {codes}, critical path {table}")
        findings = [(f["rule"], f["severity"]) for f in report["findings"]]
        if name == "force_skew" and (("rebalance-not-engaging", "error") not in findings
                                     or gate != 1):
            fail(f"cluster_obs: --force-skew gave {findings}, doctor --gate exit {gate}")
        rep = res.report
        out[name] = {
            "n_fis": res.table.n_fis, "equals_main": True, "wall_s": wall_s,
            "phase_ms": rep.phase_ms, "rounds": rep.n_rounds,
            "round_trips": [r.work_iters.tolist() for r in rep.rounds],
            "round_mine_ms": [r.mine_ms for r in rep.rounds], "imbalance": rep.imbalance,
            "donations": len(rep.donations), "estimation_error": rep.estimation_error(),
            "waterfall": {"ideal_x": wf.ideal_x, "measured_x": wf.measured_x,
                          "gap_x": wf.gap_x, "wall_ms": wf.wall_ms,
                          "additivity_err": wf.additivity_error(),
                          "terms": {t.name: {"loss_x": t.loss_x, "ms": t.ms}
                                    for t in wf.terms}},
            "findings": findings, "worst": report["worst"], "doctor_gate_exit": gate,
            "critical_path": [(r["name"], r["self_ms"]) for r in
                              json.loads(cp_json)["table"]],
            "launches": launches}
    emit({"phase": "cluster_obs", "nvidia_smi": smi, "db": THESIS_DB, "support": SUPPORT,
          "P": 4, "K": 16, **out})
    return out["healthy"]["launches"]


def phase_ranks(dev, want, store_want, smi, tmp):
    """``mine`` and ``cluster_mine`` with ``-P 1 --devices 1`` on the thesis
    database, each in a child process that runs its miner as a rank of a
    one-rank NCCL group on the card (one H100 admits a world of one: NCCL
    puts no two ranks on one GPU): ``backend=nccl``, and |F| and the FITable
    (its SHA-256, ``--digest``) those of ``main``; each generates the
    database itself.  Beside them ``mine --store`` on the store the ``store``
    phase wrote under ``tmp``, its rank reading its shard off disk: the
    FITable ``store_want`` of the dense mine of the store's rows.  The three
    children run side by side, their output in files under ``tmp``."""
    from repro_torch.core import fimi

    backend = "nccl" if dev.type == "cuda" else "gloo"
    argv = ["--support", str(SUPPORT), "-P", "1", "--devices", "1", "--frontier", "16",
            "--digest", "--device", dev.type]
    runs = {"mine": ("repro_torch.launch.mine", ["--db", THESIS_DB], want),
            "cluster_mine": ("repro_torch.launch.cluster_mine", ["--db", THESIS_DB], want),
            "mine_store": ("repro_torch.launch.mine", ["--store", f"{tmp}/st"], store_want)}
    env = dict(os.environ, PYTHONPATH=str(SRC))
    t0 = time.perf_counter()
    procs, walls = {}, {}
    try:
        for name, (module, source, _) in runs.items():
            with open(f"{tmp}/ranks_{name}.out", "w") as out, \
                    open(f"{tmp}/ranks_{name}.err", "w") as err:
                procs[name] = subprocess.Popen([sys.executable, "-m", module, *source, *argv],
                                               cwd=ROOT, env=env, stdout=out, stderr=err)
        for name, proc in procs.items():
            proc.wait(timeout=300)
            walls[name] = time.perf_counter() - t0
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    rows = {}
    for name, proc in procs.items():
        fis = runs[name][2]
        digest = fimi.fitable_digest(fis)
        lines = Path(f"{tmp}/ranks_{name}.out").read_text().splitlines()
        head = next((line for line in lines if line.startswith("|F| = ")), "")
        launches = next((line for line in lines if line.startswith("kernel launches: ")), "")
        if proc.returncode != 0 or f"backend={backend}" not in head \
                or f"|F| = {len(fis)} " not in head or f"FITable sha256={digest}" not in lines:
            err = Path(f"{tmp}/ranks_{name}.err").read_text()[-2000:]
            fail(f"ranks ({name}): exit {proc.returncode}, {head!r}, want |F| = {len(fis)} "
                 f"backend={backend} and the FITable {digest}; stderr: {err}")
        counts = {k: int(n) for k, n in (kv.split("=") for kv in launches.split()[2:])}
        if counts.get("multi_extension_supports", 0) <= 0 \
                or counts.get("extension_supports", 0) <= 0:
            fail(f"ranks ({name}): B1 and B3 must launch: {counts}")
        rows[name] = {"exit": 0, "backend": backend, "n_fis": len(fis), "fitable_sha256": digest,
                      "equals": "the store's dense mine" if name == "mine_store" else "main",
                      "wall_s": walls[name], "line": head, "launches": counts}
        if name == "mine_store":
            rows[name]["host_high_water"] = next(
                (line for line in lines if line.startswith("streamed host high-water")), "")
    emit({"phase": "ranks", "nvidia_smi": smi, "db": THESIS_DB, "support": SUPPORT, "P": 1,
          "devices": 1, **rows})
    return {k: sum(row["launches"].get(k, 0) for row in rows.values()) for k in KERNELS}


# lm_serve: the full configs served on the card, and the generated tokens of each
LM_FULL = (("llama3.2-3b", 32), ("olmoe-1b-7b", 8), ("mamba2-1.3b", 8))
LM_BATCH, LM_PROMPT = 4, 16
LM_FULL_TOL, LM_SMOKE_TOL, LM_SMOKE_BF16_TOL = 5e-2, 1e-3, 0.25
# a full config's width is checked at this depth (see lm_full_run)
LM_CHECK_LAYERS = 4


def lm_agreement(torch, cfg, params, prompts, run):
    """The decode logits ``run`` kept at every prompt position against
    ``forward`` on the same prompts: the largest difference as a share of
    max |logit|, and the greedy token at the prompt's end from the decode,
    the forward, ``make_prefill_step`` and the first generated token."""
    from repro_torch.models import model as M
    from repro_torch.models.steps import make_prefill_step

    t0 = time.perf_counter()
    with torch.no_grad():
        full = M.forward(cfg, params, {"tokens": prompts})
    torch.cuda.synchronize()
    forward_s = time.perf_counter() - t0
    last = make_prefill_step(cfg)(params, {"tokens": prompts})
    V = cfg.vocab
    dec, fwd = run.prompt_logits[..., :V].double(), full[..., :V].double()
    scale = float(fwd.abs().max())
    greedy = {"decode": dec[:, -1].argmax(-1).tolist(), "forward": fwd[:, -1].argmax(-1).tolist(),
              "prefill_step": last[:, :V].double().argmax(-1).tolist(),
              "first_generated": run.tokens[:, 0].tolist()}
    agree = len({tuple(v) for v in greedy.values()}) == 1
    return {"decode_vs_forward": float((dec - fwd).abs().max()) / scale, "max_abs_logit": scale,
            "greedy": greedy, "greedy_agrees": agree, "forward_s": forward_s}


def lm_full_run(torch, dev, arch, gen):
    """One full config through ``serve.generate`` on the card, bf16 weights
    from seed 0: the parameter count, the walls, tokens a second and peak
    memory, every token below the vocabulary and finite logits, and its
    decode against ``forward``, reported.  Under the reference's init law
    (fan-in ``shape[-2]``: the head count for the attention projections)
    attention is near one-hot, so a rounding difference flips the key a
    query takes and the stack amplifies it: at full depth decode and
    forward part by O(1) in bf16 and in f32, so that figure is not checked.
    The check runs at the config's full width cut to ``LM_CHECK_LAYERS``
    layers, on f32 weights from seed 0: decode against forward within
    ``LM_FULL_TOL`` with the greedy tokens equal."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.launch import serve
    from repro_torch.models import model as M

    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = M.init(cfg, 0, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = model.n_params()
    if n != M.n_params(cfg):
        fail(f"lm_serve ({arch}): {n} parameters on the card, the spec tree says "
             f"{M.n_params(cfg)}")
    params = model.params()
    del model
    prompts, frames = serve.draw_inputs(cfg, LM_BATCH, LM_PROMPT, 0, dev)
    serve.generate(cfg, params, prompts[:, :2], 2, frames=frames)   # warm-up, untimed
    run = serve.generate(cfg, params, prompts, gen, frames=frames, keep_prompt_logits=True)
    peak = torch.cuda.max_memory_allocated()
    tokens_ok = bool(((run.tokens >= 0) & (run.tokens < cfg.vocab)).all())
    served = lm_agreement(torch, cfg, params, prompts, run)
    row = {"n_params": n, "n_params_analytic": cfg.n_params(), "param_dtype": cfg.param_dtype,
           "n_layers": cfg.n_layers, "d_model": cfg.d_model, "batch": LM_BATCH,
           "prompt": LM_PROMPT, "gen": gen, "init_s": init_s, "prefill_s": run.prefill_s,
           "decode_s": run.decode_s, "decode_ms_per_step": run.decode_s / gen * 1e3,
           "tokens_per_s": run.tokens_per_s, "gen_tokens_per_s": LM_BATCH * gen / run.decode_s,
           "peak_mem_bytes": peak, "tokens_below_vocab": tokens_ok,
           "first_sequence": run.tokens[0, :16].tolist(), "bf16": served}
    finite = bool(torch.isfinite(run.prompt_logits).all()) and np.isfinite(
        served["max_abs_logit"])
    del params, run
    torch.cuda.empty_cache()

    cut = dataclasses.replace(cfg, n_layers=LM_CHECK_LAYERS, param_dtype="float32")
    p32 = M.init(cut, 0, dev).params()
    run32 = serve.generate(cut, p32, prompts, 1, frames=frames, keep_prompt_logits=True)
    check = lm_agreement(torch, cut, p32, prompts, run32)
    row["check"] = {"n_layers": LM_CHECK_LAYERS, **check}
    del p32, run32
    if not tokens_ok or not finite or not check["decode_vs_forward"] <= LM_FULL_TOL \
            or not check["greedy_agrees"]:
        fail(f"lm_serve ({arch}): served tokens below the vocabulary {tokens_ok}, logits "
             f"finite {finite}; at {LM_CHECK_LAYERS} layers f32 decode against forward "
             f"{check['decode_vs_forward']} (tolerance {LM_FULL_TOL}), greedy "
             f"{check['greedy']}")
    return row


def lm_smoke_run(torch, dev, arch):
    """One ``smoke()`` config, its weights drawn on the CPU in f32, in f32
    and cast to bf16 (the casts of the served dtype): a forward of 8 tokens
    and 8 decode steps on the card against the same on the CPU, within
    ``LM_SMOKE_TOL`` (f32) and ``LM_SMOKE_BF16_TOL`` (bf16) x max |logit|."""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.models.layers import map_tree

    cfg32 = get_config(arch, smoke=True)
    p32 = M.init(cfg32, 0, "cpu").params()
    g = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg32.vocab, (2, 8), generator=g)}
    if cfg32.family == "vlm":
        batch["vision_embeds"] = torch.randn((2, cfg32.vision_tokens, cfg32.d_model),
                                             generator=g)
    if cfg32.family == "encdec":
        batch["frames"] = torch.randn((2, cfg32.enc_context, cfg32.d_model), generator=g)
    row = {"family": cfg32.family}
    for name, dtype, tol in (("float32", torch.float32, LM_SMOKE_TOL),
                             ("bfloat16", torch.bfloat16, LM_SMOKE_BF16_TOL)):
        cfg = dataclasses.replace(cfg32, param_dtype=name)
        cpu_params = map_tree(lambda a: a.to(dtype), p32)
        out = {}
        for where, params in (("cpu", cpu_params),
                              ("cuda", map_tree(lambda a: a.to(dev), cpu_params))):
            b = {k: v.to(params["embed"].device) for k, v in batch.items()}
            with torch.no_grad():
                logits = [M.forward(cfg, params, b)]
                cache = M.init_cache(cfg, 2, 8, dtype, params["embed"].device)
                if cfg.family == "encdec":
                    cache = M.encode(cfg, params, b["frames"], cache)
                for t in range(8):
                    logits.append(
                        M.decode_step(cfg, params, cache, b["tokens"][:, t:t + 1], t)[0])
            out[where] = [lg[..., : cfg.vocab].float().cpu() for lg in logits]
        scale = max(float(lg.abs().max()) for lg in out["cpu"])
        err = max(float((a - b).abs().max()) for a, b in zip(out["cuda"], out["cpu"])) / scale
        row[name] = {"card_vs_cpu": err, "max_abs_logit": scale}
        if not err <= tol:
            fail(f"lm_serve ({arch} smoke, {name}): the card's logits differ from the "
                 f"CPU's by {err} x max |logit| (tolerance {tol})")
    return row


def phase_lm_serve(torch, dev, smi):
    """The LM substrate's serving path on the card: the full configs of
    ``LM_FULL`` through ``serve.generate``, then every architecture's smoke
    config on the card against the CPU.  Plain PyTorch throughout: the LM
    substrate reaches no ``pl.pallas_call`` in the reference, so it has no
    kernel of this port."""
    from repro_torch.configs.registry import all_archs

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 compares as f32
    t0 = time.perf_counter()
    full = {arch: lm_full_run(torch, dev, arch, gen) for arch, gen in LM_FULL}
    torch.cuda.empty_cache()
    smoke = {arch: lm_smoke_run(torch, dev, arch) for arch in all_archs()}
    emit({"phase": "lm_serve", "nvidia_smi": smi,
          "tolerance": {"full": LM_FULL_TOL, "full_layers": LM_CHECK_LAYERS,
                        "smoke": LM_SMOKE_TOL, "smoke_bf16": LM_SMOKE_BF16_TOL},
          "full": full, "smoke": smoke, "wall_s": time.perf_counter() - t0})


# lm_train: the training path on the card (``repro_torch.launch.train``'s loop).
# The full config at the launcher's defaults (batch 8 x seq 128, accum 1), 6 steps
LM_TRAIN_ARCH, LM_TRAIN_STEPS, LM_TRAIN_BATCH, LM_TRAIN_SEQ = "llama3.2-3b", 6, 8, 128
# card against CPU, the CPU tests' bounds (tests/torch_lm_train_parity.py): the
# loss in nats, each leaf's gradient as a share of its max |g|, the grad norm
# relative; whisper's own (its f32 gradients are ill-conditioned); the
# parameters after one step within 2 lr
LM_TRAIN_LOSS_TOL, LM_TRAIN_GRAD_REL, LM_TRAIN_NORM_REL = 1e-5, 1e-3, 1e-4
LM_TRAIN_COND = {"whisper-small": 1e-2}
# and under this share of their elements more than 1e-6 apart; m and v
# within 2x the gradient's bound
LM_TRAIN_PARAM_SHARE = 0.01
# the memorize-and-resume drill of tests/test_checkpoint_train.py
LM_MEMO_STEPS, LM_MEMO_SAVE_AT = 25, 9


def lm_train_full(torch, dev):
    """(a) The full config through ``train.train`` on the card: bf16
    parameters, f32 AdamW state, ``remat="block"``, no checkpoint.  Every
    loss and grad norm finite, each step's lr equal to ``lr_at`` of its
    step, the parameters as many as the spec tree's, in bf16, the moments
    in f32."""
    from repro_torch.configs.registry import get_config
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.models.layers import leaves
    from repro_torch.optim import adamw

    cfg = get_config(LM_TRAIN_ARCH)
    torch.cuda.empty_cache()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    lines = []
    t0 = time.perf_counter()
    run = train.train(cfg, steps=LM_TRAIN_STEPS, batch=LM_TRAIN_BATCH, seq=LM_TRAIN_SEQ,
                      ckpt_dir=None, seed=0, device=dev, log=lines.append)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    params = dict(leaves(run.params))
    n = sum(t.numel() for t in params.values())
    tokens = LM_TRAIN_BATCH * LM_TRAIN_SEQ
    lr_want = [float(adamw.lr_at(torch.tensor(r.step + 1, dtype=torch.int32, device=dev),
                                 run.opt_cfg)) for r in run.records]
    steps_ = [{"step": r.step, "loss": r.loss, "grad_norm": r.grad_norm, "lr": r.lr,
               "wall_s": r.wall_s, "tokens_per_s": tokens / r.wall_s} for r in run.records]
    steady = [r.wall_s for r in run.records[1:]]
    row = {"arch": cfg.name, "n_params": n, "n_params_spec": M.n_params(cfg),
           "param_dtype": cfg.param_dtype, "state_dtype": run.opt_cfg.state_dtype,
           "remat": cfg.remat, "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ, "accum": 1,
           "steps": steps_, "lr_at": lr_want, "wall_s": wall,
           "step_s_median_after_first": statistics.median(steady),
           "tokens_per_s_median_after_first": tokens / statistics.median(steady),
           "peak_mem_bytes": peak, "log": lines}
    dtypes = ({str(t.dtype) for t in params.values()},
              {str(t.dtype) for _, t in leaves(run.opt.m)} | {str(t.dtype) for _, t in
                                                              leaves(run.opt.v)})
    finite = all(np.isfinite(r.loss) and np.isfinite(r.grad_norm) for r in run.records)
    del run, params
    torch.cuda.empty_cache()
    if n != M.n_params(cfg) or not finite or [r["lr"] for r in steps_] != lr_want \
            or dtypes != ({"torch.bfloat16"}, {"torch.float32"}) \
            or len(steps_) != LM_TRAIN_STEPS:
        fail(f"lm_train ({cfg.name}): {n} parameters (spec {M.n_params(cfg)}), finite "
             f"{finite}, lr {[r['lr'] for r in steps_]} against lr_at {lr_want}, dtypes "
             f"{dtypes}, {len(steps_)} steps")
    return row


def lm_train_remat(torch, dev):
    """(b) At the full config's width cut to 4 layers, the gradients of one
    batch with ``remat="block"`` and with ``"none"`` (``value_and_grad``'s
    body, inlined to read the memory between its halves): the memory the
    autograd graph holds after the forward and the peak of the forward and
    backward both lower with ``"block"``, the losses equal.  (The peak comes
    at the end of the backward, where the tied embedding's two gradients
    meet and no activation is left, so the peaks part by little; the
    memory held after the forward is the activations remat drops.)"""
    import dataclasses

    from repro_torch.configs.registry import get_config
    from repro_torch.data.lm_pipeline import SyntheticLM
    from repro_torch.launch import train
    from repro_torch.models import model as M
    from repro_torch.models.layers import leaves

    cut = dataclasses.replace(get_config(LM_TRAIN_ARCH), n_layers=LM_CHECK_LAYERS)
    params = M.init(cut, 0, dev).params()
    flat = [p for _, p in leaves(params)]
    b = SyntheticLM(cut.vocab, LM_TRAIN_SEQ, LM_TRAIN_BATCH, seed=1).batch_at(0)
    batch = train.make_batch(cut, b, 0, 0, dev)
    row = {"n_layers": LM_CHECK_LAYERS, "batch": LM_TRAIN_BATCH, "seq": LM_TRAIN_SEQ}
    for remat in ("block", "none"):
        cfg = dataclasses.replace(cut, remat=remat)
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        with torch.enable_grad():
            loss = M.loss_fn(cfg, params, batch)
            held = torch.cuda.memory_allocated() - base
            grads = torch.autograd.grad(loss, flat)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        row[remat] = {"loss": float(loss.detach()), "held_after_forward_bytes": held,
                      "peak_mem_bytes": torch.cuda.max_memory_allocated(),
                      "peak_above_params_bytes": torch.cuda.max_memory_allocated() - base,
                      "wall_s": wall}
        del loss, grads
    del params, flat
    torch.cuda.empty_cache()
    blk, none = row["block"], row["none"]
    if not (blk["peak_mem_bytes"] < none["peak_mem_bytes"]
            and blk["held_after_forward_bytes"] < none["held_after_forward_bytes"]
            and blk["loss"] == none["loss"]):
        fail(f"lm_train (remat at {LM_CHECK_LAYERS} layers): block {blk}, none {none}")
    return row


def _leaf_share(got, want) -> float:
    """max |got - want| as a share of max |want|, in f64 on ``got``'s device."""
    want = want.to(got.device)
    d = (got.double() - want.double()).abs().max()
    return float(d) / max(float(want.double().abs().max()), 1e-30)


def train_step_diff(want, got, grad_rel, norm_rel):
    """Two results of one train step from the same weights and batch, each
    ``{"loss", "grad_norm", "lr", "params", "m", "v"}`` (and ``"grads"``
    where both have them: ``{path: tensor}``), held to the CPU tests'
    bounds (``tests/torch_lm_train_parity.check_train_step``): the loss, the
    grad norm, each leaf's gradient as a share of its max |g|, the
    parameters after the step within 2 lr (Adam's first-step sign where |g|
    is rounding noise) with under 1 % of their elements beyond 1e-6, and the
    moments m and v within 2x the gradient's bound of each leaf's max.
    Each pair of leaves is compared on ``got``'s device.  Returns the row
    and whether every bound held."""
    def worst_share(name):
        return max(_leaf_share(got[name][k], t) for k, t in want[name].items())

    dparam, beyond, total = 0.0, 0, 0
    for k, t in want["params"].items():
        g = got["params"][k]
        d = (g.detach().double() - t.detach().to(g.device).double()).abs()
        dparam = max(dparam, float(d.max()))
        beyond += int((d > 1e-6).sum())
        total += d.numel()
    lr = want["lr"]
    row = {"loss_diff": abs(got["loss"] - want["loss"]),
           "grad_norm_rel_diff": abs(got["grad_norm"] - want["grad_norm"]) / want["grad_norm"],
           "max_param_diff": dparam, "param_share_beyond_1e-6": beyond / total,
           "worst_m_share": worst_share("m"), "worst_v_share": worst_share("v"), "lr": lr,
           "grad_tolerance": grad_rel, "norm_tolerance": norm_rel}
    if "grads" in want and "grads" in got:
        row["worst_grad_share"] = worst_share("grads")
    ok = (row["loss_diff"] <= LM_TRAIN_LOSS_TOL and row["grad_norm_rel_diff"] <= norm_rel
          and row.get("worst_grad_share", 0.0) <= grad_rel and dparam <= 2 * lr * (1 + 1e-4)
          and row["param_share_beyond_1e-6"] < LM_TRAIN_PARAM_SHARE
          and row["worst_m_share"] <= 2 * grad_rel and row["worst_v_share"] <= 2 * grad_rel)
    return row, ok


def lm_train_parity_run(torch, dev, arch, accum=1):
    """(c) One train step of a ``smoke()`` config in f32 on the card and on
    the CPU from the same weights and batch, to the CPU tests' bounds
    (``tests/torch_lm_train_parity.check_train_step``): the loss, the grad
    norm, each leaf's gradient (as a share of its max |g|), the parameters
    after the step within 2 lr (Adam's first-step sign where |g| is rounding
    noise) with under 1 % of their elements beyond 1e-6, and the moments m
    and v within 2x the gradient's bound of each leaf's max."""
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.models import steps
    from repro_torch.models.layers import leaves, map_tree
    from repro_torch.optim import adamw

    cfg = get_config(arch, smoke=True)
    B, T = 2 * accum, 8
    rng = np.random.default_rng(0)
    b = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (B, T)).astype(np.int32)),
         "loss_mask": torch.from_numpy(rng.random((B, T - 1)) < 0.8)}
    if cfg.family == "vlm":
        b["vision_embeds"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.vision_tokens, cfg.d_model)).astype(np.float32))
    if cfg.family == "encdec":
        b["frames"] = torch.from_numpy(rng.standard_normal(
            (B, cfg.enc_context, cfg.d_model)).astype(np.float32))
    opt_cfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1)
    p_cpu = M.init(cfg, 0, "cpu").params()
    p_card = map_tree(lambda a: a.detach().to(dev, copy=True), p_cpu)  # before the CPU step
    out = {}
    for where, params in (("cpu", p_cpu), ("cuda", p_card)):
        batch = {k: v.to(params["embed"].device) for k, v in b.items()}
        loss, grads = steps.accumulated_grads(cfg, params, batch, accum)
        grads_host = {k: g.float().cpu() for k, g in leaves(grads)}
        params, opt, m = adamw.update(grads, adamw.init(params, opt_cfg), params, opt_cfg)
        out[where] = {"loss": float(loss), "grad_norm": float(m["grad_norm"]),
                      "lr": float(m["lr"]), "grads": grads_host,
                      "params": {k: t.detach().cpu() for k, t in leaves(params)},
                      "m": {k: t.cpu() for k, t in leaves(opt.m)},
                      "v": {k: t.cpu() for k, t in leaves(opt.v)}}
    cpu, card = out["cpu"], out["cuda"]
    grad_rel = LM_TRAIN_COND.get(arch, LM_TRAIN_GRAD_REL)
    norm_rel = LM_TRAIN_COND.get(arch, LM_TRAIN_NORM_REL)
    row, ok = train_step_diff(cpu, card, grad_rel, norm_rel)
    row = {"accum": accum, "loss_cpu": cpu["loss"], "loss_card": card["loss"], **row}
    if not ok:
        fail(f"lm_train ({arch} smoke, accum {accum}): the card's step differs from the "
             f"CPU's: {row}")
    return row


def lm_train_memorize(torch, dev, tmp):
    """(d) ``tests/test_checkpoint_train.py``'s drill on the card: llama
    smoke in f32, lr 3e-3, 2 warmup steps of 60, accum 2, one fixed batch,
    25 steps: the last loss below 0.8 of the first; the checkpoint after
    step 9, restored by the port's manager onto a ``meta`` template,
    replays step 10's loss within 1e-4."""
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.configs.registry import get_config
    from repro_torch.models import model as M
    from repro_torch.models import steps
    from repro_torch.optim import adamw

    cfg = get_config(LM_TRAIN_ARCH, smoke=True)
    params = M.init(cfg, 0, dev).params()
    opt_cfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=2, total_steps=60)
    opt = adamw.init(params, opt_cfg)
    step_fn = steps.make_train_step(cfg, opt_cfg, accum=2)
    fixed = np.random.default_rng(0).integers(0, cfg.vocab, size=(4, 32))
    batch = {"tokens": torch.from_numpy(fixed).to(dev)}
    mgr = CheckpointManager(Path(tmp) / "lm_memo", keep=2)
    losses = []
    t0 = time.perf_counter()
    for it in range(LM_MEMO_STEPS):
        params, opt, m = step_fn(params, opt, batch)
        losses.append(float(m["loss"]))
        if it == LM_MEMO_SAVE_AT:
            mgr.save(it, {"params": params, "opt": opt}, extra={"it": it})
    wall = time.perf_counter() - t0
    abstract = M.abstract(cfg)
    restored, extra = mgr.restore({"params": abstract, "opt": adamw.init(abstract, opt_cfg)},
                                  device=dev)
    _, _, m2 = step_fn(restored["params"], restored["opt"], batch)
    replay = float(m2["loss"])
    want = losses[LM_MEMO_SAVE_AT + 1]
    row = {"losses": losses, "wall_s": wall, "replayed_loss": replay, "original_loss": want,
           "replay_diff": abs(replay - want), "replay_bit_equal": replay == want,
           "extra": extra}
    if not (losses[-1] < 0.8 * losses[0] and abs(replay - want) < 1e-4
            and extra == {"it": LM_MEMO_SAVE_AT}):
        fail(f"lm_train (memorize and resume): {row}")
    return row


def phase_lm_train(torch, dev, smi, tmp):
    """The LM substrate's training path on the card: (a) the full config
    through the launcher's loop, (b) remat read, (c) every smoke config's
    step card against CPU (llama also at accum 2), (d) memorize and resume
    through the port's checkpoint manager.  Plain PyTorch throughout: the
    training half reaches no ``pl.pallas_call`` in the reference.  Returns
    (a)'s row."""
    from repro_torch.configs.registry import all_archs

    torch.backends.cuda.matmul.allow_tf32 = False   # f32 compares as f32
    t0 = time.perf_counter()
    full = lm_train_full(torch, dev)
    remat = lm_train_remat(torch, dev)
    parity = {arch: lm_train_parity_run(torch, dev, arch) for arch in all_archs()}
    parity[LM_TRAIN_ARCH + " accum 2"] = lm_train_parity_run(torch, dev, LM_TRAIN_ARCH, 2)
    memo = lm_train_memorize(torch, dev, tmp)
    emit({"phase": "lm_train", "nvidia_smi": smi,
          "tolerance": {"loss": LM_TRAIN_LOSS_TOL, "grad_share": LM_TRAIN_GRAD_REL,
                        "grad_norm": LM_TRAIN_NORM_REL, "conditioned": LM_TRAIN_COND,
                        "params_after_step": "2 lr",
                        "param_share_beyond_1e-6": LM_TRAIN_PARAM_SHARE,
                        "moments": "2 x grad_share"},
          "full": full, "remat": remat, "card_vs_cpu": parity, "memorize": memo,
          "wall_s": time.perf_counter() - t0})
    return full


# lm_shard: the sharding group on a one-rank NCCL mesh (``--lm-shard-child``)
LM_SHARD_ACCUM, LM_SHARD_LOGIT_TOL = 2, 1e-4


def lm_shard_child(out_path: str) -> None:
    """The child of ``phase_lm_shard``: one rank of a one-rank NCCL group on
    a 1x1 ``("data", "model")`` mesh.  llama3.2-3b at full config in bf16
    from seed 0, its parameters DTensors under the dry run's layout
    (``sharding.step_layout``: FSDP rules, ``batch_spec`` ``("data",)``,
    ``act_spec``); the step's gradients (``accumulated_grads``, accum 2), a
    prefill, a decode step and a train step, each against the same call on
    the plain parameters on the card, to ``lm_train`` (c)'s bounds.  Writes
    its row to ``out_path``; a bound missed exits 1."""
    sys.path.insert(0, str(SRC))
    import torch
    import torch.distributed as dist

    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import dtensor
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as M
    from repro_torch.models import steps
    from repro_torch.models.layers import leaves
    from repro_torch.optim import adamw

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    dist.init_process_group("nccl", device_id=dev, init_method="env://", world_size=1, rank=0)
    row = {"backend": dist.get_backend(), "arch": LM_TRAIN_ARCH, "batch": LM_TRAIN_BATCH,
           "seq": LM_TRAIN_SEQ, "accum": LM_SHARD_ACCUM}
    walls, bad = {}, []

    def timed(name, fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        walls[name] = time.perf_counter() - t0
        return out

    try:
        mesh = mesh_mod.make_debug_mesh(1, 1)
        cfg = get_config(LM_TRAIN_ARCH)
        layout = shd.step_layout(M.n_params(cfg), mesh)
        row["mesh"] = {"axes": list(mesh.mesh_dim_names), "shape": list(mesh.shape)}
        row["layout"] = {"batch_spec": list(layout.batch_axes), "act_spec": repr(layout.act_spec),
                         "state_dtype": layout.state_dtype}
        params = timed("init", lambda: M.init(cfg, 0, dev).params())
        dparams = timed("distribute", lambda: shd.distribute_tree(params, mesh, layout.rules,
                                                                   M.axes(cfg)))
        row["placements"] = {"/".join(k): repr(tuple(v.placements))
                             for k, v in leaves(dparams)}
        rng = np.random.default_rng(0)
        B, T = LM_TRAIN_BATCH, LM_TRAIN_SEQ
        tokens = torch.from_numpy(rng.integers(0, cfg.vocab, (B, T)).astype(np.int64)).to(dev)
        batch = {"tokens": tokens}

        def dist_batch(b):
            return {k: shd.distribute(v, shd.NamedSharding(
                mesh, shd.batch_spec_for(mesh, layout, tuple(v.shape))), requires_grad=False)
                for k, v in b.items()}

        torch.cuda.reset_peak_memory_stats()
        # the step's gradients
        loss_p, g_p = timed("grads_plain", lambda: steps.accumulated_grads(
            cfg, params, batch, LM_SHARD_ACCUM))
        loss_s, g_s = timed("grads_sharded_first", lambda: steps.accumulated_grads(
            cfg, dparams, dist_batch(batch), LM_SHARD_ACCUM, batch_spec=layout.batch_axes,
            act_spec=layout.act_spec))
        g_s = dict(leaves(g_s))
        same = all(tuple(g_s[k].placements) == tuple(p.placements) for k, p in leaves(dparams))
        shares = {"/".join(k): _leaf_share(g_s[k].to_local(), g)
                  for k, g in leaves(g_p)}
        row["grads"] = {"loss_plain": float(loss_p), "loss_sharded": float(dtensor.full(loss_s)),
                        "worst_share": max(shares.values()), "placements_equal": same}
        if abs(row["grads"]["loss_plain"] - row["grads"]["loss_sharded"]) > LM_TRAIN_LOSS_TOL \
                or row["grads"]["worst_share"] > LM_TRAIN_GRAD_REL or not same:
            bad.append("grads")
        del g_p, g_s, loss_s
        torch.cuda.empty_cache()
        # prefill and decode on the weights before the step
        n = B // LM_SHARD_ACCUM
        pre = {"tokens": tokens[:n]}
        lp = timed("prefill_plain", lambda: steps.make_prefill_step(cfg)(params, pre))
        ls = timed("prefill_sharded", lambda: steps.make_prefill_step(
            cfg, act_spec=layout.act_spec)(dparams, dist_batch(pre)))
        row["prefill_share"] = _leaf_share(dtensor.full(ls), lp)
        cache_p = M.init_cache(cfg, n, T + 8, params["embed"].dtype, dev)
        cache_s = shd.distribute_like(M.init_cache(cfg, n, T + 8, params["embed"].dtype, dev),
                                      shd.cache_shardings(cache_p, mesh))
        tok = shd.NamedSharding(mesh, shd.data_spec(mesh, n, 2))
        serve = steps.make_serve_step(cfg)
        dp, _ = timed("decode_plain", lambda: serve(params, cache_p, tokens[:n, :1], 0))
        ds, cache_s = timed("decode_sharded", lambda: serve(
            dparams, cache_s, shd.distribute(tokens[:n, :1], tok, requires_grad=False), 0))
        row["decode_share"] = _leaf_share(dtensor.full(ds), dp)
        row["cache_share"] = max(_leaf_share(dtensor.full(cache_s[k]), c)
                                 for k, c in cache_p.items())
        if max(row["prefill_share"], row["decode_share"], row["cache_share"]) \
                > LM_SHARD_LOGIT_TOL:
            bad.append("prefill/decode")
        del lp, ls, dp, ds, cache_p, cache_s
        # the train step, plain then sharded; the plain moments wait on the host
        opt_cfg = adamw.AdamWConfig(state_dtype=layout.state_dtype)
        opt = adamw.init(params, opt_cfg)
        params, opt, m_p = timed("train_step_plain", lambda: steps.make_train_step(
            cfg, opt_cfg, accum=LM_SHARD_ACCUM)(params, opt, batch))
        host_m = timed("moments_to_host", lambda: {k: t.cpu() for k, t in leaves(opt.m)})
        host_v = {k: t.cpu() for k, t in leaves(opt.v)}
        del opt
        torch.cuda.empty_cache()
        dopt = adamw.init(dparams, opt_cfg)
        dparams, dopt, m_s = timed("train_step_sharded", lambda: steps.make_train_step(
            cfg, opt_cfg, accum=LM_SHARD_ACCUM, batch_spec=layout.batch_axes,
            act_spec=layout.act_spec)(dparams, dopt, dist_batch(batch)))
        sh, dm, dv = dict(leaves(dparams)), dict(leaves(dopt.m)), dict(leaves(dopt.v))
        plain = {"loss": float(m_p["loss"]), "grad_norm": float(m_p["grad_norm"]),
                 "lr": float(m_p["lr"]), "params": dict(leaves(params)), "m": host_m,
                 "v": host_v}
        local = {"loss": float(m_s["loss"]), "grad_norm": float(m_s["grad_norm"]),
                 "lr": float(m_s["lr"]), "params": {k: sh[k].to_local() for k in sh},
                 "m": {k: dm[k].to_local() for k in dm}, "v": {k: dv[k].to_local() for k in dv}}
        ts, ok = train_step_diff(plain, local, LM_TRAIN_GRAD_REL, LM_TRAIN_NORM_REL)
        row["train_step"] = {"loss_plain": plain["loss"], "loss_sharded": local["loss"],
                             "grad_norm_plain": plain["grad_norm"],
                             "grad_norm_sharded": local["grad_norm"],
                             "lr_sharded": local["lr"], **ts}
        if not (ok and plain["lr"] == local["lr"]):
            bad.append("train_step")
        row.update(walls_s=walls, peak_mem_bytes=torch.cuda.max_memory_allocated(),
                   replicated_ops=dtensor.replications(), failed=bad)
    finally:
        dist.destroy_process_group()
        Path(out_path).write_text(json.dumps(row))
    if bad:
        sys.exit(1)


def planned_bytes_per_rank():
    """Each full config's parameters plus AdamW state on one rank of the
    16x16 production mesh: the parameter and optimizer-state part of the
    dry run's argument bytes of its ``train_4k`` ``single`` cell
    (``dryrun.argument_bytes``), computed from the shapes; no rank holds
    them."""
    from repro_torch.configs.registry import all_archs
    from repro_torch.launch import dryrun

    out = {}
    for arch in all_archs():
        cell = dryrun.plan(arch, "train_4k", "single")
        arg = dryrun.argument_bytes(cell)
        out[arch] = {"n_params": cell.n_params, "state_dtype": cell.layout.state_dtype,
                     "params_bytes": arg["params"], "adamw_bytes": arg["opt"],
                     "total_bytes": arg["params"] + arg["opt"]}
    return out


def phase_lm_shard(torch, dev, smi, tmp):
    """The sharding group on the card: ``lm_shard_child`` in a child process
    (one rank of a one-rank NCCL group: one H100 admits a world of one),
    while this process frees the card's cache; then each full config's
    planned bytes a rank on the 16x16 production mesh, from the shapes."""
    from repro_torch.launch import ranks

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    out = Path(tmp) / "lm_shard.json"
    env = dict(os.environ, PYTHONPATH=str(SRC), RANK="0", WORLD_SIZE="1", LOCAL_RANK="0",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(ranks._free_port()))
    t0 = time.perf_counter()
    with open(Path(tmp) / "lm_shard.err", "w") as err:
        proc = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py"), "--lm-shard-child",
                               str(out)], cwd=ROOT, env=env, stderr=err, timeout=300)
    wall = time.perf_counter() - t0
    row = json.loads(out.read_text()) if out.exists() else {}
    if proc.returncode != 0 or row.get("failed") or row.get("backend") != "nccl":
        tail = (Path(tmp) / "lm_shard.err").read_text()[-3000:]
        fail(f"lm_shard: exit {proc.returncode}, {json.dumps(row)[:3000]}; stderr: {tail}")
    emit({"phase": "lm_shard", "nvidia_smi": smi,
          "tolerance": {"loss": LM_TRAIN_LOSS_TOL, "grad_share": LM_TRAIN_GRAD_REL,
                        "grad_norm": LM_TRAIN_NORM_REL, "params_after_step": "2 lr",
                        "param_share_beyond_1e-6": LM_TRAIN_PARAM_SHARE,
                        "moments": "2 x grad_share", "logits_and_cache": LM_SHARD_LOGIT_TOL},
          **row, "child_wall_s": wall,
          "planned_bytes_per_rank_16x16": {
              "note": "computed from the shapes under the dry run's layout, not measured",
              **planned_bytes_per_rank()}})


# dryrun: the dry run on fake worlds, in child processes (``--dryrun-child``)
DRYRUN_CELLS = (("llama3.2-3b", "decode_32k", "single"), ("olmoe-1b-7b", "decode_32k", "multi"))
#: the reference's record keys (``src/repro/launch/dryrun.py``), nested ones
#: under their parent's
DRYRUN_KEYS = {"arch", "shape", "mesh", "world", "n_params", "kind", "seq_len", "global_batch",
               "memory", "cost", "collectives", "timing", "overrides", "loops",
               "memory.argument_bytes", "memory.temp_bytes", "memory.output_bytes",
               "memory.alias_bytes", "memory.per_device_total_bytes", "memory.fits_16GB",
               "cost.flops_per_device", "cost.bytes_accessed_per_device", "timing.lower_s",
               "timing.compile_s", "loops.accum", "loops.layer_scan_trips", "loops.attn_chunk",
               "collectives.total_wire_bytes_per_device", "collectives.count"}
#: llama3.2-3b decode_32k on 16x16: the JAX package's memory_analysis
LLAMA_DECODE_ARGUMENT_BYTES = 1_986_743_716
#: the caching allocator rounds each block up to 512 B, and a block of the
#: large pool (over 1 MiB) keeps the rest of its segment when that rest is
#: 1 MiB or less (it splits only a larger one)
ALLOC_ROUND, ALLOC_SMALL = 512, 1 << 20


def record_keys(rec) -> set:
    out = set()
    for k, v in rec.items():
        out.add(k)
        if isinstance(v, dict) and k != "overrides":
            out.update(f"{k}.{kk}" for kk in v
                       if k != "collectives" or kk in ("total_wire_bytes_per_device", "count"))
    return out


def dryrun_row(run, wall):
    return {"record": run.record, "arguments": run.arguments,
            "replicated_ops": run.replications, "wall_s": wall}


def dryrun_child(job: str, out_path: str) -> None:
    """A child of ``phase_dryrun``: ``cells`` (the two ``run_cell``s),
    ``smoke_train`` (the ``train_4k`` policy on llama3.2-3b's smoke config)
    or ``card`` (``lm_train``'s step on a 1x1 fake world, then the same
    arguments placed on the card).  Writes its rows to ``out_path``."""
    sys.path.insert(0, str(SRC))
    import dataclasses

    import torch

    from repro_torch.configs.base import ShapeConfig
    from repro_torch.configs.registry import get_config
    from repro_torch.distributed import sharding as shd
    from repro_torch.launch import dryrun
    from repro_torch.launch import mesh as mesh_mod
    from repro_torch.models import model as M
    from repro_torch.models.layers import leaves
    from repro_torch.optim import adamw

    rows = {}
    if job == "cells":
        for cell in DRYRUN_CELLS:
            t0 = time.perf_counter()
            run = dryrun.dry_run(dryrun.plan(*cell))
            rows["/".join(cell)] = dryrun_row(run, time.perf_counter() - t0)
    elif job == "smoke_train":
        cell = dryrun.plan(LM_TRAIN_ARCH, "train_4k", "single")
        t0 = time.perf_counter()
        run = dryrun.dry_run(dryrun.on_model(cell, get_config(LM_TRAIN_ARCH, smoke=True)))
        rows["smoke_train_4k_single"] = dryrun_row(run, time.perf_counter() - t0)
    else:
        m = mesh_mod.debug_shape(1, 1)
        cell = dryrun.plan(LM_TRAIN_ARCH, "train_4k", "single")
        cell = dataclasses.replace(cell, mesh=m, layout=shd.step_layout(cell.n_params, m),
                                   shape=ShapeConfig("lm_train", LM_TRAIN_SEQ, LM_TRAIN_BATCH,
                                                     "train"), accum=1, attn_chunk=None)
        t0 = time.perf_counter()
        run = dryrun.dry_run(cell)
        row = dryrun_row(run, time.perf_counter() - t0)
        # the same arguments on the card: parameters, AdamW state, the batch
        dev = torch.device("cuda", 0)
        params = M.init(cell.cfg, 0, dev).params()
        opt = adamw.init(params, adamw.AdamWConfig(state_dtype=cell.layout.state_dtype))
        tokens = torch.zeros((LM_TRAIN_BATCH, LM_TRAIN_SEQ), dtype=torch.int32, device=dev)
        torch.cuda.synchronize()
        placed = [t for _, t in leaves({"p": params, "m": opt.m, "v": opt.v})]
        placed += [opt.step, tokens]
        blocks = [b for seg in torch.cuda.memory_snapshot() for b in seg["blocks"]
                  if b["state"] == "active_allocated"]
        sizes = [t.numel() * t.element_size() for t in placed]
        row["card"] = {"memory_allocated": torch.cuda.memory_allocated(),
                       "tensors": len(placed), "bytes": sum(sizes),
                       "blocks": len(blocks),
                       "requested_bytes": sum(b["requested_size"] for b in blocks),
                       "rounding_bound": sum(ALLOC_ROUND + (ALLOC_SMALL if n > ALLOC_SMALL
                                                            else 0) for n in sizes)}
        rows["lm_train_1x1"] = row
    Path(out_path).write_text(json.dumps(rows))


def phase_dryrun(torch, dev, smi, tmp, lm_train_peak):
    """The dry run in three child processes at once (``dryrun_child``); each
    record with the reference's keys, llama3.2-3b ``decode_32k``'s argument
    bytes the JAX package's, the train step's microbatch split gathered once,
    the 1x1 cell's argument bytes equal to what the card's allocator was asked
    for to hold the same arguments (``memory_allocated`` within its
    rounding), and its estimated peak beside
    ``lm_train``'s ``max_memory_allocated`` (``lm_train_peak``)."""
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("REPRO_ZERO1", None)
    t0 = time.perf_counter()
    procs = {}
    for job in ("cells", "smoke_train", "card"):
        err = open(Path(tmp) / f"dryrun_{job}.err", "w")
        procs[job] = (subprocess.Popen([sys.executable, str(ROOT / "chip_smoke.py"),
                                        "--dryrun-child", job,
                                        str(Path(tmp) / f"dryrun_{job}.json")],
                                       cwd=ROOT, env=env, stderr=err), err)
    rows, bad = {}, []
    for job, (proc, err) in procs.items():
        try:
            code = proc.wait(timeout=300)
        except subprocess.TimeoutExpired:
            proc.kill()
            code = proc.wait()
        err.close()
        out = Path(tmp) / f"dryrun_{job}.json"
        if code != 0 or not out.exists():
            tail = (Path(tmp) / f"dryrun_{job}.err").read_text()[-3000:]
            fail(f"dryrun ({job}): exit {code}; stderr: {tail}")
        rows.update(json.loads(out.read_text()))
    wall = time.perf_counter() - t0
    for name, row in rows.items():
        missing = DRYRUN_KEYS - record_keys(row["record"])
        extra = record_keys(row["record"]) - DRYRUN_KEYS
        if missing or extra:
            bad.append(f"{name}: keys missing {sorted(missing)}, not the reference's "
                       f"{sorted(extra)}")
    llama = rows["/".join(DRYRUN_CELLS[0])]["record"]["memory"]["argument_bytes"]
    if llama != LLAMA_DECODE_ARGUMENT_BYTES:
        bad.append(f"llama3.2-3b decode_32k argument bytes {llama}")
    smoke = rows["smoke_train_4k_single"]
    if smoke["record"]["loops"]["accum"] != 8 or smoke["replicated_ops"] != \
            {"microbatch.reshape": 1}:
        bad.append(f"smoke train step: {smoke['record']['loops']}, {smoke['replicated_ops']}")
    card = rows["lm_train_1x1"]
    arg = card["record"]["memory"]["argument_bytes"]
    alloc = card["card"]["memory_allocated"]
    # the allocator was asked for exactly the argument bytes, one block a
    # tensor, and holds them within its rounding
    if card["card"]["requested_bytes"] != arg or card["card"]["bytes"] != arg \
            or card["card"]["blocks"] != card["card"]["tensors"] \
            or not 0 <= alloc - arg <= card["card"]["rounding_bound"]:
        bad.append(f"1x1 argument bytes {arg} against the card's {card['card']}")
    estimate = card["record"]["memory"]["per_device_total_bytes"]
    emit({"phase": "dryrun", "nvidia_smi": smi, "torch": torch.__version__, "wall_s": wall,
          "rows": rows,
          "lm_train_1x1": {"argument_bytes": arg, "memory_allocated": alloc,
                           "estimated_peak_bytes": estimate,
                           "lm_train_max_memory_allocated": lm_train_peak,
                           "estimate_over_measured": estimate / lm_train_peak}})
    if bad:
        fail(f"dryrun: {bad}")


def phase_profile(torch, dev, dense, serve_run, store):
    """The main path, the cluster path with B1 and with B2, the store mine
    (its copies to the card among the device events) and the serve replay
    once more under ``torch.profiler``: how much of the wall the card is
    busy, and with what.  Only the trace's device-side events (kernels,
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
        "store": lambda: mine.mine_store(store, support=SUPPORT, P=4, frontier=16, device=dev),
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


def phase_variants(torch, dev, dense, want, smi, b3_ms):
    """``mine --variant seq`` and ``--variant par`` once each on the thesis
    database, with the launch counts of exactly that run; the seq run's MFI
    mine repeated on the CPU on the same sample rows (plain B3) must give
    the same candidate buffer.  ``b3_ms`` is B3's time a launch at the
    sample's shape (``kernels``), to set the Phase-1 host time a trip beside
    B3's device time."""
    from repro_torch.core import bitmap as bm
    from repro_torch.core import mfi
    from repro_torch.launch import mine
    from repro_torch.obs import metrics as obs_metrics

    on_path = mfi.mine_all_candidates
    launches_by = {}
    for variant in ("seq", "par"):
        mined = []

        def recording(db, min_support, **kw):
            out = on_path(db, min_support, **kw)
            mined.append((db, min_support, kw, out))
            return out

        print(f"variants: {THESIS_DB} sup={SUPPORT} P=4 K=16 variant={variant}", flush=True)
        mfi.mine_all_candidates = recording
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            reset_launch_counts()
            res, wall_s = mine.mine_dense(dense, support=SUPPORT, P=4, frontier=16, device=dev,
                                          materialize=True, variant=variant)
            launches = launch_counts()
            peak = torch.cuda.max_memory_allocated()
        finally:
            mfi.mine_all_candidates = on_path
        mine.report(res, wall_s)
        if res.launches != launches:
            fail(f"{variant}: the run counted {res.launches} launches, its wrappers {launches}")
        others = {k: n for k, n in launches.items()
                  if k not in ("multi_extension_supports", "extension_supports")}
        trips1 = int(res.phase1_iters.sum())
        if any(others.values()) or launches["multi_extension_supports"] <= 0 \
                or launches["extension_supports"] < trips1 or trips1 <= 0:
            fail(f"{variant}: not B3 (once a Phase-1 trip, {trips1}) and B1 alone: {launches}")
        if res.n_fis <= 0 or res.exchange_overflow or res.phase4_overflow.any():
            fail(f"{variant}: Phase 3 or 4 overflowed, or nothing was found")
        if len(res.fi_dict) != res.n_fis or res.fi_dict != want:
            fail(f"{variant}: the FITable ({res.n_fis}) differs from exact's ({len(want)})")
        if res.n_mfi <= 0:
            fail(f"{variant}: no MFI candidate to sample from")
        cpu = None
        if variant == "seq":
            if len(mined) != 1:
                fail(f"seq: {len(mined)} MFI mines, not one")
            db, min_support, kw, got = mined[0]
            t0 = time.perf_counter()
            ref = on_path(bm.BitmapDB(db.item_bits.cpu(), db.tx_bits.cpu(), db.n_tx, db.n_items),
                          min_support, **kw)
            cpu_s = time.perf_counter() - t0
            if (got.n_out, got.overflow, got.n_iters) != (ref.n_out, ref.overflow, ref.n_iters) \
                    or not torch.equal(got.items.cpu(), ref.items) \
                    or not torch.equal(got.supports.cpu(), ref.supports):
                fail(f"seq: the card's MFI buffer ({got.n_out}, {got.overflow}, {got.n_iters}) "
                     f"differs from the CPU's ({ref.n_out}, {ref.overflow}, {ref.n_iters})")
            cpu = {"equal": True, "n_tx": db.n_tx, "min_support": min_support,
                   "n_out": ref.n_out, "overflow": ref.overflow, "trips": ref.n_iters,
                   "cpu_s": cpu_s}
        trips4 = res.work_iters.astype(np.float64)
        phase1_s = res.phase_s["phase1"]
        emit({"phase": "variants", "variant": variant, "nvidia_smi": smi, "db": THESIS_DB,
              "support": SUPPORT, "P": 4, "K": 16, "n_fis": res.n_fis, "equals_exact": True,
              "phase1_trips": res.phase1_iters.tolist(), "mfi_kept": res.mfi_count.tolist(),
              "mfi_dropped": res.phase1_overflow.tolist(), "n_mfi": res.n_mfi,
              "classes": len(res.classes), "replication": res.replication,
              "est_loads": res.est_loads.tolist(), "phase4_trips": res.work_iters.tolist(),
              "obs_trip_shares": (trips4 / max(trips4.sum(), 1)).tolist(),
              "estimation_error": obs_metrics.registry().gauge(
                  "fimi/load/estimation_error").value,
              "phase_s": res.phase_s, "wall_s": wall_s, "peak_mem_bytes": peak,
              "phase1_s_per_trip": phase1_s / trips1,
              "b3_device_s": launches["extension_supports"] * b3_ms / 1e3,
              "launches": launches, "cpu_mfi": cpu})
        launches_by[variant] = launches["extension_supports"]
    return launches_by


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


def phase_store(torch, dev, sms, smi, tmp):
    """The out-of-core path once: spill into ``tmp``, mine from the store with
    the launch counts of exactly that run, the dense in-RAM mine of the same
    rows, the FITable's supports re-counted over the store on B5, and the
    launcher's ``--dataset --parity`` on the FIMI fixture; returns B5's timing
    at the store's shape, the path's launch counts and the store."""
    from repro_torch.data import ibm_gen
    from repro_torch.launch import mine
    from repro_torch.obs import metrics as obs_metrics
    from repro_torch.store import (BlockReader, pack_bool_np, streamed_itemset_supports,
                                   write_ibm_store)

    reg = obs_metrics.registry()
    t0 = time.perf_counter()
    store = write_ibm_store(ibm_gen.params_from_name(THESIS_DB, seed=0), f"{tmp}/st",
                            block_tx=STORE_BLOCK_TX)
    spill_s = time.perf_counter() - t0
    reader = BlockReader(store, STORE_BUDGET_BLOCKS, device=dev)
    if store.total_bytes <= reader.budget_bytes or store.n_blocks < 3:
        fail(f"store: {store.total_bytes}B in {store.n_blocks} blocks is not out of core "
             f"for a budget of {reader.budget_bytes}B")
    print(f"store: {store.n_blocks} blocks x <= {store.block_tx} tx ({store.total_bytes} "
          f"packed bytes on disk)  host budget = {STORE_BUDGET_BLOCKS} blocks "
          f"({reader.budget_bytes} bytes)  spilled in {spill_s:.2f}s", flush=True)

    # (a) the store mine: the reader, then B3 and B1
    stall = reg.histogram("store/prefetch_stall_s")
    stall0, blocks0 = stall.sum, reg.counter("store/blocks_read").value
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launch_counts()
    res, wall_s = mine.mine_store(store, support=SUPPORT, P=4, frontier=16, device=dev,
                                  materialize=True, reader=reader)
    launches = launch_counts()
    peak = torch.cuda.max_memory_allocated()
    stall_s = stall.sum - stall0
    blocks_read = reg.counter("store/blocks_read").value - blocks0
    mine.report(res, wall_s)
    others = {k: n for k, n in launches.items()
              if k not in ("multi_extension_supports", "extension_supports")}
    if launches["multi_extension_supports"] <= 0 or launches["extension_supports"] <= 0 \
            or any(others.values()) or res.launches != launches:
        fail(f"store: the mine did not launch B1 and B3 alone: {launches}, run {res.launches}")
    if res.exchange_overflow or res.phase1_overflow.any() or res.phase4_overflow.any() \
            or len(res.fi_dict) != res.n_fis or res.n_fis <= 0:
        fail("store: the mine overflowed or found nothing")
    # (d) the host high-water within the budget
    if not 0 < reader.peak_host_bytes <= reader.budget_bytes \
            or reader.staging_bytes > reader.budget_bytes:
        fail(f"store: host high-water {reader.peak_host_bytes}B (staging "
             f"{reader.staging_bytes}B) against a budget of {reader.budget_bytes}B")
    if blocks_read != store.n_blocks or not all(done for *_, done in reader.refills):
        fail(f"store: {blocks_read} blocks read of {store.n_blocks}, or a staging buffer "
             f"refilled before its copy completed: {reader.refills}")

    # (b) the dense in-RAM mine of the same rows
    t0 = time.perf_counter()
    dense = store.to_dense()
    to_dense_s = time.perf_counter() - t0
    ref, dense_wall_s = mine.mine_dense(dense, support=SUPPORT, P=4, frontier=16,
                                        device=dev, materialize=True)
    if not mine.parity(res.fi_dict, ref.fi_dict):
        fail(f"store: the FITable ({len(res.fi_dict)}) differs from the dense mine's "
             f"({len(ref.fi_dict)})")

    # (c) the FITable's supports re-counted over the store on B5
    sets = list(res.fi_dict)
    masks = np.zeros((len(sets), store.n_items), dtype=bool)
    for r, itemset in enumerate(sets):
        masks[r, list(itemset)] = True
    masks_dev = torch.from_numpy(pack_bool_np(masks).view(np.int32)).to(dev)
    reset_launch_counts()
    t0 = time.perf_counter()
    supports = streamed_itemset_supports(store, masks_dev)
    torch.cuda.synchronize()
    recount_s = time.perf_counter() - t0
    b5_launches = launch_counts()["block_itemset_supports"]
    non_empty = sum(1 for n in store.block_sizes if n)
    if b5_launches != non_empty:
        fail(f"store: B5 launched {b5_launches} times for {non_empty} non-empty blocks")
    want = np.array([res.fi_dict[k] for k in sets], dtype=np.int64)
    if not np.array_equal(supports.cpu().numpy(), want):
        fail("store: the supports re-counted over the store on B5 differ from the mine's")
    block0 = torch.from_numpy(store.read_block(0).view(np.int32)).to(dev)[None]
    b5 = time_block(torch, block0.contiguous(), masks_dev, sms)
    if b5["max_abs_err"]:
        fail(f"store: B5 disagrees with its plain version at S1 T{block0.shape[1]}: {b5}")

    # (e) the launcher's --dataset --parity on the FIMI fixture
    retail = mine.main(["--dataset", str(RETAIL_TINY), "--support", "0.2", "-P", "2",
                        "--parity", "--store", f"{tmp}/retail", "--device", dev.type])
    if not retail.fi_dict:
        fail("store: retail_tiny mined to nothing")

    emit({"phase": "store", "nvidia_smi": smi, "db": THESIS_DB, "seed": 0,
          "support": SUPPORT, "P": 4, "K": 16, "block_tx": STORE_BLOCK_TX,
          "blocks": store.block_sizes, "store_bytes": store.total_bytes,
          "budget_blocks": STORE_BUDGET_BLOCKS, "budget_bytes": reader.budget_bytes,
          "peak_host_bytes": reader.peak_host_bytes, "staging_bytes": reader.staging_bytes,
          "spill_s": spill_s, "assemble_s": res.phase_s["assemble_store"],
          "assemble_bytes_per_s": store.n_tx // 4 * 4 * store.n_words * 4
          / res.phase_s["assemble_store"],
          "prefetch_stall_s": stall_s, "blocks_read": blocks_read,
          "n_fis": res.n_fis, "equals_dense": True, "phase_s": res.phase_s, "wall_s": wall_s,
          "dense": {"to_dense_s": to_dense_s, "phase_s": ref.phase_s, "wall_s": dense_wall_s,
                    "n_fis": ref.n_fis},
          "recount": {"launches": b5_launches, "seconds": recount_s, "equals_mine": True},
          "retail_tiny": {"n_fis": len(retail.fi_dict), "parity": True},
          "peak_mem_bytes": peak, "launches": launches, "timed": b5})
    return b5, {**launches, "block_itemset_supports": b5_launches}, store, ref.fi_dict


def main() -> None:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"{SRC / 'repro_torch'} not found: run from the root of a checkout")
    if sys.argv[1:2] == ["--lm-shard-child"]:
        lm_shard_child(sys.argv[2])
        return
    if sys.argv[1:2] == ["--dryrun-child"]:
        dryrun_child(sys.argv[2], sys.argv[3])
        return
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
    b3_main = next(t for t in timings if t["name"] == "extension_supports"
                   and tuple(t["shape"].values()) == KERNELS[t["name"]]["main_shape"])
    b3_variants = phase_variants(torch, dev, dense, want, smi, b3_main["ms"])
    demo_launches = phase_profile_demo(torch, dev, dense, res.n_fis)
    launches["pair_supports_mxu"] = demo_launches["pair_supports_mxu"]
    phase_cluster(torch, dev, dense, THESIS_DB, want, use_mxu=False)
    launches_mxu = phase_cluster(torch, dev, dense, THESIS_DB, want, use_mxu=True)
    launches["multi_extension_supports_mxu"] = launches_mxu["multi_extension_supports_mxu"]
    phase_resume(dev, MID_DB, mid)
    store_dir = tempfile.TemporaryDirectory()  # removed when the script ends
    store_timing, store_launches, store, store_want = phase_store(torch, dev, sms, smi,
                                                                  store_dir.name)
    serve_run, launches_serve, serve_timings = phase_serve(torch, dev, dense, want, sms)
    launches["subset_superset_counts"] = launches_serve["subset_superset_counts"]
    fi = serve_run.fi_index
    launches_stream, stream_timings, stream_res, stream_blocks = phase_stream(
        torch, dev, sms, fi.masks[: fi.n_fis])
    stream_timing = stream_timings[1]
    launches["block_itemset_supports"] = launches_stream["block_itemset_supports"]
    engine = stream_res.miner.engine
    service_launches = phase_service(torch, dev, dense, serve_run, (engine.index, engine.rules),
                                     smi, store_dir.name)
    cluster_stream_launches = phase_stream_cluster(torch, dev, stream_res, stream_blocks, smi,
                                                   store_dir.name)
    cluster_obs_launches = phase_cluster_obs(torch, dev, dense, want, smi, store_dir.name)
    rank_launches = phase_ranks(dev, want, store_want, smi, store_dir.name)
    phase_lm_serve(torch, dev, smi)
    lm_train_row = phase_lm_train(torch, dev, smi, store_dir.name)
    phase_lm_shard(torch, dev, smi, store_dir.name)
    phase_dryrun(torch, dev, smi, store_dir.name, lm_train_row["peak_mem_bytes"])
    phase_profile(torch, dev, dense, serve_run, store)

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
                     for t in timings + [repl_timing] + stream_timings + [store_timing]
                     if t.get("launch")]})

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
            if t["name"] == "extension_supports":  # B3 on main, and on the MFI paths
                summary[-1]["launches_variants"] = b3_variants
            summary[-1]["launches_store"] = store_launches[t["name"]]
            summary[-1]["launches_service"] = service_launches[t["name"]]
            summary[-1]["launches_stream_cluster"] = cluster_stream_launches[t["name"]]
            summary[-1]["launches_cluster_obs"] = cluster_obs_launches[t["name"]]
            summary[-1]["launches_ranks"] = rank_launches[t["name"]]
            if t["name"] == "block_itemset_supports":  # B5 over the store's blocks
                summary[-1]["at_store_shape"] = {key: store_timing[key] for key in keys
                                                 if key in store_timing}
    emit({"kernels": summary, "launch_floor_ms": launch_floor_ms})
    print(f"chip_smoke: total {time.perf_counter() - t_start:.1f}s", file=sys.stderr)
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()

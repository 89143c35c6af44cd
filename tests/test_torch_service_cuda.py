"""The serving front end on the card: flushes on the dispatcher thread (kernel
B4), index pairs swapped in from another thread, built on that thread's own
CUDA stream.

Every case carries the ``cuda`` marker and skips where CUDA is not available.
The file imports neither JAX nor the JAX package, so it runs on a machine
with a card and PyTorch alone:

  PYTHONPATH=src python -m pytest -m cuda tests/test_torch_service_cuda.py

The CPU path of the same service is held to the JAX package's in
``test_torch_service.py``.  Every answer is compared exactly with the same
engine's on the CPU (B4's plain version) at the generation its flush served.
"""
import dataclasses
import threading
import time

import numpy as np
import pytest
import torch

from repro_torch.core import eclat
from repro_torch.data.ibm_gen import generate_dense, params_from_name
from repro_torch.kernels import subset_query as sq
from repro_torch.launch import serve_load
from repro_torch.obs import trace as obs_trace
from repro_torch.serve import Failed, MiningService, QueryCache, QueryEngine, Shed
from repro_torch.serve.index import build_indexes

pytestmark = pytest.mark.cuda

DB = "T1I0.032P20PL6TL10"


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA is not available")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def pairs():
    """Two index pairs over one database (supports 0.08 and 0.12), on the
    host, and the workload's query pools."""
    dense = generate_dense(params_from_name(DB, seed=0))
    n_tx, n_items = dense.shape
    out = []
    for support in (0.08, 0.12):
        fis = eclat.brute_force_fis(dense, int(np.ceil(support * n_tx)))
        out.append(build_indexes(fis, n_items, n_tx, min_confidence=0.5, device="cpu"))
        if support == 0.08:
            pools = serve_load.build_pools(np.random.default_rng(0), fis, dense, n_items, 64)
    return out, pools


def _copy(index, device):
    """The index with every tensor copied onto ``device`` on the current
    stream."""
    return dataclasses.replace(index, **{
        f.name: getattr(index, f.name).to(device, copy=True)
        for f in dataclasses.fields(index) if isinstance(getattr(index, f.name), torch.Tensor)})


def _same(got, want) -> bool:
    """One answer of each engine: a support, or (rows, values) with float32
    confidences bit-equal and NaN in the same slots."""
    if not isinstance(want, tuple):
        return int(got) == int(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        if g.dtype != w.dtype:
            return False
        if w.dtype == np.float32:
            if not np.array_equal(np.isnan(g), np.isnan(w)):
                return False
            g, w = np.nan_to_num(g).view(np.uint32), np.nan_to_num(w).view(np.uint32)
        if not np.array_equal(g, w):
            return False
    return True


def _cpu_answers(pair, asked, batch=32):
    """Each distinct (kind, mask) answered by the CPU engine over ``pair``."""
    eng = QueryEngine(*pair, batch=batch, top_k=5)
    call = {"support": lambda m: list(eng.support(m)),
            "rules": lambda m: list(zip(*eng.rules_for(m))),
            "superset": lambda m: list(zip(*eng.supersets(m)))}
    out = {}
    for kind in ("support", "rules", "superset"):
        keys = sorted({m for k, m in asked if k == kind})
        for lo in range(0, len(keys), batch):
            part = keys[lo: lo + batch]
            masks = np.stack([np.frombuffer(m, np.uint32) for m in part])
            out.update({(kind, m): v for m, v in zip(part, call[kind](masks))})
    return out


def _flushes_after(svc, n, timeout=60.0):
    """Wait until the service has made ``n`` more flushes."""
    target = svc.stats()["flushes"] + n
    deadline = time.monotonic() + timeout
    while svc.stats()["flushes"] < target and time.monotonic() < deadline:
        time.sleep(0.005)
    assert svc.stats()["flushes"] >= target, "the dispatcher made no progress"


def test_swaps_from_another_thread_under_load(cuda, pairs):
    """Six swaps from a second thread while six callers keep the service
    busy, each after 20 flushes of the generation before it: every answer
    equals the CPU engine's at the generation its flush served."""
    (pair_a, pair_b), pools = pairs
    dev_a, dev_b = (tuple(_copy(x, cuda) for x in p) for p in (pair_a, pair_b))
    engines = [QueryEngine(*dev_a, batch=32, top_k=5) for _ in range(2)]
    for eng in engines:     # the library's build and the first launches, off the load
        for kind, call in (("support", eng.support), ("rules", eng.rules_for),
                           ("superset", eng.supersets)):
            call(pools[kind][:32])
    launched = sq.subset_superset_counts_cuda.launches
    tr = obs_trace.TRACER
    tr.clear()
    tr.enable()
    svc = MiningService(engines, deadline_ms=2.0, max_queue=4096, cache=QueryCache(256))
    asked, tickets, lock, stop = {}, [], threading.Lock(), threading.Event()

    def caller(seed):
        wl = serve_load.Workload(np.random.default_rng(seed), pools, drift_every=0.5)
        while not stop.is_set():
            kind, mask = wl.draw()
            t = svc.submit(kind, mask)
            with lock:
                asked[t.id] = (kind, np.ascontiguousarray(mask, np.uint32).tobytes())
                tickets.append(t)
            t.result(60)

    def swapper():
        side = torch.cuda.Stream(cuda)
        with torch.cuda.stream(side):
            for gen in range(1, 7):
                _flushes_after(svc, 20)
                torch.cuda._sleep(50_000_000)        # the copies queue behind this
                pair = dev_b if gen % 2 else dev_a
                # device-to-device copies on the side stream: the swap must
                # wait for them before the dispatcher's stream reads them
                svc.swap_indexes(*(_copy(x, cuda) for x in pair))
        _flushes_after(svc, 20)

    callers = [threading.Thread(target=caller, args=(i,)) for i in range(6)]
    for t in callers:
        t.start()
    sw = threading.Thread(target=swapper)
    sw.start()
    sw.join(300)
    stop.set()
    for t in callers:
        t.join(60)
    assert not sw.is_alive() and not any(t.is_alive() for t in callers)
    svc.stop()
    tr.disable()

    st = svc.stats()
    failed = {v.error for v in (t.result(0) for t in tickets) if isinstance(v, Failed)}
    assert st["errors"] == 0 and not failed, failed
    assert st["shed"] == 0 and st["generation"] == 6 and st["flushes"] >= 7 * 20
    assert all(t.done() for t in tickets)
    assert sq.subset_superset_counts_cuda.launches > launched
    gen_of = {}
    for e in tr.export()["traceEvents"]:
        if e.get("name") == "service/flush" and e.get("ph") == "X":
            for rid in e["args"]["reqs"]:
                gen_of[rid] = e["args"]["generation"]
    tr.clear()
    assert set(gen_of) == {t.id for t in tickets} and set(gen_of.values()) == set(range(7))
    cpu = {0: _cpu_answers(pair_a, asked.values()), 1: _cpu_answers(pair_b, asked.values())}
    wrong = []
    for t in tickets:
        v = t.result(0)
        assert not isinstance(v, Shed), v
        if not _same(v, cpu[gen_of[t.id] % 2][asked[t.id]]):
            wrong.append((t.id, gen_of[t.id]))
    assert not wrong, wrong[:10]


def test_staged_flushes_equal_the_cpu_engine(cuda, pairs):
    (pair_a, _), pools = pairs
    dev = tuple(_copy(x, cuda) for x in pair_a)
    subs = [(k, m) for k in ("support", "rules", "superset") for m in pools[k]]
    out = {}
    for name, pair in (("cuda", dev), ("cpu", pair_a)):
        svc = MiningService([QueryEngine(*pair, batch=64, top_k=5) for _ in range(2)],
                            deadline_ms=50.0, auto_start=False)
        tickets = [svc.submit(k, m) for k, m in subs]
        svc.start()
        out[name] = [t.result(60) for t in tickets]
        svc.stop()
        assert svc.stats()["errors"] == 0
    assert all(_same(g, w) for g, w in zip(out["cuda"], out["cpu"]))

"""Streaming subsystem of the port: sliding-window ingestion with
drift-triggered re-mining and hot-swapped serving indexes.

  * :mod:`repro_torch.stream.window`  — device-resident ring buffer of packed
    transaction blocks, O(1) admit/expire, and the store-backed spill of
    the blocks it evicts;
  * :mod:`repro_torch.stream.monitor` — Thm 6.1 sample-based staleness test
    plus exact border tracking, deciding *when to re-mine*;
  * :mod:`repro_torch.stream.engine`  — :class:`StreamingMiner`: arrive/expire
    support deltas (kernel B5), full re-mine on trigger, atomic index hot-swap
    in the :class:`~repro_torch.serve.engine.QueryEngine`.

End-to-end launcher: ``python -m repro_torch.launch.stream_mine``.
"""
from repro_torch.stream.engine import (  # noqa: F401
    AdmitEvent,
    StreamingMiner,
    StreamParams,
    fimi_mine_fn,
)
from repro_torch.stream.monitor import DriftMonitor, DriftVerdict  # noqa: F401
from repro_torch.stream.window import SlidingWindow, WindowSpill  # noqa: F401

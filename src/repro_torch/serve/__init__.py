"""Serving subsystem of the port: mine once, serve many.

Turns a mined FI table into a queryable service, as the JAX package's
``serve`` does:

  * :mod:`repro_torch.serve.index`  — immutable device-resident FI/rule
    indexes (packed int32 itemset masks, metric vectors, per-size offsets);
  * :mod:`repro_torch.serve.engine` — batched query engine: Q queries per
    dispatch over the subset/superset sweep (kernel B4,
    ``repro_torch.kernels.subset_query``); indexes are hot-swappable under
    traffic (generation counter, used by ``repro_torch.stream``);
  * :mod:`repro_torch.serve.cache`  — LRU query cache keyed on packed query
    masks, with hit-rate counters and swap invalidation;
  * :mod:`repro_torch.serve.service` — the front end over N replica
    engines: arrival-stream micro-batching (flush on deadline or width),
    bounded-queue admission control with typed ``Shed`` results, and
    generation-consistent hot-swap across the replica fleet.

End-to-end launchers: ``python -m repro_torch.launch.serve_mine`` (static),
``python -m repro_torch.launch.stream_mine`` (streaming) and
``python -m repro_torch.launch.serve_load`` (arrival-process load harness
with live windowed SLO telemetry).
"""
from repro_torch.serve.cache import QueryCache  # noqa: F401
from repro_torch.serve.engine import EngineSnapshot, QueryEngine  # noqa: F401
from repro_torch.serve.index import FIIndex, RuleIndex  # noqa: F401
from repro_torch.serve.service import (  # noqa: F401
    Failed,
    MiningService,
    Shed,
    Ticket,
)

"""Bounded exponential-backoff retry — the store's transient-fault policy.

The port's own copy of the JAX package's ``store/retry.py``, on the port's
``obs/metrics.py`` (imported at the first call, so the store's host tools
import no torch).

Disk reads and host→device transfers fail transiently in production (NFS
hiccups, EINTR, a device briefly wedged); the mining contract is exactness,
so the right response is a bounded retry followed by a *typed* failure —
never a silent skip.  :class:`RetryPolicy` is a frozen value object so it
can sit in params dataclasses; the clock and sleep functions are injectable
so tests exercise the full backoff schedule in microseconds.

What is retryable is deliberately narrow by default (``OSError`` — the
environment failing) and never includes
:class:`~repro_torch.store.store.StoreIntegrityError`: a failed checksum is a
*persistent* fact about bytes on disk, and retrying it would just delay
the typed report the caller needs (fsck decides what happens next).
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Tuple, Type, TypeVar

T = TypeVar("T")


class RetriesExhausted(RuntimeError):
    """All attempts failed; ``__cause__`` is the last underlying error."""


@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with full-jitter-free determinism.

    ``delay(k)`` for attempt k (0-based) is ``base_delay_s · backoff^k``
    capped at ``max_delay_s`` — deterministic, so tests can assert the
    exact schedule.  ``attempts=1`` means no retry at all.
    """

    attempts: int = 3
    base_delay_s: float = 0.05
    backoff: float = 2.0
    max_delay_s: float = 2.0
    retry_on: Tuple[Type[BaseException], ...] = (OSError,)
    sleep: Callable[[float], None] = time.sleep
    clock: Callable[[], float] = time.monotonic

    def delay(self, attempt: int) -> float:
        return min(self.base_delay_s * self.backoff ** attempt,
                   self.max_delay_s)

    def call(self, fn: Callable[[], T], *, describe: str = "") -> T:
        """Run ``fn`` under the policy.

        Non-retryable exceptions propagate untouched on the first throw
        (typed integrity errors keep their type and context).  When the
        attempt budget runs out, the last retryable error is re-raised
        wrapped in :class:`RetriesExhausted` naming the operation, the
        attempt count, and the elapsed time.
        """
        from repro_torch.obs import metrics as obs_metrics

        assert self.attempts >= 1
        reg = obs_metrics.registry()
        t0 = self.clock()
        last: BaseException = None  # type: ignore[assignment]
        for k in range(self.attempts):
            reg.counter("store/retry/attempts").inc()
            try:
                return fn()
            except self.retry_on as e:
                reg.counter("store/retry/retried_errors").inc()
                last = e
                if k + 1 < self.attempts:
                    self.sleep(self.delay(k))
        reg.counter("store/retry/exhausted").inc()
        raise RetriesExhausted(
            f"{describe or 'operation'} failed after {self.attempts} "
            f"attempts over {self.clock() - t0:.3f}s: {last!r}"
        ) from last


#: No retries at all — for tests and for callers that do their own policy.
NO_RETRY = RetryPolicy(attempts=1)

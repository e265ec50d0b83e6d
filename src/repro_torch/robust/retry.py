"""Retry with backoff around ``ServeEngine.generate_with_status`` (the
counterpart of the reference's ``robust/retry.py``).

A ``TransientServeError`` is retried after a doubling backoff until the
attempt budget is spent, then raised again.  Every other error (a
``NumericalHealthError`` under ``on_nonfinite='raise'``, a programming
error) propagates at once: retrying a deterministic fault only burns the
request's time.  The wall-clock budget itself is
``ServeConfig.request_timeout_s`` and load shedding
``ServeConfig.max_lanes``; this adds the retries on top.
"""
from __future__ import annotations

import time

from repro_torch.robust.faults import FaultPlan, TransientServeError
from repro_torch.robust.guards import GenerateResult


def generate_with_retry(engine, batch, seed: int = 0, *,
                        retries: int = 2, backoff_s: float = 0.05,
                        fault_plan: FaultPlan = None,
                        sleep=time.sleep) -> GenerateResult:
    """``engine.generate_with_status(batch, seed, fault_plan=...)`` with up
    to ``retries`` retries on ``TransientServeError``, ``backoff_s``
    doubling between attempts; ``sleep`` is injectable so that a test
    reads the schedule without waiting it out."""
    if retries < 0:
        raise ValueError(f"retries must be >= 0, got {retries}")
    if backoff_s < 0:
        raise ValueError(f"backoff_s must be >= 0, got {backoff_s}")
    delay = backoff_s
    for attempt in range(retries + 1):
        try:
            return engine.generate_with_status(batch, seed,
                                               fault_plan=fault_plan)
        except TransientServeError:
            if attempt == retries:
                raise
            sleep(delay)
            delay *= 2

"""Tracing / profiling utilities.

Reference observability (SURVEY.md §5.1): structured '[Component]'
console logs, Date.now() phase timing, and the per-query ExecutionTrace.
Equivalents here: the same structured logging + phase timers (the
QueryTrace in core/types.py), plus jax.profiler hooks for device traces.
"""

from __future__ import annotations

import contextlib
import logging
import time
from typing import Iterator, Optional

_LOGGER = logging.getLogger("tpurag")


def get_logger(component: str) -> logging.LoggerAdapter:
    """Component-prefixed logger (reference: '[HybridSearch]' etc.)."""
    return logging.LoggerAdapter(_LOGGER, {"component": component})


def configure_logging(level: int = logging.INFO) -> None:
    handler = logging.StreamHandler()
    handler.setFormatter(logging.Formatter(
        "%(asctime)s [%(component)s] %(message)s", defaults={"component": "-"}))
    _LOGGER.handlers[:] = [handler]
    _LOGGER.setLevel(level)


@contextlib.contextmanager
def phase_timer(trace, phase: str) -> Iterator[None]:
    """Accumulates wall-clock into a QueryTrace phase (agent.ts:134-168
    style timing)."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        if trace is not None:
            trace.record(phase, time.perf_counter() - t0)


@contextlib.contextmanager
def device_trace(log_dir: Optional[str] = None) -> Iterator[None]:
    """jax.profiler trace for device-level kernel timing; view with
    tensorboard or xprof. No-op when log_dir is None."""
    if log_dir is None:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def block_and_time(fn, *args, reps: int = 5, **kw) -> float:
    """Min wall-clock seconds of fn(*args), each call ended by a host
    read of one element of its first output."""
    import numpy as np

    def run():
        out = fn(*args, **kw)
        leaves = [x for x in (out if isinstance(out, (tuple, list)) else [out])]
        np.asarray(leaves[0]).ravel()[:1]
        return out

    run()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        run()
        times.append(time.perf_counter() - t0)
    return min(times)

"""Continuous query batching.

The reference serves one query per HTTP request (SURVEY.md §3.1). On an
accelerator, throughput comes from batching: this queue coalesces concurrent queries
into device batches (up to max_batch, waiting at most max_wait_ms for
stragglers) — the host-side analogue of continuous batching in LLM
serving. Shapes bucket to powers of two so jit recompiles stay bounded.

Two operating modes:

* single-phase (`run_batch`): one consumer thread runs each batch to
  completion before starting the next — simple, but the device idles
  while the host tokenizes/assembles (the round-3 serving bottleneck).
* pipelined (`dispatch_batch` + `finalize_batch`): a dispatch thread
  performs host-side prep and LAUNCHES the device work (JAX async
  dispatch), handing a ticket to a finalize thread that pays the host
  sync and builds responses. Batch N+1's tokenization/dispatch overlaps
  batch N's device execution and host readback, hiding most of the
  blocking round-trip latency. In-flight
  depth is bounded (`max_inflight`) for backpressure.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from typing import Callable, Optional


class BatchingExecutor:
    def __init__(self, run_batch: Optional[Callable[[list], list]] = None,
                 max_batch: int = 64, max_wait_ms: float = 2.0,
                 dispatch_batch: Optional[Callable[[list], object]] = None,
                 finalize_batch: Optional[Callable[[object], list]] = None,
                 max_inflight: int = 3):
        """run_batch: list of requests -> list of responses (same order).

        OR pipelined: dispatch_batch(requests) -> ticket (must launch all
        device work without blocking on results) and
        finalize_batch(ticket) -> list of responses (same order)."""
        if (dispatch_batch is None) != (finalize_batch is None):
            raise ValueError("dispatch_batch and finalize_batch "
                             "must be provided together")
        if run_batch is None and dispatch_batch is None:
            raise ValueError("need run_batch or dispatch/finalize pair")
        self.run_batch = run_batch
        self.dispatch_batch = dispatch_batch
        self.finalize_batch = finalize_batch
        self.max_batch = max_batch
        self.max_wait = max_wait_ms / 1000.0
        self._q: queue.Queue = queue.Queue()
        self._stop = threading.Event()
        self.pipelined = dispatch_batch is not None
        if self.pipelined:
            self._inflight: queue.Queue = queue.Queue(maxsize=max_inflight)
            self._finalizer = threading.Thread(target=self._finalize_loop,
                                               daemon=True)
            self._finalizer.start()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def submit(self, request) -> Future:
        fut: Future = Future()
        self._q.put((request, fut))
        return fut

    def query(self, request, timeout: Optional[float] = 30.0):
        return self.submit(request).result(timeout=timeout)

    def _collect(self) -> Optional[list]:
        """Gather one batch from the request queue (None on idle tick)."""
        try:
            first = self._q.get(timeout=0.1)
        except queue.Empty:
            return None
        batch = [first]
        t0 = time.monotonic()
        while len(batch) < self.max_batch:
            remaining = self.max_wait - (time.monotonic() - t0)
            if remaining <= 0:
                break
            try:
                batch.append(self._q.get(timeout=remaining))
            except queue.Empty:
                break
        return batch

    def _loop(self) -> None:
        while not self._stop.is_set():
            batch = self._collect()
            if batch is None:
                continue
            requests = [r for r, _ in batch]
            futures = [f for _, f in batch]
            if self.pipelined:
                try:
                    ticket = self.dispatch_batch(requests)
                except Exception as e:
                    for f in futures:
                        if not f.done():
                            f.set_exception(e)
                    continue
                self._inflight.put((ticket, futures))
                continue
            try:
                results = self.run_batch(requests)
                for f, r in zip(futures, results):
                    f.set_result(r)
            except Exception as e:  # propagate to every waiter
                for f in futures:
                    if not f.done():
                        f.set_exception(e)

    def _finalize_loop(self) -> None:
        while True:
            try:
                item = self._inflight.get(timeout=0.5)
            except queue.Empty:
                if self._stop.is_set():
                    return
                continue
            if item is None:  # shutdown sentinel
                return
            ticket, futures = item
            try:
                results = self.finalize_batch(ticket)
                for f, r in zip(futures, results):
                    f.set_result(r)
            except Exception as e:
                for f in futures:
                    if not f.done():
                        f.set_exception(e)

    def shutdown(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)
        if self.pipelined:
            # Never block on a full in-flight queue (a wedged finalizer —
            # e.g. finalize_batch stuck on a dead device sync — would hang
            # shutdown forever). The sentinel is best-effort: _finalize_loop
            # also polls _stop between items.
            try:
                self._inflight.put_nowait(None)
            except queue.Full:
                pass
            self._finalizer.join(timeout=2.0)

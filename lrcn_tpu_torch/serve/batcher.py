"""Dynamic request batching for online serving.

A copy of ``lrcn_tpu/serve/batcher.py``: pure Python, but ``lrcn_tpu.serve``
loads JAX through its package ``__init__``.

The device's throughput comes from batched dispatches of a fixed batch
shape.  An online server therefore wants the classic dynamic-batching
loop: concurrent requests queue up, a single dispatcher thread drains up
to ``max_batch`` of them (waiting at most ``max_wait_ms`` for stragglers
once the first request arrives), pads the batch to that shape, and fans
results back out.

One dispatcher thread also serializes device access: interleaving
dispatches from request threads would destroy the very batching this
exists to create.

The reference has no serving story (generation is an offline loop,
lrcn.jl:127-160); this subsystem is new surface for production use.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future, InvalidStateError
from dataclasses import dataclass, field
from typing import Callable, Sequence


def _resolve(fut: Future, *, result=None, exc: Exception | None = None
             ) -> None:
    """Set a future's outcome, tolerating a concurrent cancel.

    Request threads cancel their futures on client timeout; if the
    cancel lands between our ``cancelled()`` check and the set, the
    raw ``set_result``/``set_exception`` raises ``InvalidStateError``
    out of the dispatcher/collector thread and permanently wedges the
    service.  The race is benign — the client already gave up — so a
    lost set is simply dropped.
    """
    try:
        if fut.cancelled():
            return
        if exc is not None:
            fut.set_exception(exc)
        else:
            fut.set_result(result)
    except InvalidStateError:
        pass


class BatcherOverloaded(RuntimeError):
    """Queue depth exceeded ``max_queue`` — shed load instead of letting
    latency grow without bound (the HTTP layer maps this to 503)."""


@dataclass
class BatcherStats:
    """Counters a dispatcher thread updates and /stats reports."""

    requests: int = 0
    batches: int = 0
    items: int = 0                      # items across all batches
    errors: int = 0
    shed: int = 0                       # rejected by max_queue backpressure
    latencies_ms: list = field(default_factory=list)   # bounded window

    _WINDOW = 2048

    def record_batch(self, n_items: int, latencies_ms: Sequence[float]
                     ) -> None:
        self.batches += 1
        self.items += n_items
        self.latencies_ms.extend(latencies_ms)
        if len(self.latencies_ms) > self._WINDOW:
            del self.latencies_ms[:len(self.latencies_ms) - self._WINDOW]

    def snapshot(self) -> dict:
        lat = sorted(self.latencies_ms)

        def pct(p: float) -> float:
            return round(lat[min(len(lat) - 1, int(p * len(lat)))], 2) \
                if lat else 0.0

        return {
            "requests": self.requests,
            "batches": self.batches,
            "mean_batch_size": round(self.items / self.batches, 2)
            if self.batches else 0.0,
            "errors": self.errors,
            "shed": self.shed,
            "latency_ms_p50": pct(0.50),
            "latency_ms_p99": pct(0.99),
        }


class DynamicBatcher:
    """Coalesce concurrent ``submit`` calls into batched ``fn`` calls.

    ``fn(items) -> results`` runs on the single dispatcher thread with
    ``1 <= len(items) <= max_batch``; ``results`` must align 1:1 with
    ``items``.  ``submit`` returns a ``concurrent.futures.Future``.

    **Pipelined mode**: with ``finalize`` given, ``fn`` only *issues*
    the batch (an asynchronous device launch, returning device tensors)
    and ``finalize(raw) -> results`` blocks for and unpacks it on a
    separate collector thread.  The dispatcher then drains/issues batch
    N+1 while batch N's results transfer back, hiding the device round
    trip of a synchronized loop.  ``max_inflight`` bounds
    issued-but-unfetched batches (device memory).
    """

    def __init__(self, fn: Callable[[list], list], *, max_batch: int,
                 max_wait_ms: float = 5.0, name: str = "batcher",
                 finalize: Callable | None = None, max_inflight: int = 2,
                 max_queue: int | None = None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        self.fn = fn
        self.finalize = finalize
        self.max_batch = max_batch
        self.max_wait_s = max_wait_ms / 1e3
        self.max_queue = max_queue
        self.name = name
        self.stats = BatcherStats()
        self._queue: queue.Queue = queue.Queue()
        self._closed = threading.Event()
        self._collector = None
        if finalize is not None:
            self._pending: queue.Queue = queue.Queue(maxsize=max_inflight)
            self._collector = threading.Thread(
                target=self._collect, name=f"lrcn-{name}-collect",
                daemon=True)
            self._collector.start()
        self._thread = threading.Thread(
            target=self._run, name=f"lrcn-{name}", daemon=True)
        self._thread.start()

    # --- client side ---

    def submit(self, item) -> Future:
        if self._closed.is_set():
            raise RuntimeError(f"{self.name} is closed")
        if self.max_queue is not None \
                and self._queue.qsize() >= self.max_queue:
            self.stats.shed += 1
            raise BatcherOverloaded(
                f"{self.name}: queue depth {self._queue.qsize()} >= "
                f"max_queue {self.max_queue}")
        fut: Future = Future()
        self._queue.put((item, fut, time.monotonic()))
        self.stats.requests += 1
        return fut

    def close(self, timeout: float = 5.0) -> None:
        self._closed.set()
        self._queue.put(None)           # wake the dispatcher
        self._thread.join(timeout)
        if self._collector is not None:
            self._pending.put(None)     # wake the collector
            self._collector.join(timeout)

    # --- dispatcher thread ---

    def _drain(self) -> list[tuple]:
        """Block for the first request, then gather stragglers."""
        first = self._queue.get()
        if first is None:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = self._queue.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is None:
                break
            batch.append(nxt)
        return [b for b in batch if not b[1].cancelled()]

    def _fan_out(self, batch: list[tuple], results: list) -> None:
        if len(results) != len(batch):
            self._fail(batch, RuntimeError(
                f"{self.name}: fn returned {len(results)} results "
                f"for {len(batch)} items"))
            return
        done = time.monotonic()
        for (_, fut, _), res in zip(batch, results):
            _resolve(fut, result=res)
        self.stats.record_batch(
            len(batch), [(done - t0) * 1e3 for _, _, t0 in batch])

    def _fail(self, batch: list[tuple], e: Exception) -> None:
        self.stats.errors += len(batch)
        for _, fut, _ in batch:
            _resolve(fut, exc=e)

    def _run(self) -> None:
        while not self._closed.is_set():
            batch = self._drain()
            if not batch:
                continue
            items = [b[0] for b in batch]
            try:
                raw = self.fn(items)
            except Exception as e:          # fan the failure out, keep serving
                self._fail(batch, e)
                continue
            if self.finalize is None:
                self._fan_out(batch, raw)
            else:                           # collector fetches; keep issuing
                self._pending.put((batch, raw))
        # resolve anything still queued so no future hangs for its full
        # client timeout after close
        while True:
            try:
                entry = self._queue.get_nowait()
            except queue.Empty:
                return
            if entry is not None:
                self._fail([entry], RuntimeError(f"{self.name} closed"))

    def _collect(self) -> None:
        while True:
            entry = self._pending.get()
            if entry is None:
                return
            batch, raw = entry
            try:
                results = self.finalize(raw)
            except Exception as e:
                self._fail(batch, e)
                continue
            self._fan_out(batch, results)

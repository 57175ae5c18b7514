"""Continuous micro-batching for fixed-shape device dispatches.

The port's copy of ``biom3_tpu/serving/batcher.py`` (pure Python; the
classes are held equal to the original by ``tests/test_torch_imports.py``).
A serving process wants every device dispatch at ONE batch size: the
batcher coalesces concurrent requests into fixed-size batches (padding is
the runner's job).

A single dispatch thread owns the device: requests enqueue from any number
of front-end threads, the dispatcher drains up to ``max_batch`` items —
waiting at most ``max_wait_s`` after the first item so a lone request is
never stuck behind an unfilled batch — runs them as one batch, and resolves
each request's future.
"""

from __future__ import annotations

import queue
import threading
import time
from concurrent.futures import Future
from dataclasses import dataclass, field


@dataclass
class BatcherStats:
    """Cumulative counters; snapshot with ``as_dict``."""

    requests: int = 0
    batches: int = 0
    items: int = 0
    errors: int = 0
    batch_latency_s_sum: float = 0.0
    batch_latency_s_max: float = 0.0
    _lock: threading.Lock = field(default_factory=threading.Lock)

    def record(self, n_items: int, latency_s: float, error: bool) -> None:
        with self._lock:
            self.batches += 1
            self.items += n_items
            self.errors += int(error)
            self.batch_latency_s_sum += latency_s
            self.batch_latency_s_max = max(self.batch_latency_s_max, latency_s)

    def as_dict(self) -> dict:
        with self._lock:
            mean_occ = self.items / self.batches if self.batches else 0.0
            mean_lat = (
                self.batch_latency_s_sum / self.batches if self.batches else 0.0
            )
            return {
                "requests": self.requests,
                "batches": self.batches,
                "items": self.items,
                "errors": self.errors,
                "mean_batch_occupancy": round(mean_occ, 3),
                "mean_batch_latency_s": round(mean_lat, 4),
                "max_batch_latency_s": round(self.batch_latency_s_max, 4),
            }


class MicroBatcher:
    """Coalesce submitted items into fixed-cap batches on one worker thread.

    ``run_batch(items) -> results`` must return one result per item (same
    order).  An exception from ``run_batch`` propagates to every future in
    that batch; the dispatcher keeps running.
    """

    def __init__(
        self,
        run_batch,
        *,
        max_batch: int,
        max_wait_s: float = 0.02,
        name: str = "batcher",
    ):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self._run_batch = run_batch
        self.max_batch = max_batch
        self.max_wait_s = max_wait_s
        self.stats = BatcherStats()
        self._queue: queue.Queue = queue.Queue()
        self._closed = threading.Event()
        # serializes the closed-check+enqueue in submit() against close()'s
        # final drain, so no future can be enqueued after the drain and
        # left permanently unresolved
        self._submit_lock = threading.Lock()
        self._thread = threading.Thread(
            target=self._loop, name=name, daemon=True
        )
        self._thread.start()

    def submit(self, item) -> Future:
        fut: Future = Future()
        with self._submit_lock:
            if self._closed.is_set():
                raise RuntimeError("batcher is closed")
            with self.stats._lock:
                self.stats.requests += 1
            self._queue.put((item, fut))
        return fut

    def close(self, timeout: float = 10.0) -> None:
        self._closed.set()
        self._thread.join(timeout=timeout)
        # a submit() racing close() can enqueue after the dispatcher's final
        # empty-queue check — fail those futures instead of leaving their
        # callers blocked until the request timeout.  The drain holds
        # _submit_lock: any put that beat us is drained here, any submit
        # that arrives after sees _closed and raises.
        with self._submit_lock:
            while True:
                try:
                    _, fut = self._queue.get_nowait()
                except queue.Empty:
                    break
                fut.set_exception(RuntimeError("batcher is closed"))

    # -- dispatcher ---------------------------------------------------

    def _drain_batch(self) -> list:
        """Block for the first item, then top up until max_batch or the
        coalescing window expires."""
        try:
            first = self._queue.get(timeout=0.1)
        except queue.Empty:
            return []
        batch = [first]
        deadline = time.monotonic() + self.max_wait_s
        while len(batch) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                # window expired: take whatever is already queued, no waiting
                try:
                    batch.append(self._queue.get_nowait())
                except queue.Empty:
                    break
            else:
                try:
                    batch.append(self._queue.get(timeout=remaining))
                except queue.Empty:
                    break
        return batch

    def _loop(self) -> None:
        while not (self._closed.is_set() and self._queue.empty()):
            batch = self._drain_batch()
            if not batch:
                continue
            items = [item for item, _ in batch]
            futures = [fut for _, fut in batch]
            t0 = time.monotonic()
            try:
                results = self._run_batch(items)
                if len(results) != len(items):
                    raise RuntimeError(
                        f"run_batch returned {len(results)} results for "
                        f"{len(items)} items"
                    )
            except Exception as exc:  # noqa: BLE001 — forwarded to callers
                self.stats.record(len(items), time.monotonic() - t0, True)
                for fut in futures:
                    fut.set_exception(exc)
                continue
            self.stats.record(len(items), time.monotonic() - t0, False)
            for fut, res in zip(futures, results):
                fut.set_result(res)

"""Row-granular packed scheduling for whole-trajectory dispatches.

Port of ``biom3_tpu/serving/trajectory.py`` for the fast modes, whose
trajectories have no useful admission boundaries inside them: blocked
path-order ARDM (``--preset latency``: k=8, temperature 0, L/k forwards a
design), confidence order (L/k forwards) and MaskGIT (``--preset
throughput``: 16 forwards).

  * **row granularity** — (request, replica) rows pack across request
    boundaries into fixed ``rows_per_dispatch`` batches, so a partial
    request's leftover rows ride the next dispatch instead of padding;
  * **a collector thread** — the scheduler thread enqueues a dispatch (its
    ids copied to pinned host memory without a wait) and hands it to the
    collector thread (``<name>-collect``), which waits for the ids, decodes
    them and resolves the requests as soon as they land, while the
    scheduler thread coalesces and enqueues the next dispatch (an enqueue
    can block on the device's launch queue for about a dispatch; a blocked
    launch releases the GIL);
  * **adaptive coalescing** — a partial batch waits for stragglers only
    while the wait is free (a dispatch enqueued and not yet collected when
    the scheduler begins the next keeps the device busy; the window
    stretches toward the measured dispatch time).

Each row decodes with its own noise stream (``serving.continuous.
row_streams``, ``diffusion.sampler.row_gumbel``; path order also in its own
order, which the other modes ignore), so
a seeded request reproduces bit for bit in any dispatch and needs no solo
padded dispatch, which the JAX scheduler gives it (its RNG is per
dispatch).

Under MaskGIT the engine's row function takes inpaint rows
(``accepts_masked``): a request carrying ``masked_ids`` becomes rows that
resume the sampler from the partial sequence and share dispatches with
generate rows (which resume from zeros).  The other modes refuse them.
On a mesh (``ServingPipeline(mesh=...)``) the row function's forward runs
over the mesh's (dp, fsdp) positions (JAX :70-73).

Two faults of the JAX scheduler are fixed here: the dispatches in flight
change only under ``_cv``, and the rows of a dispatch being enqueued stay
reachable (``_dispatching``) until they are in flight, so ``close()``'s
sweep fails them instead of leaving their clients to time out.  A dispatch
stays in the collector's queue (``_flights``) until its collect ends, so
the sweep reaches it while it is being collected too.

Under a profiler window the scheduler keeps spans (``utils/profiling.py``)
under each request's ``rid`` and each dispatch's ``did``: ``serve.request``
(submit to the future resolved), ``serve.queue`` (submit to the start of
the enqueue of the dispatch that carries the request's last row),
``serve.embed``, ``serve.coalesce`` (the straggler wait, with the rows
ready at its start and end), ``serve.dispatch`` (the enqueue),
``serve.collect`` (on the collector thread: the wait for the ids, the
decode and the resolution; ``ready`` if the copy had landed when it began)
and ``serve.idle`` (the wait with nothing queued, enqueued or being
collected).  The counters in ``stats`` are always on.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch

from biom3_tpu_torch.serving.batcher import BatcherStats
from biom3_tpu_torch.serving.continuous import KEY_WORDS, host_rng, row_streams
from biom3_tpu_torch.utils import profiling


@dataclass
class TrajectoryStats(BatcherStats):
    """``BatcherStats`` with each request's wait from submit to the enqueue
    of the dispatch carrying its last row, the dispatches whose ids were
    already on the host when the collector came to them, and the
    dispatches resolved before the next dispatch's enqueue returned (or
    with none enqueued after them)."""

    queue_wait_s_sum: float = 0.0
    queue_wait_s_max: float = 0.0
    dispatches_ready_at_collect: int = 0
    resolved_before_next_enqueue: int = 0

    def record_queue_wait(self, wait_s: float) -> None:
        with self._lock:
            self.queue_wait_s_sum += wait_s
            self.queue_wait_s_max = max(self.queue_wait_s_max, wait_s)

    def record_ready(self) -> None:
        with self._lock:
            self.dispatches_ready_at_collect += 1

    def record_resolved_before_next_enqueue(self) -> None:
        with self._lock:
            self.resolved_before_next_enqueue += 1

    def as_dict(self) -> dict:
        out = super().as_dict()
        with self._lock:
            out.update(queue_wait_s_sum=round(self.queue_wait_s_sum, 4),
                       queue_wait_s_max=round(self.queue_wait_s_max, 4),
                       dispatches_ready_at_collect=self.dispatches_ready_at_collect,
                       resolved_before_next_enqueue=self.resolved_before_next_enqueue)
        return out


class TrajectoryBatcher:
    """Drop-in for ``MicroBatcher(pipeline.generate, ...)``: same
    ``submit(request) → Future`` / ``stats`` / ``close()`` surface, but
    scheduling (request, replica) rows into fixed-shape whole-trajectory
    dispatches, each collected on a thread of its own."""

    def __init__(self, pipeline, *, max_wait_s: float = 0.02,
                 name: str = "generate-trajectory"):
        self.pipeline = pipeline
        self._row_fn = pipeline.s3.make_trajectory_row_fn(pipeline._mesh)
        self.accepts_masked = self._row_fn.accepts_masked
        self._vocab = pipeline.s3.vocab
        self._device = pipeline.s3.device
        self.R = pipeline.rows_per_dispatch
        self.L = pipeline.s3.config.max_seq_len
        self.max_wait_s = max_wait_s
        self._host_rng = host_rng(getattr(pipeline, "seed", 0))
        self._pending: deque[dict] = deque()
        self._cv = threading.Condition()
        # unresolved submitted groups (close()'s drain signal)
        self._outstanding = 0
        self._closed = False
        self._closing = False
        # rows taken off _pending whose dispatch is being enqueued, and the
        # dispatches enqueued and not yet collected, oldest first (rows, host
        # ids, event, t_enqueue, did; the head stays until its collect ends);
        # both changed under _cv only
        self._dispatching: list | None = None
        self._flights: deque[tuple] = deque()
        # did of the newest dispatch whose enqueue returned
        self._last_enqueued = -1
        self.stats = TrajectoryStats()
        self._rids = itertools.count()
        self._dids = itertools.count()
        # EMA of dispatch wall-clock: the free coalescing budget while a
        # dispatch is in flight
        self._ema_dispatch_s = 0.0
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._collector = threading.Thread(target=self._collect_loop, name=f"{name}-collect",
                                           daemon=True)
        self._thread.start()
        self._collector.start()

    # -- client surface ------------------------------------------------

    def submit(self, request: dict) -> Future:
        """Queue one request; one carrying ``masked_ids`` (decode-table ids,
        0 at the positions to fill) becomes inpaint rows, under MaskGIT only."""
        fut: Future = Future()
        n_rep = int(request.get("num_replicas") or self.pipeline.default_replicas)
        mids = request.get("masked_ids")
        if mids is not None:
            if not self.accepts_masked:
                raise ValueError("this engine's trajectory scheduler cannot carry inpaint "
                                 "rows (ardm fast modes use a separate inpaint executable)")
            if not (np.asarray(mids) == 0).any():
                # nothing to fill: resolve without taking a row
                with self._cv:
                    if self._closed or self._closing:
                        raise RuntimeError("batcher is closed")
                    with self.stats._lock:
                        self.stats.requests += 1
                seq = self._vocab.clean_sequence(self._vocab.decode_ids(
                    np.asarray(mids, np.int32)))
                fut.set_result({"prompt": request["prompt"], "sequences": [seq] * n_rep})
                return fut
        group = {"request": request, "future": fut, "n_rep": n_rep, "next_rep": 0,
                 "remaining": n_rep, "z_c": None, "sequences": {}, "rid": next(self._rids),
                 "t_submit": time.monotonic(), "t_submit_ns": profiling.stamp()}
        with self._cv:
            if self._closed or self._closing:
                raise RuntimeError("batcher is closed")
            with self.stats._lock:
                self.stats.requests += 1
            self._pending.append(group)
            self._outstanding += 1
            self._cv.notify_all()
        return fut

    def warmup(self) -> float:
        """One padded dummy dispatch (stats untouched); returns wall-clock
        seconds."""
        t0 = time.time()
        C = self.pipeline.s3.config.cond_dim
        inv = np.tile(np.arange(self.L, dtype=np.int32), (self.R, 1))
        kd = np.zeros((self.R, KEY_WORDS), np.uint32)
        with torch.inference_mode():
            with self.pipeline._device_lock:
                ids = self._row_fn(np.zeros((self.R, C), np.float32), inv, kd)
            ids.cpu()
        return round(time.time() - t0, 1)

    def close(self, timeout: float = 30.0, drain_s: float = 120.0) -> None:
        """Draining shutdown: refuse new submissions, let queued and
        in-flight rows finish through the collector (bounded by
        ``drain_s``), then stop both threads and fail any stragglers —
        queued, being enqueued, in flight or being collected."""
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        deadline = time.monotonic() + drain_s
        while time.monotonic() < deadline:
            with self._cv:
                if self._outstanding == 0:
                    break
            time.sleep(0.05)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        end = time.monotonic() + timeout
        for thread in (self._thread, self._collector):
            thread.join(timeout=max(end - time.monotonic(), 0.0))
        self._fail_groups(None, RuntimeError("batcher is closed"), count_errors=False)

    # -- scheduler -----------------------------------------------------

    def _loop(self) -> None:
        with torch.inference_mode():
            while True:
                with self._cv:
                    # woken by submit, and by the collector as it finishes
                    while not self._closed and not self._pending:
                        if self._flights:
                            self._cv.wait(timeout=0.1)
                        else:
                            with profiling.span("serve.idle"):
                                self._cv.wait(timeout=0.1)
                    if self._closed:
                        return
                try:
                    # taken before the embed, whose device synchronise can
                    # let the collector finish the dispatch first
                    with self._cv:
                        in_flight = bool(self._flights)
                    self._embed_pending()
                    self._dispatch_next(in_flight)
                except Exception as exc:  # noqa: BLE001 — fail fast: an
                    # unexpected scheduler error must reach the waiting
                    # clients, not strand their futures until the timeout
                    self._fail_groups(None, exc)

    def _embed_pending(self) -> None:
        """One padded embed call for every queued group still lacking z_c;
        a failure fails ONLY the groups whose embed it was."""
        with self._cv:
            need = [g for g in self._pending if g["z_c"] is None][: self.R]
        if not need:
            return
        try:
            with profiling.span("serve.embed", rid=[g["rid"] for g in need]):
                _, z_c = self.pipeline.embed([g["request"]["prompt"] for g in need])
        except Exception as exc:  # noqa: BLE001 — forwarded per group
            self._fail_groups(need, exc)
            return
        for i, g in enumerate(need):
            g["z_c"] = z_c[i]

    def _ready_rows(self) -> list:
        """(group, replica) rows dispatchable right now, FIFO, stopping at
        the first group still awaiting its embed."""
        rows = []
        for g in self._pending:
            if g["z_c"] is None:
                break
            for rep in range(g["next_rep"], g["n_rep"]):
                rows.append((g, rep))
                if len(rows) >= self.R:
                    return rows
        return rows

    def _dispatch_next(self, in_flight: bool) -> None:
        """Build and enqueue at most one dispatch.  Waits (adaptively) for
        stragglers only while the batch is partial AND the wait costs
        nothing: ``in_flight``, a dispatch was enqueued and not yet
        collected when this round began."""
        with self._cv:
            rows = self._ready_rows()
        if not rows:
            return
        if len(rows) < self.R:
            window = self.max_wait_s
            if in_flight:
                window = max(window, 2.0 * self._ema_dispatch_s)
            deadline = time.monotonic() + min(window, 1.0)
            with profiling.span("serve.coalesce", rows_start=len(rows)) as coalesce:
                while time.monotonic() < deadline:
                    with self._cv:
                        rows = self._ready_rows()
                        if len(rows) >= self.R or self._closing:
                            break
                        need_embed = any(g["z_c"] is None for g in self._pending)
                        if not need_embed:
                            self._cv.wait(timeout=min(0.005, max(deadline - time.monotonic(),
                                                                 0.001)))
                    if need_embed:
                        self._embed_pending()
                with self._cv:
                    rows = self._ready_rows()
                coalesce.note(rows_end=len(rows))
            if not rows:
                return
        self._dispatch(rows[: self.R])

    def _dispatch(self, rows) -> None:
        """Enqueue one fixed-shape dispatch for ``rows`` (padded by repeating
        the last row) and hand it to the collector thread."""
        zc = np.empty((self.R, len(rows[0][0]["z_c"])), np.float32)
        inv = np.empty((self.R, self.L), np.int32)
        kd = np.empty((self.R, KEY_WORDS), np.uint32)
        streams = [row_streams(self._host_rng, g["request"].get("seed"), rep, self.L)
                   for g, rep in rows]
        # inpaint rows' partial sequences; generate rows resume from zeros
        inpaint = any(g["request"].get("masked_ids") is not None for g, _ in rows)
        masked = np.zeros((self.R, self.L), np.int32) if inpaint else None
        for i in range(self.R):
            j = min(i, len(rows) - 1)
            zc[i] = rows[j][0]["z_c"]
            inv[i], kd[i] = streams[j]
            mids = rows[j][0]["request"].get("masked_ids")
            if mids is not None:
                masked[i] = mids
        last = []       # the groups whose last row rides this dispatch
        with self._cv:
            for g, rep in rows:
                g["next_rep"] = max(g["next_rep"], rep + 1)
                if g["next_rep"] >= g["n_rep"] and g in self._pending:
                    self._pending.remove(g)
                    last.append(g)
            self._dispatching = rows
        did = next(self._dids)
        t0, t0_ns = time.monotonic(), profiling.stamp()
        for g in last:
            self.stats.record_queue_wait(t0 - g["t_submit"])
            profiling.record("serve.queue", g["t_submit_ns"], t0_ns, rid=g["rid"], did=did)
        try:
            with profiling.span("serve.dispatch", did=did, rows=len(rows),
                                rid=sorted({g["rid"] for g, _ in rows})):
                with self.pipeline._device_lock:
                    ids_dev = self._row_fn(zc, inv, kd, masked)
                    host, event = self._to_host(ids_dev)
        except Exception as exc:  # noqa: BLE001 — this dispatch's rows
            with self._cv:
                self._dispatching = None
            self._fail_groups([g for g, _ in rows], exc)
            return
        self.pipeline._record_dispatch(len(rows))
        with self._cv:
            self._flights.append((rows, host, event, t0, did))
            self._last_enqueued = did
            self._dispatching = None
            self._cv.notify_all()

    def _to_host(self, ids: torch.Tensor):
        """Start the copy of a dispatch's ids to host memory without waiting
        for it → (host tensor, event to wait on, or None on the CPU)."""
        if self._device.type != "cuda":
            return ids, None
        host = torch.empty(ids.shape, dtype=ids.dtype, pin_memory=True)
        host.copy_(ids, non_blocking=True)
        # blocking: the collector sleeps in synchronize() instead of
        # spinning beside the launching thread
        event = torch.cuda.Event(blocking=True)
        event.record()
        return host, event

    def _collect_loop(self) -> None:
        """The collector thread: collect each enqueued dispatch in order."""
        with torch.inference_mode():
            while True:
                with self._cv:
                    while not self._closed and not self._flights:
                        self._cv.wait(timeout=0.1)
                    if self._closed:
                        return
                    flight = self._flights[0]
                try:
                    self._collect(flight)
                except Exception as exc:  # noqa: BLE001 — this dispatch's rows
                    self._fail_groups([g for g, _ in flight[0]], exc)
                with self._cv:
                    # a close() or escalation sweep may have taken it already
                    if self._flights and self._flights[0] is flight:
                        self._flights.popleft()
                    self._cv.notify_all()

    def _collect(self, flight) -> None:
        """Fetch + decode one dispatch's results and resolve finished
        groups."""
        rows, host, event, t0, did = flight
        ready = event is None or event.query()
        if ready:
            self.stats.record_ready()
        with profiling.span("serve.collect", did=did, ready=ready):
            if event is not None:
                event.synchronize()
            ids = host.numpy()
            wall = time.monotonic() - t0
            if wall < 10.0:
                # pacing EMA; first-use builds and loads are excluded
                self._ema_dispatch_s = (wall if self._ema_dispatch_s == 0.0
                                        else 0.7 * self._ema_dispatch_s + 0.3 * wall)
            self.stats.record(len(rows), wall, False)
            for i, (g, rep) in enumerate(rows):
                seq = self._vocab.clean_sequence(self._vocab.decode_ids(ids[i]))
                with self._cv:
                    g["sequences"][rep] = seq
                    g["remaining"] -= 1
                    done = g["remaining"] == 0 and not g.get("settled")
                    if done:
                        g["settled"] = True
                        self._outstanding -= 1
                if done and not g["future"].done():
                    g["future"].set_result({
                        "prompt": g["request"]["prompt"],
                        "sequences": [g["sequences"][r] for r in range(g["n_rep"])],
                    })
                    profiling.record("serve.request", g["t_submit_ns"], rid=g["rid"])
        with self._cv:
            alone = self._last_enqueued == did
        if alone:
            self.stats.record_resolved_before_next_enqueue()

    def _fail_groups(self, groups, exc: BaseException, *, count_errors: bool = True) -> None:
        """Fail ``groups`` (or, with ``groups=None``, every queued, enqueuing,
        in-flight and being-collected group — the escalation / close-sweep
        path)."""
        with self._cv:
            if groups is None:
                found = {id(g): g for g in self._pending}
                for part in (self._dispatching, *(f[0] for f in self._flights)):
                    for g, _rep in part or ():
                        found[id(g)] = g
                self._dispatching = None
                self._flights.clear()
                self._pending.clear()
                groups = list(found.values())
            else:
                seen = set()
                groups = [g for g in groups if not (id(g) in seen or seen.add(id(g)))]
                for g in groups:
                    try:
                        self._pending.remove(g)
                    except ValueError:
                        pass
            unsettled = [g for g in groups if not g.get("settled")]
            for g in unsettled:
                g["settled"] = True
            self._outstanding -= len(unsettled)
        if count_errors and unsettled:
            with self.stats._lock:
                self.stats.errors += len(unsettled)
        for g in unsettled:
            if not g["future"].done():
                g["future"].set_exception(exc)

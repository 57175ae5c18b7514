"""Chunk-boundary continuous batching for exact-mode generation.

Port of ``biom3_tpu/serving/continuous.py``.  The device half
(``diffusion.sampler.make_chunk_stepper``) advances each row from its OWN
step offset, so rows at different trajectory phases share one fixed-shape
dispatch; this scheduler admits queued (request, replica) rows into free
slots and retires finished ones at EVERY chunk boundary, instead of only at
trajectory start.  Under saturation every slot is live every chunk, so row
occupancy approaches 1.

Per-row streams: each row's decode order and its two noise-key words come
from ``row_streams`` — verbatim the JAX scheduler's numpy code (a Philox
stream keyed on (seed, replica) for seeded requests, one host generator
seeded from the server's seed otherwise) — so the decode orders equal the
JAX package's, and the key words seed the port's counter-based noise
(``diffusion.sampler.row_gumbel``): a seeded request reproduces bit for bit
in ANY batch mix.

Host/device split: the carries (``x``, the rows' key words) stay on the
device between chunks; ``x`` is fetched only on retiring chunks.  The host
runs one chunk ahead of the device: after enqueueing a chunk it waits on
the previous chunk's event, so admissions see the queue at most one
boundary late.  Admissions upload only the small per-row arrays.  Only
this scheduler's thread (and ``warmup``) touches the device, under the
pipeline's ``_device_lock``; it runs in ``torch.inference_mode``, which is
thread-local, so it is set inside the thread.

Inpaint rows (a request carrying ``masked_ids``): each row enters with its
partial sequence as the stepper's ``x_new`` and starts at ``t0 = num_steps −
n_masked``, its masked positions on the ``inv`` slots it will visit in its
own random order (``_prepare_row``) — the reference's resume-from-corruption
semantics as rows that share chunk dispatches with generate traffic.  A
request with nothing to fill resolves at once without taking a slot.

On a mesh (``ServingPipeline(mesh=...)``) the stepper's forward runs over
the mesh's (dp, fsdp) positions (JAX :66-70); the carries and row arrays
stay on the first position's device, the engine's.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from concurrent.futures import Future

import numpy as np
import torch

from biom3_tpu_torch.serving.batcher import BatcherStats

KEY_WORDS = 2   # 32-bit key words per row (the JAX scheduler's threefry key width)


def row_streams(rng_or_none, seed, rep: int, length: int, kw: int = KEY_WORDS):
    """Per-row decode order + raw RNG key words.

    Seeded: a Philox stream keyed on (seed, replica) — deterministic
    under any batch composition or admission timing.  Unseeded: the
    shared host generator ``rng_or_none`` (deterministic for a fixed
    request arrival order; the "seed" field is the knob for request-pinned
    reproducibility).
    """
    if seed is None:
        rng = rng_or_none
    else:
        # Philox key is 2x64-bit: word 0 = user seed, word 1 = replica
        # index tagged so (seed, rep) pairs never collide with plain
        # seeds
        rng = np.random.Generator(np.random.Philox(
            key=np.array(
                [seed, (rep << 32) | 0x42494F4D], np.uint64
            )
        ))
    inv = rng.permutation(length).astype(np.int32)
    kd = rng.integers(
        0, 2**32, size=kw, dtype=np.uint64
    ).astype(np.uint32)
    return inv, kd


def host_rng(seed: int) -> np.random.Generator:
    """The unseeded rows' shared generator, seeded from the server's seed
    (the JAX scheduler's ``[seed, 0xC017]``)."""
    return np.random.default_rng([seed, 0xC017])


_NUMPY = {torch.float32: np.float32, torch.int64: np.int64, torch.int32: np.int32,
          torch.bool: np.bool_}


def to_device(a, dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """numpy → device tensor; on the card through pinned memory without a
    wait, so an upload does not stall behind the dispatch in flight."""
    t = torch.from_numpy(np.ascontiguousarray(np.asarray(a).astype(_NUMPY[dtype])))
    return t.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else t


def device_event(device: torch.device):
    """An event recorded on the current stream (None on the CPU, where
    every call has finished when it returns)."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event()
    ev.record()
    return ev


class ContinuousGenerateBatcher:
    """Drop-in for ``MicroBatcher(pipeline.generate, ...)``: same
    ``submit(request) → Future`` / ``stats`` / ``close()`` surface, but
    scheduling (request, replica) rows onto persistent device slots at
    chunk boundaries.

    ``submit`` takes the request dicts the HTTP handler builds (``{"prompt",
    "num_replicas", "seed"}``) and resolves the future with the same
    ``{"prompt", "sequences"}`` payload as ``ServingPipeline.generate``.
    """

    def __init__(self, pipeline, *, name: str = "generate-continuous"):
        self.pipeline = pipeline
        eng = pipeline.s3
        self._chunk_fn, meta = eng.make_continuous_stepper(pipeline._mesh)
        self._num_steps = meta["num_steps"]
        self._step_incr = meta["chunk_steps"] * meta["positions_per_step"]
        self.chunk_steps = meta["chunk_steps"]
        self._vocab = eng.vocab
        self._device = eng.device
        R = pipeline.rows_per_dispatch
        L = eng.config.max_seq_len
        C = eng.config.cond_dim
        self.R, self.L = R, L
        self._zc = np.zeros((R, C), np.float32)
        self._inv = np.zeros((R, L), np.int32)
        self._t0 = np.full((R,), self._num_steps, np.int32)  # all inert
        # per-slot admission state, read by the stepper only where
        # ``fresh`` is set — the live x/key state is the device carry
        self._kd_new = np.zeros((R, KEY_WORDS), np.uint32)
        self._xnew = np.zeros((R, L), np.int32)   # inpaint rows' partial sequences
        self._fresh = np.zeros((R,), bool)
        self._x_dev = None    # device-resident decoding state
        self._kd_dev = None   # device-resident per-row key words
        self._prev_event = None   # the previous chunk's end on the stream
        self._slots: list[tuple[dict, int] | None] = [None] * R
        self._host_rng = host_rng(getattr(pipeline, "seed", 0))
        self._pending: deque[dict] = deque()
        self._cv = threading.Condition()
        # serializes scheduler iterations against warmup() from other threads
        self._sched_lock = threading.Lock()
        self._closed = False
        self._closing = False  # drain phase: no new submissions
        self.stats = BatcherStats()
        self._thread = threading.Thread(target=self._loop, name=name, daemon=True)
        self._thread.start()

    # -- client surface ------------------------------------------------

    def submit(self, request: dict) -> Future:
        """Queue one request.  A request carrying ``masked_ids`` (decode-table
        ids, 0 at the positions to fill: the HTTP inpaint payload) becomes
        exact-mode inpaint rows (``_prepare_row``)."""
        n_rep = int(request.get("num_replicas") or self.pipeline.default_replicas)
        fut: Future = Future()
        mids = request.get("masked_ids")
        if mids is not None and not (np.asarray(mids) == 0).any():
            # nothing to fill: resolve without taking a slot
            with self._cv:
                if self._closed or self._closing:
                    raise RuntimeError("batcher is closed")
                with self.stats._lock:
                    self.stats.requests += 1
            seq = self._vocab.clean_sequence(self._vocab.decode_ids(np.asarray(mids, np.int32)))
            fut.set_result({"prompt": request["prompt"], "sequences": [seq] * n_rep})
            return fut
        group = {"request": request, "future": fut, "n_rep": n_rep, "next_rep": 0,
                 "remaining": n_rep, "z_c": None, "sequences": {}}
        with self._cv:
            if self._closed or self._closing:
                raise RuntimeError("batcher is closed")
            with self.stats._lock:
                self.stats.requests += 1
            self._pending.append(group)
            self._cv.notify_all()
        return fut

    def warmup(self) -> float:
        """One all-inert dispatch (no live rows, stats untouched): the first
        client then finds every kernel loaded; returns wall-clock seconds."""
        t0 = time.time()
        with self._sched_lock, torch.inference_mode():
            self._dispatch_chunk(record=False)
            self._wait_previous()
        return round(time.time() - t0, 1)

    def close(self, timeout: float = 30.0, drain_s: float = 120.0) -> None:
        """Draining shutdown: refuse new submissions, let the scheduler
        finish the queued and mid-flight trajectories (bounded by
        ``drain_s``), then stop the thread and fail whatever did not drain
        in time.  ``drain_s=0`` is an immediate shutdown."""
        with self._cv:
            self._closing = True
            self._cv.notify_all()
        deadline = time.monotonic() + drain_s
        while time.monotonic() < deadline:
            with self._cv:
                if not self._pending and not self._live_any():
                    break
            time.sleep(0.05)
        with self._cv:
            self._closed = True
            self._cv.notify_all()
        self._thread.join(timeout=timeout)
        self._fail_all(RuntimeError("batcher is closed"), count_error=False)

    # -- scheduler -----------------------------------------------------

    def _live_any(self) -> bool:
        return any(s is not None for s in self._slots)

    def _loop(self) -> None:
        with torch.inference_mode():
            while True:
                with self._cv:
                    while (not self._closed and not self._pending
                           and not self._live_any()):
                        self._cv.wait(timeout=0.1)
                    if self._closed:
                        return
                # _admit handles a failed embed per group; any other
                # escape — a dispatch or retire failure, where the device
                # carries themselves are suspect — fails every request
                # now instead of stranding the futures until the timeout
                with self._sched_lock:
                    try:
                        self._admit()
                        if self._live_any():
                            self._dispatch_chunk()
                            self._retire()
                    except Exception as exc:  # noqa: BLE001 — to callers
                        self._fail_all(exc)

    def _row_streams(self, seed, rep: int):
        return row_streams(self._host_rng, seed, rep, self.L)

    def _admit(self) -> None:
        with self._cv:
            free = [s for s in range(self.R) if self._slots[s] is None]
            if not free or not self._pending:
                return
            need = [g for g in self._pending if g["z_c"] is None][: self.R]
        if need:
            # one padded embed call for every prompt still lacking z_c; a
            # failure fails ONLY these groups, never the mid-flight rows
            try:
                _, z_c = self.pipeline.embed([g["request"]["prompt"] for g in need])
            except Exception as exc:  # noqa: BLE001 — forwarded
                with self._cv:
                    for g in need:
                        try:
                            self._pending.remove(g)
                        except ValueError:
                            pass
                        if not g["future"].done():
                            g["future"].set_exception(exc)
                with self.stats._lock:
                    self.stats.errors += len(need)
                return
            for g, z in zip(need, z_c):
                g["z_c"] = np.asarray(z, np.float32)
        with self._cv:
            for s in free:
                if not self._pending:
                    break
                g = self._pending[0]
                if g["z_c"] is None:
                    break  # > R groups arrived at once; embed next round
                rep = g["next_rep"]
                inv, kd, t_start, x_new = self._prepare_row(g, rep)
                self._slots[s] = (g, rep)
                self._zc[s] = g["z_c"]
                self._inv[s] = inv
                self._kd_new[s] = kd
                self._xnew[s] = x_new
                self._fresh[s] = True
                self._t0[s] = t_start
                g["next_rep"] += 1
                if g["next_rep"] >= g["n_rep"]:
                    self._pending.popleft()

    def _prepare_row(self, g: dict, rep: int):
        """Row streams and, for an inpaint row, the ``inv`` layout and start
        offset (JAX ``_prepare_row``): the masked positions take the slots
        the row will visit, [t_start, t_start + m), in the row's own random
        order; the committed positions fill the rest."""
        inv, kd = self._row_streams(g["request"].get("seed"), rep)
        mids = g["request"].get("masked_ids")
        t_start, x_new = 0, 0
        if mids is not None:
            x_new = np.asarray(mids, np.int32)
            masked_pos = np.flatnonzero(x_new == 0).astype(np.int32)
            committed = np.flatnonzero(x_new != 0).astype(np.int32)
            t_start = max(0, self._num_steps - len(masked_pos))
            order = np.argsort(inv[masked_pos], kind="stable")
            fill = np.concatenate([masked_pos[order], committed])
            inv = np.empty_like(inv)
            k = len(masked_pos)
            inv[t_start:t_start + k] = fill[:k]
            inv[:t_start] = fill[k:k + t_start]
            inv[t_start + k:] = fill[k + t_start:]
        return inv, kd, t_start, x_new

    def _wait_previous(self) -> None:
        ev, self._prev_event = self._prev_event, None
        if ev is not None:
            ev.synchronize()

    def _dispatch_chunk(self, record: bool = True) -> None:
        """One chunk dispatch, depth-1 pipelined: the carries stay on the
        device, the host arrays ride as arguments, and after enqueueing
        this chunk the host waits for the PREVIOUS one only."""
        dev = self._device
        live = int((self._t0 < self._num_steps).sum())
        x_in, kd_in = self._x_dev, self._kd_dev
        if x_in is None:
            x_in = torch.zeros((self.R, self.L), dtype=torch.int32, device=dev)
            kd_in = torch.zeros((self.R, KEY_WORDS), dtype=torch.int64, device=dev)
        args = (to_device(self._zc, torch.float32, dev), to_device(self._inv, torch.int64, dev),
                x_in, to_device(self._t0, torch.int64, dev), kd_in,
                to_device(self._kd_new, torch.int64, dev), to_device(self._fresh, torch.bool, dev),
                to_device(self._xnew, torch.int32, dev))
        t_start = time.monotonic()
        with self.pipeline._device_lock:
            self._x_dev, self._kd_dev = self._chunk_fn(*args)
            event = device_event(dev)
        self._fresh = np.zeros_like(self._fresh)  # injected; don't re-reset
        self._t0 = np.minimum(self._t0 + self._step_incr, self._num_steps).astype(np.int32)
        self._wait_previous()   # depth-1 barrier: the chunk before this one
        self._prev_event = event
        if record:
            self.pipeline._record_dispatch(live)
            self.stats.record(live, time.monotonic() - t_start, False)

    def _retire(self) -> None:
        finished = [s for s in range(self.R)
                    if self._slots[s] is not None and self._t0[s] >= self._num_steps]
        if not finished:
            return
        # the one synchronization point: fetch the decoding state for the
        # rows that just completed their trajectories
        x_host = self._x_dev.cpu().numpy()
        self._prev_event = None
        for s in finished:
            group, rep = self._slots[s]
            self._slots[s] = None
            seq = self._vocab.clean_sequence(self._vocab.decode_ids(x_host[s]))
            with self._cv:
                group["sequences"][rep] = seq
                group["remaining"] -= 1
                done = group["remaining"] == 0
            if done and not group["future"].done():
                group["future"].set_result({
                    "prompt": group["request"]["prompt"],
                    "sequences": [group["sequences"][i] for i in range(group["n_rep"])],
                })

    def _fail_all(self, exc: BaseException, *, count_error: bool = True) -> None:
        """Fail every queued and mid-flight request and drop the device
        carries — the dispatch/retire escalation path and close()'s final
        sweep."""
        with self._cv:
            groups = {id(g): g for g in self._pending}
            for slot in self._slots:
                if slot is not None:
                    groups[id(slot[0])] = slot[0]
            self._pending.clear()
            self._slots = [None] * self.R
            self._t0[:] = self._num_steps
            self._x_dev = self._kd_dev = self._prev_event = None
        if count_error:
            with self.stats._lock:
                self.stats.errors += 1
        for g in groups.values():
            if not g["future"].done():
                g["future"].set_exception(exc)

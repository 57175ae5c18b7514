"""Text→protein serving: the three-stage pipeline behind an HTTP API.

Port of ``biom3_tpu/serving/server.py``: one process keeps the three stage
engines on the card and serves concurrent requests.

  * **Fixed device shapes.** Stage 3 dominates; its device batch is pinned
    to ``rows_per_dispatch`` (prompt × replica rows, padded by repetition).
    Stage-1/2 embed calls pad the prompt list the same way.
  * **Device calls are serialized**: HTTP handler threads only enqueue and
    wait on futures; the dispatcher threads (generate, embed) take the
    pipeline's ``_device_lock`` around every device call.
  * **Row-level packing**: rows of different prompts share one Stage-3
    dispatch, each with its own z_c, decode order and noise stream; row
    occupancy shows in ``/v1/metrics``.
  * **A device mesh** (``mesh=``, ``parallel/mesh.py``; JAX :69-95): each
    Stage-3 dispatch's rows split over the mesh's (dp, fsdp) positions —
    generate rows through the engine's row function on the mesh, inpaint
    rows through its sharded inpainter, built on first use — so
    ``rows_per_dispatch`` must be a multiple of dp·fsdp.  Stages 1 and 2
    stay on the engines' device.

Endpoints (stdlib ``http.server``; JSON in/out):
  * ``POST /v1/generate`` ``{"prompt": str | "prompts": [str],
    "num_replicas": int?, "seed": int?}`` → designed sequences per prompt;
  * ``POST /v1/embed`` ``{"prompt" | "prompts"}`` → z_t and z_c rows;
  * ``POST /v1/profile`` ``{"seconds": float?, "log_dir": str?}`` →
    a ``torch.profiler`` window over the daemon's work, written as a
    Chrome trace with the scheduler threads' spans;
  * ``POST /v1/inpaint`` ``{"prompt": str, "sequence": str,
    "num_replicas": int?, "seed": int?, "unknown": str?}`` → the sequence
    with every ``unknown`` character (default ``"?"``) filled, conditioned
    on the prompt; the committed residues and the length are kept;
  * ``GET /healthz`` → liveness and the device platform (``gpu`` on the
    card);
  * ``GET /v1/metrics`` → scheduler counters (occupancy, latency, errors;
    the trajectory scheduler's queue wait),
    the embed cache, device rows and memory.
"""

from __future__ import annotations

import json
import resource
import threading
import time
from collections import OrderedDict
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from biom3_tpu_torch.serving.batcher import MicroBatcher
from biom3_tpu_torch.serving.continuous import host_rng, row_streams
from biom3_tpu_torch.utils import profiling


class ServingPipeline:
    """Wraps the three stage engines with fixed-shape batched entry points."""

    def __init__(self, stage1_engine, stage2_engine, stage3_engine, *,
                 rows_per_dispatch: int = 16, default_replicas: int = 2,
                 max_replicas: int = 64, seed: int = 0, embed_cache: int = 4096, mesh=None):
        if mesh is not None and rows_per_dispatch % mesh.batch_shards:
            raise ValueError(f"rows_per_dispatch={rows_per_dispatch} must be a multiple of "
                             f"the mesh's dp*fsdp={mesh.batch_shards}")
        self.s1, self.s2, self.s3 = stage1_engine, stage2_engine, stage3_engine
        self._mesh = mesh
        self.device = stage3_engine.device
        self.rows_per_dispatch = rows_per_dispatch
        self.default_replicas = default_replicas
        self.max_replicas = max_replicas
        self.seed = seed
        # the packed path's unseeded rows draw their streams from here
        self._host_rng = host_rng(seed)
        self._rng_lock = threading.Lock()
        # the packed paths' trajectory dispatch and inpainter, built on first use
        self._row_fn = None
        self._inpaint_fn = None
        # device-level packing counters: ROWS per fixed-shape dispatch
        self._dev_lock = threading.Lock()
        self._dispatches = 0
        self._rows_live = 0
        self._rows_padded = 0
        # serializes device calls across the dispatcher threads; held per
        # device call, not across a whole request
        self._device_lock = threading.Lock()
        # prompt → (z_t row, z_c row) LRU: a hit skips the BERT tower and
        # the Facilitator; embed_cache=0 disables it
        self._embed_cache_cap = int(embed_cache)
        self._embed_cache: OrderedDict[str, tuple] = OrderedDict()
        self._cache_lock = threading.Lock()
        self._cache_hits = 0
        self._cache_misses = 0

    def _record_dispatch(self, live_rows: int) -> None:
        """Account one fixed-shape device dispatch carrying ``live_rows``
        useful rows (every scheduler reports here)."""
        with self._dev_lock:
            self._dispatches += 1
            self._rows_live += live_rows
            self._rows_padded += self.rows_per_dispatch - live_rows

    def embed(self, prompts: list[str]) -> tuple[np.ndarray, np.ndarray]:
        """prompts → (z_t, z_c); prompts seen before (across requests or
        earlier in this batch) come from the LRU cache, the rest run once
        each, padded to a fixed device batch.  Cached rows are the values
        the towers produced, so results are identical with or without the
        cache.  A miss counts once per prompt computed; every other
        occurrence — a cached prompt, or a prompt repeated within the batch
        — counts as a hit (each is a tower row not computed)."""
        if not prompts:
            raise ValueError("embed() needs at least one prompt")
        rows: dict[str, tuple] = {}
        if self._embed_cache_cap:
            with self._cache_lock:
                for p in set(prompts):
                    hit = self._embed_cache.get(p)
                    if hit is not None:
                        self._embed_cache.move_to_end(p)
                        rows[p] = hit
        misses = [p for p in dict.fromkeys(prompts) if p not in rows]
        if self._embed_cache_cap:
            with self._cache_lock:
                self._cache_misses += len(misses)
                self._cache_hits += len(prompts) - len(misses)
        if misses:
            padded = misses + [misses[-1]] * (-len(misses) % self.rows_per_dispatch)
            with self._device_lock:
                z_t = self.s1.embed_text(padded, batch_size=self.rows_per_dispatch)
                z_c = np.asarray(self.s2(z_t))
            z_t = np.asarray(z_t)
            for i, p in enumerate(misses):
                rows[p] = (z_t[i], z_c[i])
            if self._embed_cache_cap:
                with self._cache_lock:
                    for p in misses:
                        self._embed_cache[p] = rows[p]
                        self._embed_cache.move_to_end(p)
                    while len(self._embed_cache) > self._embed_cache_cap:
                        self._embed_cache.popitem(last=False)
        return (np.stack([rows[p][0] for p in prompts]),
                np.stack([rows[p][1] for p in prompts]))

    def embed_cache_stats(self) -> dict:
        with self._cache_lock:
            return {"capacity": self._embed_cache_cap, "size": len(self._embed_cache),
                    "hits": self._cache_hits, "misses": self._cache_misses}

    def _run_rows_packed(self, requests: list[dict], row_fn, *,
                         record: bool = True) -> list[dict]:
        """Pack (request, replica) rows into fixed ``rows_per_dispatch``
        dispatches of ``row_fn(request indices, inv (R, L), key_data (R, 2))
        → (R, L) ids``; returns one ``{"prompt", "sequences"}`` per request.
        Each row carries its own decode order and noise stream
        (``row_streams``), so a seeded request reproduces in any batch.
        ``record=False`` (warmup) leaves the packing counters alone."""
        rows = [(i, k) for i, r in enumerate(requests)
                for k in range(int(r.get("num_replicas") or self.default_replicas))]
        with self._rng_lock:
            streams = [row_streams(self._host_rng, requests[i].get("seed"), k,
                                   self.s3.config.max_seq_len) for i, k in rows]
        sequences: dict[tuple[int, int], str] = {}
        R = self.rows_per_dispatch
        for start in range(0, len(rows), R):
            chunk = list(range(start, min(start + R, len(rows))))
            pad = chunk + [chunk[-1]] * (R - len(chunk))
            if record:
                self._record_dispatch(len(chunk))
            with self._device_lock:
                ids = row_fn([rows[j][0] for j in pad], np.stack([streams[j][0] for j in pad]),
                             np.stack([streams[j][1] for j in pad]))
            ids = ids.cpu().numpy() if isinstance(ids, torch.Tensor) else np.asarray(ids)
            for n, j in enumerate(chunk):
                sequences[rows[j]] = self.s3.vocab.clean_sequence(
                    self.s3.vocab.decode_ids(ids[n]))
        return [{"prompt": r["prompt"],
                 "sequences": [sequences[(i, k)] for k in
                               range(int(r.get("num_replicas") or self.default_replicas))]}
                for i, r in enumerate(requests)]

    def _generate_rows(self, z_c: np.ndarray):
        """The packed generate path's row function over ``z_c`` rows."""
        if self._row_fn is None:
            self._row_fn = self.s3.make_trajectory_row_fn(self._mesh)
        return lambda idx, inv, kd: self._row_fn(z_c[idx], inv, kd)

    def _inpaint_rows(self, masked: np.ndarray, z_c: np.ndarray):
        """The packed inpaint path's row function: the engine's inpainter
        (``inpaint_batch``, or its mesh twin) on each row's own noise
        stream."""
        if self._inpaint_fn is None:
            self._inpaint_fn = (self.s3.inpaint_batch if self._mesh is None
                                else self.s3.make_sharded_inpainter(self._mesh))
        return lambda idx, inv, kd: self._inpaint_fn(masked[idx], z_c[idx], key_data=kd)

    def generate(self, requests: list[dict]) -> list[dict]:
        """Batch entry point: each request is ``{"prompt": str,
        "num_replicas": int, "seed": int?}``; returns one dict per request."""
        with torch.inference_mode():
            _, z_c = self.embed([r["prompt"] for r in requests])
            return self._run_rows_packed(requests, self._generate_rows(z_c))

    def inpaint(self, requests: list[dict]) -> list[dict]:
        """Fill user-masked residues conditioned on the text prompt (JAX
        ``ServingPipeline.inpaint``).  Each request is ``{"prompt": str,
        "sequence": str, "num_replicas": int?, "seed": int?, "unknown":
        str?}``: the sequence fixes the design's length and committed
        residues, and every ``unknown`` character (default ``"?"``) is
        generated; the HTTP handler passes the encoded row as
        ``"masked_ids"``.  Rows pack as ``generate``'s do."""
        L = self.s3.config.max_seq_len
        with torch.inference_mode():
            _, z_c = self.embed([r["prompt"] for r in requests])
            masked = np.stack([
                np.asarray(r["masked_ids"], np.int32) if r.get("masked_ids") is not None
                else self.s3.vocab.encode_partial(r["sequence"], L, r.get("unknown") or "?")
                for r in requests])
            return self._run_rows_packed(requests, self._inpaint_rows(masked, z_c))

    def warmup(self, *, include_inpaint: bool = True, include_generate: bool = True) -> dict:
        """One padded dummy dispatch per device path before traffic (packing
        counters untouched): the first client then waits on no kernel build
        or load.  Returns wall-clock seconds per path.
        ``include_generate=False`` / ``include_inpaint=False`` skip the
        packed generate / inpaint path (a server whose scheduler warms its
        own dispatch, or carries the inpaint rows)."""
        times = {}
        warm = [{"prompt": "warmup prompt", "num_replicas": 1}]
        with torch.inference_mode():
            t0 = time.time()
            _, z_c = self.embed(["warmup prompt"])
            times["embed_s"] = round(time.time() - t0, 1)
            if include_generate:
                t0 = time.time()
                self._run_rows_packed(warm, self._generate_rows(z_c), record=False)
                times["generate_s"] = round(time.time() - t0, 1)
            if include_inpaint:
                masked = self.s3.vocab.encode_partial("?", self.s3.config.max_seq_len)[None]
                t0 = time.time()
                self._run_rows_packed(warm, self._inpaint_rows(masked, z_c), record=False)
                times["inpaint_s"] = round(time.time() - t0, 1)
        return times

    def device_stats(self) -> dict:
        with self._dev_lock:
            total = self._rows_live + self._rows_padded
            return {"dispatches": self._dispatches, "rows_live": self._rows_live,
                    "rows_padded": self._rows_padded,
                    "row_occupancy": round(self._rows_live / total, 3) if total else 0.0}

    def memory_stats(self) -> dict:
        """Device memory in MB (``torch.cuda.memory_stats``) and the host's
        peak resident set."""
        out = {"host_max_rss_mb": round(resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
                                        / 1024, 1)}
        if self.device.type == "cuda":
            ms = torch.cuda.memory_stats(self.device)
            out["device_mb"] = {
                "allocated": round(ms.get("allocated_bytes.all.current", 0) / 2**20, 1),
                "peak_allocated": round(ms.get("allocated_bytes.all.peak", 0) / 2**20, 1),
                "reserved": round(ms.get("reserved_bytes.all.current", 0) / 2**20, 1),
            }
        return out


class BioM3Server:
    """HTTP front end with continuous micro-batching over a ServingPipeline.

    ``continuous=None`` (auto) serves exact path-order ARDM on the
    chunk-boundary ``ContinuousGenerateBatcher`` and the fast modes (MaskGIT,
    confidence order), which the engine's ``supports_continuous_stepping``
    refuses, on the packed scheduler; ``False`` takes ``packed_scheduler``: the row-granular
    ``TrajectoryBatcher`` (``"trajectory"``, default) or the
    request-granular ``MicroBatcher`` (``"micro"``).

    Inpainting (JAX ``BioM3Server``): by default a ``MicroBatcher`` over
    ``pipeline.inpaint``, the packed confidence-order inpainter;
    ``continuous_inpaint=True`` routes inpaint rows through the continuous
    generate scheduler (path-order resume, sharing its chunk dispatches)
    and raises without it; under MaskGIT the trajectory scheduler carries
    them beside generate rows."""

    def __init__(self, pipeline: ServingPipeline, *, host: str = "127.0.0.1", port: int = 8000,
                 max_wait_s: float = 0.05, request_timeout_s: float = 600.0,
                 continuous: bool | None = None, continuous_inpaint: bool = False,
                 packed_scheduler: str = "trajectory"):
        if packed_scheduler not in ("trajectory", "micro"):
            raise ValueError(f"packed_scheduler must be 'trajectory' or 'micro', "
                             f"got {packed_scheduler!r}")
        self.pipeline = pipeline
        self.request_timeout_s = request_timeout_s
        self.packed_scheduler = packed_scheduler
        if continuous is None:
            continuous = pipeline.s3.supports_continuous_stepping()
        self.continuous = bool(continuous)
        if self.continuous:
            from biom3_tpu_torch.serving.continuous import ContinuousGenerateBatcher

            self._gen_batcher = ContinuousGenerateBatcher(pipeline)
        elif packed_scheduler == "trajectory":
            from biom3_tpu_torch.serving.trajectory import TrajectoryBatcher

            self._gen_batcher = TrajectoryBatcher(pipeline, max_wait_s=max_wait_s)
        else:
            self._gen_batcher = MicroBatcher(pipeline.generate,
                                             max_batch=pipeline.rows_per_dispatch,
                                             max_wait_s=max_wait_s, name="generate-batcher")
        self._embed_batcher = MicroBatcher(self._run_embed_batch,
                                           max_batch=pipeline.rows_per_dispatch,
                                           max_wait_s=max_wait_s, name="embed-batcher")
        if continuous_inpaint and not self.continuous:
            self._close_batchers()
            raise ValueError("continuous_inpaint requires the continuous generate scheduler "
                             "(exact path-order ARDM engine + continuous not disabled); this "
                             "engine/server combination would silently fall back to the "
                             "packed inpainter")
        self.continuous_inpaint = bool(continuous_inpaint)
        if self.continuous_inpaint or getattr(self._gen_batcher, "accepts_masked", False):
            # continuous rows, or MaskGIT trajectory rows resuming from x0
            self._inpaint_batcher = self._gen_batcher
        else:
            self._inpaint_batcher = MicroBatcher(pipeline.inpaint,
                                                 max_batch=pipeline.rows_per_dispatch,
                                                 max_wait_s=max_wait_s, name="inpaint-batcher")
        # torch.profiler is process-global: one window at a time
        self._profile_lock = threading.Lock()
        self.httpd = ThreadingHTTPServer((host, port), self._make_handler())
        self.host, self.port = self.httpd.server_address[:2]
        self._serve_thread: threading.Thread | None = None

    @property
    def generate_mode(self) -> str:
        return "continuous" if self.continuous else self.packed_scheduler

    @property
    def inpaint_mode(self) -> str:
        if self._inpaint_batcher is self._gen_batcher:
            return self.generate_mode
        return "packed"

    def _run_embed_batch(self, prompts: list[str]) -> list[dict]:
        with torch.inference_mode():
            z_t, z_c = self.pipeline.embed(prompts)
        return [{"z_t": z_t[i].tolist(), "z_c": z_c[i].tolist()} for i in range(len(prompts))]

    # -- lifecycle -----------------------------------------------------

    def warmup(self, *, include_inpaint: bool = True) -> dict:
        """One dummy dispatch of every device path this server will run (the
        embed, the scheduler's own dispatch where it has one, and the packed
        inpainter unless inpaint rows ride the generate scheduler)."""
        own = hasattr(self._gen_batcher, "warmup")
        merged = self._inpaint_batcher is self._gen_batcher
        times = self.pipeline.warmup(include_inpaint=include_inpaint and not merged,
                                     include_generate=not own)
        if own:
            times[f"generate_{self.generate_mode}_s"] = self._gen_batcher.warmup()
        return times

    def start(self) -> None:
        self._serve_thread = threading.Thread(target=self.httpd.serve_forever,
                                              name="biom3-http", daemon=True)
        self._serve_thread.start()

    def serve_forever(self) -> None:
        self.httpd.serve_forever()

    def _close_batchers(self) -> None:
        self._gen_batcher.close()
        self._embed_batcher.close()
        inpaint = getattr(self, "_inpaint_batcher", None)
        if inpaint is not None and inpaint is not self._gen_batcher:
            inpaint.close()

    def close(self) -> None:
        self.httpd.shutdown()
        self.httpd.server_close()
        self._close_batchers()
        if self._serve_thread is not None:
            self._serve_thread.join(timeout=10)

    def metrics(self) -> dict:
        merged = self._inpaint_batcher is self._gen_batcher
        return {
            "generate_mode": self.generate_mode,
            "inpaint_mode": self.inpaint_mode,
            "generate": self._gen_batcher.stats.as_dict(),
            # a merged batcher's one stats object counts both endpoints
            "inpaint": ({"merged_into_generate": True} if merged
                        else self._inpaint_batcher.stats.as_dict()),
            "embed": self._embed_batcher.stats.as_dict(),
            "embed_cache": self.pipeline.embed_cache_stats(),
            "device": self.pipeline.device_stats(),
            "memory": self.pipeline.memory_stats(),
        }

    def profile(self, seconds: float, log_dir: str | None) -> dict:
        """A ``torch.profiler`` window of ``seconds`` over the daemon's
        work, written as a Chrome trace under ``log_dir``: the card's
        operations, and the spans the scheduler threads kept in the window
        (``utils/profiling.profile_trace``)."""
        import os
        import tempfile

        log_dir = log_dir or tempfile.mkdtemp(prefix="biom3_profile_")
        with profiling.profile_trace(log_dir):
            time.sleep(seconds)
        return {"log_dir": log_dir, "trace": os.path.join(log_dir, "trace.json"),
                "seconds": float(seconds)}

    # -- HTTP plumbing ---------------------------------------------------

    def _make_handler(self):
        server = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt, *args):  # noqa: D102 — quiet under load
                pass

            def _reply(self, code: int, payload: dict) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 (http.server API)
                if self.path == "/healthz":
                    self._reply(200, {
                        "status": "ok",
                        "platform": "gpu" if server.pipeline.device.type == "cuda" else "cpu",
                        "rows_per_dispatch": server.pipeline.rows_per_dispatch,
                        "continuous": server.continuous,
                        "continuous_inpaint": server.continuous_inpaint,
                    })
                elif self.path == "/v1/metrics":
                    self._reply(200, server.metrics())
                else:
                    self._reply(404, {"error": f"no route {self.path}"})

            def _read_json(self) -> dict:
                length = int(self.headers.get("Content-Length", 0))
                return json.loads(self.rfile.read(length) or b"{}")

            def do_POST(self):  # noqa: N802
                try:
                    req = self._read_json()
                except json.JSONDecodeError as exc:
                    self._reply(400, {"error": f"bad json: {exc}"})
                    return
                if not isinstance(req, dict):
                    self._reply(400, {"error": "body must be a JSON object"})
                    return
                try:
                    if self.path == "/v1/generate":
                        self._generate(req)
                    elif self.path == "/v1/inpaint":
                        self._inpaint(req)
                    elif self.path == "/v1/embed":
                        self._embed(req)
                    elif self.path == "/v1/profile":
                        self._profile(req)
                    else:
                        self._reply(404, {"error": f"no route {self.path}"})
                except Exception as exc:  # noqa: BLE001 — HTTP boundary
                    self._reply(500, {"error": str(exc)})

            def _prompts(self, req: dict):
                prompts = req.get("prompts")
                if prompts is None and "prompt" in req:
                    prompts = [req["prompt"]]
                # a real list: a bare string would fan out per character
                if not isinstance(prompts, list) or not prompts or not all(
                        isinstance(p, str) and p.strip() for p in prompts):
                    self._reply(400, {"error": "prompts must be a non-empty list of non-empty "
                                               "strings (or one prompt)"})
                    return None
                return prompts

            def _rep_seed(self, req: dict):
                """Validate num_replicas and seed → (ok, n_rep, seed); on
                failure the 400 is sent."""
                n_rep, cap = req.get("num_replicas"), server.pipeline.max_replicas
                if n_rep is not None and (not isinstance(n_rep, int) or isinstance(n_rep, bool)
                                          or not 1 <= n_rep <= cap):
                    self._reply(400, {"error": f"num_replicas must be an int in [1, {cap}], "
                                               f"got {n_rep!r}"})
                    return False, None, None
                seed = req.get("seed")
                if seed is not None and (not isinstance(seed, int) or isinstance(seed, bool)
                                         or not 0 <= seed < 2**32):
                    self._reply(400, {"error": f"seed must be an int in [0, 2^32), got {seed!r}"})
                    return False, None, None
                return True, n_rep, seed

            def _generate(self, req: dict) -> None:
                prompts = self._prompts(req)
                if prompts is None:
                    return
                ok, n_rep, seed = self._rep_seed(req)
                if not ok:
                    return
                futures = [server._gen_batcher.submit(
                    {"prompt": p, "num_replicas": n_rep, "seed": seed}) for p in prompts]
                self._reply(200, {"results": [f.result(timeout=server.request_timeout_s)
                                              for f in futures]})

            def _inpaint(self, req: dict) -> None:
                prompt, sequence, unknown = req.get("prompt"), req.get("sequence"), req.get(
                    "unknown")
                if not isinstance(prompt, str) or not prompt.strip():
                    self._reply(400, {"error": "prompt must be a non-empty string"})
                    return
                if not isinstance(sequence, str) or not sequence:
                    self._reply(400, {"error": "sequence must be a non-empty string"})
                    return
                if unknown is not None and (not isinstance(unknown, str) or len(unknown) != 1):
                    self._reply(400, {"error": "unknown must be a single character"})
                    return
                ok, n_rep, seed = self._rep_seed(req)
                if not ok:
                    return
                # encode on the handler thread: a bad sequence answers 400 here
                # and never reaches a co-batched dispatch; the encoded row
                # rides the request
                s3 = server.pipeline.s3
                try:
                    masked_ids = s3.vocab.encode_partial(sequence, s3.config.max_seq_len,
                                                         unknown or "?")
                except ValueError as exc:
                    self._reply(400, {"error": str(exc)})
                    return
                fut = server._inpaint_batcher.submit({
                    "prompt": prompt, "sequence": sequence, "num_replicas": n_rep,
                    "seed": seed, "unknown": unknown or "?", "masked_ids": masked_ids})
                self._reply(200, {"results": [fut.result(timeout=server.request_timeout_s)]})

            def _embed(self, req: dict) -> None:
                prompts = self._prompts(req)
                if prompts is None:
                    return
                futures = [server._embed_batcher.submit(p) for p in prompts]
                self._reply(200, {"results": [f.result(timeout=server.request_timeout_s)
                                              for f in futures]})

            def _profile(self, req: dict) -> None:
                seconds = req.get("seconds", 5)
                if (not isinstance(seconds, (int, float)) or isinstance(seconds, bool)
                        or not 0 < seconds <= 60):
                    self._reply(400, {"error": "seconds must be a number in (0, 60]"})
                    return
                log_dir = req.get("log_dir")
                if log_dir is not None and not isinstance(log_dir, str):
                    self._reply(400, {"error": "log_dir must be a string"})
                    return
                if not server._profile_lock.acquire(blocking=False):
                    self._reply(409, {"error": "a profile capture is already running"})
                    return
                try:
                    out = server.profile(float(seconds), log_dir)
                finally:
                    server._profile_lock.release()
                self._reply(200, out)

        return Handler

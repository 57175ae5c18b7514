"""The port's serving slice (``biom3_tpu_torch.serving``, ``cli/run_server``)
on tiny engines on the CPU, mirroring ``tests/test_serving.py``,
``test_continuous.py`` and ``test_trajectory.py``.

Parity with the JAX package: both packages' engines serve the same weights
(the JAX engines' seeded init, exported to reference-layout ``.bin`` files
that the port loads), f32, temperature 0.  A seeded request's decode
orders come from the same numpy Philox streams in both schedulers, so the
sequences must be equal: through the continuous scheduler in exact mode,
and through the trajectory scheduler at k=8, where the JAX scheduler's
per-dispatch ``jax.random`` permutations are replaced by the port's
per-row orders (its RNG cannot be reproduced outside JAX).
"""

import json
import pathlib
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from biom3_tpu.config import load_json_config
from biom3_tpu.io.export import (
    facilitator_params_to_torch,
    pencl_params_to_torch,
    proteoscribe_params_to_torch,
)
from biom3_tpu.io.torch_load import save_torch_file
from biom3_tpu.tokenizers.synthetic import write_synthetic_wordpiece

REPO = pathlib.Path(__file__).resolve().parent.parent
PROMPT = "membrane transport protein"


@pytest.fixture(scope="module")
def stage_files(tmp_path_factory):
    """Tiny stage configs, the JAX engines (temperature 0), and .bin exports."""
    from biom3_tpu.pipeline.stage1 import PenCLEngine
    from biom3_tpu.pipeline.stage2 import FacilitatorEngine
    from biom3_tpu.pipeline.stage3 import ProteoScribeEngine

    root = tmp_path_factory.mktemp("serving")
    vocab = write_synthetic_wordpiece(root / "tok")
    cfgs = {
        1: {"protein_encoder_embedding": 16, "text_encoder_embedding": 32,
            "esm_num_layers": 1, "esm_attention_heads": 2, "bert_num_layers": 1,
            "bert_num_heads": 2, "bert_intermediate_size": 64, "bert_vocab_size": vocab,
            "bert_max_position_embeddings": 32, "proj_embedding_dim": 16,
            "text_max_length": 32, "text_model_path": str(root / "tok")},
        2: {"emb_dim": 16, "hid_dim": 32, "dropout": 0.0},
        3: {"diffusion_steps": 64, "num_classes": 29, "text_emb_dim": 16,
            "transformer_dim": 32, "transformer_heads": 4, "transformer_depth": 2,
            "transformer_blocks": 1, "transformer_local_heads": 2,
            "transformer_local_size": 16},
    }
    for n, cfg in cfgs.items():
        (root / f"s{n}.json").write_text(json.dumps(cfg))
    s1 = PenCLEngine(load_json_config(root / "s1.json"), text_only=True)
    s2 = FacilitatorEngine(load_json_config(root / "s2.json"))
    s3 = ProteoScribeEngine(load_json_config(root / "s3.json"), temperature=0.0)
    save_torch_file(pencl_params_to_torch(s1.params, s1.config), root / "s1.bin")
    save_torch_file(facilitator_params_to_torch(s2.params, s2.config), root / "s2.bin")
    save_torch_file(proteoscribe_params_to_torch(s3.params, s3.config), root / "s3.bin")
    flags = [f for n in (1, 2, 3) for f in (f"--stage{n}_json", str(root / f"s{n}.json"),
                                            f"--stage{n}_model", str(root / f"s{n}.bin"))]
    return root, (s1, s2, s3), flags


def _port_pipeline(root, rows=4, **s3_kwargs):
    from biom3_tpu_torch.config import load_json_config as load
    from biom3_tpu_torch.pipeline.stage1 import PenCLEngine
    from biom3_tpu_torch.pipeline.stage2 import FacilitatorEngine
    from biom3_tpu_torch.pipeline.stage3 import ProteoScribeEngine
    from biom3_tpu_torch.serving import ServingPipeline

    s1 = PenCLEngine(load(root / "s1.json"), str(root / "s1.bin"), device="cpu", text_only=True,
                     use_stack=True)
    s2 = FacilitatorEngine(load(root / "s2.json"), str(root / "s2.bin"), device="cpu")
    s3 = ProteoScribeEngine(load(root / "s3.json"), str(root / "s3.bin"), device="cpu",
                            use_stack=True, **s3_kwargs)
    return ServingPipeline(s1, s2, s3, rows_per_dispatch=rows, default_replicas=2, seed=0)


def _post(url, payload, timeout=120.0):
    req = urllib.request.Request(url, data=json.dumps(payload).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def _get(url, timeout=30.0):
    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read())


def _valid(seq: str) -> bool:
    return isinstance(seq, str) and "<START>" not in seq and "<PAD>" not in seq


# --- HTTP end to end --------------------------------------------------------

def test_http_server_end_to_end(stage_files, tmp_path):
    from biom3_tpu_torch.serving import BioM3Server

    root, _, _ = stage_files
    server = BioM3Server(_port_pipeline(root, temperature=1.0), port=0, max_wait_s=0.02)
    server.start()
    base = f"http://{server.host}:{server.port}"
    try:
        health = _get(f"{base}/healthz")
        assert health == {"status": "ok", "platform": "cpu", "rows_per_dispatch": 4,
                          "continuous": True, "continuous_inpaint": False}
        results = {}

        def client(name, payload):
            results[name] = _post(f"{base}/v1/generate", payload)

        threads = [threading.Thread(target=client, args=args) for args in (
            ("a", {"prompts": [PROMPT, "kinase with atp binding"], "num_replicas": 2}),
            ("b", {"prompt": PROMPT}),
            ("c", {"prompt": "zinc finger domain", "num_replicas": 1, "seed": 3}))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        a, b, c = results["a"], results["b"], results["c"]
        assert [len(r["sequences"]) for r in a["results"] + b["results"] + c["results"]] == \
            [2, 2, 2, 1]
        assert all(_valid(s) for r in a["results"] + b["results"] + c["results"]
                   for s in r["sequences"])
        emb = _post(f"{base}/v1/embed", {"prompts": ["protein binding"]})["results"][0]
        assert len(emb["z_t"]) == 16 and len(emb["z_c"]) == 16
        inp = _post(f"{base}/v1/inpaint", {"prompt": PROMPT, "sequence": "MK??"})["results"]
        assert len(inp) == 1 and len(inp[0]["sequences"]) == 2
        assert all(_valid(s) and "?" not in s for s in inp[0]["sequences"])
        with pytest.raises(urllib.error.HTTPError) as err:
            _post(f"{base}/v1/generate", {"prompts": "not a list"})
        assert err.value.code == 400
        prof = _post(f"{base}/v1/profile", {"seconds": 0.2, "log_dir": str(tmp_path / "prof")})
        assert pathlib.Path(prof["trace"]).is_file()
        m = _get(f"{base}/v1/metrics")
        assert m["generate_mode"] == "continuous" and m["generate"]["requests"] == 4
        assert m["inpaint_mode"] == "packed" and m["inpaint"]["requests"] == 1
        assert m["inpaint"]["errors"] == 0
        assert m["generate"]["errors"] == 0 and m["embed"]["requests"] == 1
        assert m["device"]["rows_live"] > 0 and 0 < m["device"]["row_occupancy"] <= 1
        # PROMPT came twice in the first wave, so at least one hit
        assert m["embed_cache"]["hits"] >= 1 and m["memory"]["host_max_rss_mb"] > 0
    finally:
        server.close()


def test_profile_window_holds_the_trajectory_schedulers_spans(stage_files, tmp_path):
    """``POST /v1/profile`` opens its window on an HTTP handler thread: the
    written trace holds the spans the trajectory scheduler's thread kept for
    a request served in the window, and ``/v1/metrics`` its queue wait."""
    from biom3_tpu_torch.serving import BioM3Server
    from biom3_tpu_torch.utils import profiling

    root, _, _ = stage_files
    server = BioM3Server(_port_pipeline(root, temperature=0.0, positions_per_step=8), port=0,
                         max_wait_s=0.02, continuous=False)
    server.start()
    base = f"http://{server.host}:{server.port}"
    prof = {}
    try:
        _post(f"{base}/v1/generate", {"prompt": "warm up", "num_replicas": 1})
        window = threading.Thread(target=lambda: prof.update(_post(
            f"{base}/v1/profile", {"seconds": 4, "log_dir": str(tmp_path / "prof")})))
        window.start()
        deadline = time.monotonic() + 30
        while not profiling.tracing() and time.monotonic() < deadline:
            time.sleep(0.005)
        res = _post(f"{base}/v1/generate", {"prompt": PROMPT, "num_replicas": 2, "seed": 4})
        window.join(timeout=60)
        assert not window.is_alive()
        m = _get(f"{base}/v1/metrics")
    finally:
        server.close()
    assert len(res["results"][0]["sequences"]) == 2
    events = json.loads(pathlib.Path(prof["trace"]).read_text())["traceEvents"]
    kept = [e for e in events if e.get("cat") == "program_span"]
    queue = [e for e in kept if e["name"] == "serve.queue"]
    assert len(queue) == 1
    rid, did = queue[0]["args"]["rid"], queue[0]["args"]["did"]
    assert any(e["name"] == "serve.dispatch" and e["args"]["did"] == did
               and rid in e["args"]["rid"] for e in kept)
    assert any(e["name"] == "serve.collect" and e["args"]["did"] == did for e in kept)
    assert all(e["dur"] >= 0 for e in kept)
    gen = m["generate"]
    assert m["generate_mode"] == "trajectory" and gen["requests"] == 2
    assert 0 < gen["queue_wait_s_max"] <= gen["queue_wait_s_sum"]
    assert gen["dispatches_ready_at_collect"] == gen["batches"] == 2
    assert gen["resolved_before_next_enqueue"] == 2     # each served alone


# --- seeded reproduction at temperature 1 -----------------------------------

@pytest.mark.parametrize("scheduler", ["continuous", "trajectory", "micro"])
def test_seeded_request_reproduces_alone_and_mixed(stage_files, scheduler):
    """A seeded request's rows carry their own decode orders and noise keys:
    the same sequences alone and sharing dispatches with other traffic, on
    each scheduler (``micro``: the request-granular packed path)."""
    from biom3_tpu_torch.serving import ContinuousGenerateBatcher, MicroBatcher, TrajectoryBatcher

    root, _, _ = stage_files
    pipeline = _port_pipeline(root, temperature=1.0,
                              positions_per_step=1 if scheduler == "continuous" else 8)
    if scheduler == "micro":
        batcher = MicroBatcher(pipeline.generate, max_batch=4, max_wait_s=0.02)
    else:
        make = ContinuousGenerateBatcher if scheduler == "continuous" else TrajectoryBatcher
        batcher = make(pipeline)
    try:
        req = {"prompt": PROMPT, "num_replicas": 2, "seed": 11}
        alone = batcher.submit(req).result(timeout=120)["sequences"]
        futs = [batcher.submit({"prompt": "zinc finger domain", "num_replicas": 3}),
                batcher.submit(dict(req)),
                batcher.submit({"prompt": "heat shock protein", "num_replicas": 1})]
        mixed = [f.result(timeout=120)["sequences"] for f in futs]
        assert mixed[1] == alone
        assert alone[0] != alone[1]        # replicas draw their own streams
        assert pipeline.device_stats()["dispatches"] >= 2
    finally:
        batcher.close()


# --- parity with the JAX package (temperature 0) ------------------------------

def test_continuous_temp0_matches_jax_scheduler(stage_files):
    from biom3_tpu.serving import ContinuousGenerateBatcher as JaxContinuous
    from biom3_tpu.serving import ServingPipeline as JaxPipeline
    from biom3_tpu_torch.serving import ContinuousGenerateBatcher

    root, (j1, j2, j3), _ = stage_files
    req = {"prompt": PROMPT, "num_replicas": 2, "seed": 5}
    jax_batcher = JaxContinuous(JaxPipeline(j1, j2, j3, rows_per_dispatch=4,
                                            default_replicas=2, seed=0))
    port_batcher = ContinuousGenerateBatcher(_port_pipeline(root, temperature=0.0))
    try:
        want = jax_batcher.submit(dict(req)).result(timeout=300)["sequences"]
        got = port_batcher.submit(dict(req)).result(timeout=120)["sequences"]
    finally:
        jax_batcher.close()
        port_batcher.close()
    assert got == want and all(_valid(s) and s for s in got)


def test_trajectory_k8_temp0_matches_jax_scheduler(stage_files, monkeypatch):
    import biom3_tpu.pipeline.stage3 as jax_stage3
    from biom3_tpu.pipeline.stage3 import ProteoScribeEngine as JaxEngine
    from biom3_tpu.serving import ServingPipeline as JaxPipeline
    from biom3_tpu.serving import TrajectoryBatcher as JaxTrajectory
    from biom3_tpu_torch.serving import TrajectoryBatcher
    from biom3_tpu_torch.serving.continuous import row_streams

    root, (j1, j2, _), _ = stage_files
    L, seed, n_rep, R = 64, 9, 2, 4
    invs = [row_streams(None, seed, rep, L)[0] for rep in range(n_rep)]
    paths = np.stack([np.argsort(invs[min(i, n_rep - 1)]) for i in range(R)]).astype(np.int32)
    monkeypatch.setattr(jax_stage3, "sample_permutations",
                        lambda key, batch, length: jnp.asarray(paths[:batch]))
    j3 = JaxEngine(load_json_config(root / "s3.json"), str(root / "s3.bin"), temperature=0.0,
                   positions_per_step=8, chunk_steps=8)
    req = {"prompt": PROMPT, "num_replicas": n_rep, "seed": seed}
    jax_batcher = JaxTrajectory(JaxPipeline(j1, j2, j3, rows_per_dispatch=R,
                                            default_replicas=2, seed=0))
    port_batcher = TrajectoryBatcher(_port_pipeline(root, rows=R, temperature=0.0,
                                                    positions_per_step=8, chunk_steps=8))
    try:
        want = jax_batcher.submit(dict(req)).result(timeout=300)["sequences"]
        got = port_batcher.submit(dict(req)).result(timeout=120)["sequences"]
    finally:
        jax_batcher.close()
        port_batcher.close()
    assert got == want and all(_valid(s) and s for s in got)


@pytest.mark.parametrize("k", [1, 4])
def test_chunk_stepper_temp0_equals_sampler_and_jax(stage_files, k):
    """Aligned rows from t0 = 0 through the chunk stepper, with a given
    ``inv``: bit-equal to the port's whole-trajectory sampler and to JAX
    ``make_chunk_stepper`` on the same weights."""
    from biom3_tpu.diffusion.sampler import make_chunk_stepper as jax_chunk_stepper
    from biom3_tpu_torch.diffusion.sampler import make_chunk_stepper, make_sampler

    root, (_, _, j3), _ = stage_files
    eng = _port_pipeline(root, temperature=0.0).s3
    L, steps, B, chunk = 64, 64, 3, 4
    rng = np.random.default_rng(k)
    inv = np.stack([rng.permutation(L) for _ in range(B)]).astype(np.int32)
    z_c = rng.standard_normal((B, 16)).astype(np.float32)
    kd = np.zeros((B, 2), np.uint32)

    step = make_chunk_stepper(eng._apply_fn, steps, chunk_steps=chunk, positions_per_step=k,
                              temperature=0.0, apply_takes_positions=True)
    x, t0 = torch.zeros((B, L), dtype=torch.int32), torch.zeros(B, dtype=torch.int64)
    kd_t = torch.zeros((B, 2), dtype=torch.int64)
    for _ in range(steps // k // chunk):
        x, kd_t = step(torch.from_numpy(z_c), torch.from_numpy(inv).long(), x, t0, kd_t, kd_t)
        t0 = t0 + chunk * k
    got = x.numpy()

    whole = make_sampler(eng._apply_fn, steps, temperature=0.0, positions_per_step=k,
                         apply_takes_positions=True)
    np.testing.assert_array_equal(
        got, whole(torch.from_numpy(z_c), torch.from_numpy(np.argsort(inv, -1))).numpy())

    jstep = jax_chunk_stepper(j3.model.apply, steps, chunk_steps=chunk, positions_per_step=k,
                              temperature=0.0)
    jx, jt0, jkd = jnp.zeros((B, L), jnp.int32), jnp.zeros((B,), jnp.int32), jnp.asarray(kd)
    for _ in range(steps // k // chunk):
        jx, jkd = jstep(j3.params, jnp.asarray(z_c), jnp.asarray(inv), jx, jt0, jkd, jkd)
        jt0 = jt0 + chunk * k
    np.testing.assert_array_equal(got, np.asarray(jx))


def test_row_noise_is_philox_and_batch_invariant():
    """The counter-based noise: Philox-4x32-10's published answers
    (Random123 known-answer vectors), and a row's noise independent of the
    rows beside it."""
    from biom3_tpu_torch.diffusion.sampler import philox4x32, row_gumbel

    def words(*a):
        return [torch.tensor([v]) for v in a]

    kats = [((0, 0, 0, 0), (0, 0), (0x6627e8d5, 0xe169c58d, 0xbc57ac4c, 0x9b00dbd8)),
            ((0xffffffff,) * 4, (0xffffffff,) * 2, (0x408f276d, 0x41c83b0e, 0xa20bc7c6,
                                                    0x6d5451fd)),
            ((0x243f6a88, 0x85a308d3, 0x13198a2e, 0x03707344), (0xa4093822, 0x299f31d0),
             (0xd16cfe09, 0x94fdcceb, 0x5001e420, 0x24126ea1))]
    for ctr, key, want in kats:
        assert tuple(int(w) for w in philox4x32(words(*ctr), words(*key))) == want
    keys = torch.tensor([[1, 2], [3, 4], [5, 6]])
    steps = torch.arange(12).reshape(3, 4)
    g = row_gumbel(keys, steps, 29)
    np.testing.assert_array_equal(g[1:2].numpy(), row_gumbel(keys[1:2], steps[1:2], 29).numpy())
    assert g.shape == (3, 4, 29) and torch.isfinite(g).all()
    assert abs(float(row_gumbel(keys, torch.arange(3000).reshape(3, 1000), 29).mean())
               - 0.5772) < 0.02   # the Gumbel mean, Euler's constant


# --- three faults of the JAX serving code, fixed in the port -------------------

def test_trajectory_close_fails_rows_of_a_hung_dispatch(stage_files):
    """A fault of the JAX scheduler, fixed here: a dispatch's rows are in
    neither _pending nor _flight while it is enqueued; close() must still
    fail them, not leave clients waiting."""
    from biom3_tpu_torch.serving import TrajectoryBatcher

    root, _, _ = stage_files
    batcher = TrajectoryBatcher(_port_pipeline(root, temperature=0.0, positions_per_step=8))
    release, entered = threading.Event(), threading.Event()

    def hung_row_fn(*args):
        entered.set()
        release.wait(timeout=30)
        raise RuntimeError("device lost")

    batcher._row_fn = hung_row_fn
    fut = batcher.submit({"prompt": PROMPT, "num_replicas": 1})
    assert entered.wait(timeout=60)
    with batcher._cv:
        assert batcher._dispatching and not batcher._pending
    t0 = time.monotonic()
    batcher.close(timeout=0.5, drain_s=0.2)
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=5)
    assert time.monotonic() - t0 < 10
    release.set()


def test_trajectory_close_fails_rows_of_a_hung_collect(stage_files):
    """A dispatch whose collect hangs (its host copy never lands) stays in
    the collector's queue: close() fails its rows within a bounded time."""
    from biom3_tpu_torch.serving import TrajectoryBatcher

    root, _, _ = stage_files
    batcher = TrajectoryBatcher(_port_pipeline(root, temperature=0.0, positions_per_step=8))
    release, entered = threading.Event(), threading.Event()

    class HungCopy:
        def numpy(self):
            entered.set()
            release.wait(timeout=30)
            raise RuntimeError("host copy lost")

    batcher._to_host = lambda ids: (HungCopy(), None)
    fut = batcher.submit({"prompt": PROMPT, "num_replicas": 1})
    assert entered.wait(timeout=60)
    with batcher._cv:
        assert batcher._flights and not batcher._pending and batcher._dispatching is None
    t0 = time.monotonic()
    batcher.close(timeout=0.5, drain_s=0.2)
    with pytest.raises(RuntimeError, match="closed"):
        fut.result(timeout=5)
    assert time.monotonic() - t0 < 10
    release.set()


def test_trajectory_collect_error_fails_only_its_dispatch(stage_files):
    """An exception while one dispatch is collected fails that dispatch's
    requests alone: the next dispatch still resolves, and the error counts
    once."""
    from biom3_tpu_torch.serving import TrajectoryBatcher

    root, _, _ = stage_files
    batcher = TrajectoryBatcher(_port_pipeline(root, rows=4, temperature=0.0,
                                               positions_per_step=8))
    to_host, calls = batcher._to_host, []

    class LostCopy:
        def numpy(self):
            raise RuntimeError("host copy failed")

    def first_copy_lost(ids):
        calls.append(1)
        return (LostCopy(), None) if len(calls) == 1 else to_host(ids)

    batcher._to_host = first_copy_lost
    try:
        # 4 replicas fill the first dispatch; the second request rides the next
        lost = batcher.submit({"prompt": PROMPT, "num_replicas": 4, "seed": 1})
        kept = batcher.submit({"prompt": "zinc finger domain", "num_replicas": 2, "seed": 2})
        with pytest.raises(RuntimeError, match="host copy failed"):
            lost.result(timeout=120)
        seqs = kept.result(timeout=120)["sequences"]
        assert len(seqs) == 2 and all(map(_valid, seqs))
        assert batcher.stats.as_dict()["errors"] == 1
    finally:
        batcher.close()


def test_trajectory_resolves_a_dispatch_while_the_next_enqueue_blocks(stage_files):
    """The collector thread resolves a landed dispatch while the scheduler
    thread is still inside the next dispatch's enqueue, and counts it in
    ``resolved_before_next_enqueue``; the seeded requests' sequences are
    those they give alone."""
    from biom3_tpu_torch.serving import TrajectoryBatcher

    root, _, _ = stage_files
    batcher = TrajectoryBatcher(_port_pipeline(root, rows=4, temperature=1.0,
                                               positions_per_step=8))
    row_fn, calls = batcher._row_fn, []
    release, entered = threading.Event(), threading.Event()

    def second_call_blocks(*args):
        calls.append(1)
        if len(calls) == 2:
            entered.set()
            release.wait(timeout=60)
        return row_fn(*args)

    second_call_blocks.accepts_masked = row_fn.accepts_masked
    batcher._row_fn = second_call_blocks
    reqs = [{"prompt": PROMPT, "num_replicas": 4, "seed": 5},     # fills the first dispatch
            {"prompt": "zinc finger domain", "num_replicas": 2, "seed": 6}]
    try:
        futs = [batcher.submit(dict(r)) for r in reqs]
        assert entered.wait(timeout=120)
        first = futs[0].result(timeout=60)["sequences"]
        deadline = time.monotonic() + 10
        while (batcher.stats.as_dict()["resolved_before_next_enqueue"] < 1
               and time.monotonic() < deadline):
            time.sleep(0.01)
        assert batcher.stats.as_dict()["resolved_before_next_enqueue"] == 1
        assert not futs[1].done() and not release.is_set()
        release.set()
        second = futs[1].result(timeout=120)["sequences"]
        alone = [batcher.submit(dict(r)).result(timeout=120)["sequences"] for r in reqs]
        assert [first, second] == alone
        stats = batcher.stats.as_dict()
        assert stats["resolved_before_next_enqueue"] == stats["batches"] == 4
    finally:
        release.set()
        batcher.close()


def test_trajectory_window_stretches_for_a_dispatch_uncollected_when_the_round_began(
        stage_files):
    """The coalescing window stretches to 2 × the dispatch EMA when a
    dispatch was uncollected as the scheduler began its round, even if the
    collector finishes it during that round's embed (on the card, the
    embed's synchronise lets the ids land first)."""
    from biom3_tpu_torch.serving import TrajectoryBatcher

    root, _, _ = stage_files
    pipeline = _port_pipeline(root, rows=4, temperature=0.0, positions_per_step=8)
    batcher = TrajectoryBatcher(pipeline, max_wait_s=0.005)
    to_host, row_fn, embed = batcher._to_host, batcher._row_fn, pipeline.embed
    land, entered, enqueued = threading.Event(), threading.Event(), []

    class LateCopy:
        def __init__(self, ids):
            self.ids = ids

        def numpy(self):
            entered.set()
            land.wait(timeout=60)
            return self.ids.numpy()

    def recording_row_fn(*args):
        enqueued.append(time.monotonic())
        return row_fn(*args)

    def embed_after_the_collect(prompts):
        land.set()
        deadline = time.monotonic() + 30
        while batcher._flights and time.monotonic() < deadline:
            time.sleep(0.005)
        batcher._ema_dispatch_s = 0.3      # the collect just updated it
        done.append(time.monotonic())
        return embed(prompts)

    recording_row_fn.accepts_masked = row_fn.accepts_masked
    batcher._row_fn = recording_row_fn
    batcher._to_host = lambda ids: (LateCopy(ids), None) if not entered.is_set() else to_host(ids)
    done = []
    try:
        first = batcher.submit({"prompt": PROMPT, "num_replicas": 4})    # a full dispatch
        assert entered.wait(timeout=120)
        pipeline.embed = embed_after_the_collect
        late = batcher.submit({"prompt": "zinc finger domain", "num_replicas": 1})
        assert len(late.result(timeout=120)["sequences"]) == 1
        assert len(first.result(timeout=5)["sequences"]) == 4
    finally:
        land.set()
        batcher.close()
    assert len(enqueued) == 2 and len(done) == 1
    assert enqueued[1] - done[0] >= 0.5       # the 0.6-s window, not max_wait_s


def test_trajectory_threads_keep_the_counts_exact_under_contention(stage_files):
    """Submitters on more threads than cores, beside the scheduler and the
    collector, under a short switch interval: every request resolves once
    with its replicas, each row is counted once, and the outstanding count
    returns to exactly 0."""
    import os

    from biom3_tpu_torch.serving import TrajectoryBatcher

    root, _, _ = stage_files
    batcher = TrajectoryBatcher(_port_pipeline(root, rows=4, temperature=0.0,
                                               positions_per_step=8), max_wait_s=0.005)
    n = (os.cpu_count() or 1) + 2
    futs = [None] * n

    def submit(i):
        futs[i] = batcher.submit({"prompt": f"{PROMPT} {i % 3}", "num_replicas": 1 + i % 3})

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=submit, args=(i,)) for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        for i, f in enumerate(futs):
            assert len(f.result(timeout=300)["sequences"]) == 1 + i % 3
        with batcher._cv:
            assert batcher._outstanding == 0
    finally:
        sys.setswitchinterval(interval)
        batcher.close()
    stats = batcher.stats.as_dict()
    assert stats["requests"] == n and stats["errors"] == 0
    assert stats["items"] == sum(1 + i % 3 for i in range(n))
    assert stats["resolved_before_next_enqueue"] <= stats["batches"]


def test_run_server_preset_sentinels():
    """A fault of the JAX CLI, fixed here: a flag given explicitly at its
    default value beats the preset; mesh serving (``--mesh_dp 2``,
    ``--mesh_fsdp 2 --continuous_inpaint``) builds a 2-position mesh on the
    CPU and one device without the flags, and continuous inpaint, the
    throughput preset and confidence order parse."""
    from biom3_tpu_torch.cli import run_server

    base = [f for n in (1, 2, 3) for f in (f"--stage{n}_json", "x", f"--stage{n}_model", "x")]
    args = run_server.parse_arguments(base + ["--preset", "latency"])
    assert (args.temperature, args.positions_per_step, args.continuous) == (0.0, 8, "off")
    args = run_server.parse_arguments(base + ["--preset", "latency", "--temperature", "1.0",
                                              "--rows_per_dispatch", "16"])
    assert (args.temperature, args.rows_per_dispatch, args.chunk_steps) == (1.0, 16, 16)
    args = run_server.parse_arguments(base)
    assert (args.temperature, args.rows_per_dispatch, args.continuous) == (1.0, 16, "auto")
    assert run_server.build_mesh(args) is None
    for extra, shape in ((["--mesh_dp", "2"], {"dp": 2, "fsdp": 1, "tp": 1}),
                         (["--mesh_fsdp", "2", "--continuous_inpaint"],
                          {"dp": 1, "fsdp": 2, "tp": 1})):
        mesh = run_server.build_mesh(run_server.parse_arguments(base + extra + ["--device",
                                                                                "cpu"]))
        assert mesh.shape == shape and mesh.batch_devices() == [torch.device("cpu")] * 2
    args = run_server.parse_arguments(base + ["--continuous_inpaint"])
    assert args.continuous_inpaint
    for extra, want in ((["--preset", "throughput"], ("maskgit", 16, "off")),
                        (["--decode_order", "confidence"], ("ardm", 16, "auto"))):
        args = run_server.parse_arguments(base + extra)
        assert (args.sampler, args.maskgit_steps, args.continuous) == want


def test_throughput_preset_server_answers(stage_files):
    """``--preset throughput`` (MaskGIT, 16 steps, the trajectory scheduler)
    in process on the CPU: /healthz shows no continuous batching, and one
    request of two replicas answers with valid sequences."""
    from biom3_tpu_torch.cli import run_server

    root, _, flags = stage_files
    args = run_server.parse_arguments(flags + ["--preset", "throughput", "--device", "cpu",
                                               "--port", "0", "--rows_per_dispatch", "2"])
    server = run_server.build_server(args)
    assert server.pipeline.s3.sampler_mode == "maskgit"
    server.start()
    base = f"http://{server.host}:{server.port}"
    try:
        health = _get(f"{base}/healthz")
        assert health["continuous"] is False
        res = _post(f"{base}/v1/generate", {"prompt": PROMPT, "num_replicas": 2, "seed": 3})
    finally:
        server.close()
    seqs = res["results"][0]["sequences"]
    assert len(seqs) == 2 and all(map(_valid, seqs))


def test_embed_cache_counts_each_computed_prompt_once(stage_files):
    """A fault of the JAX pipeline's cache counts, fixed here: a prompt
    repeated within one batch is computed once: one miss,
    the repeat a hit; the cached values are the computed ones."""
    root, _, _ = stage_files
    pipeline = _port_pipeline(root)
    z_t, z_c = pipeline.embed(["a b", "a b", "c d"])
    assert pipeline.embed_cache_stats()["misses"] == 2
    assert pipeline.embed_cache_stats()["hits"] == 1
    np.testing.assert_array_equal(z_c[0], z_c[1])
    z_t2, z_c2 = pipeline.embed(["c d"])
    np.testing.assert_array_equal(z_c2[0], z_c[2])
    assert pipeline.embed_cache_stats() == {"capacity": 4096, "size": 2, "hits": 2, "misses": 2}


def test_dispatch_error_fails_its_requests_and_is_counted(stage_files):
    """An exception in the scheduler thread (a device error, say) fails the
    requests of that dispatch, shows in the error count, and close() does
    not hang."""
    from biom3_tpu_torch.serving import ContinuousGenerateBatcher

    root, _, _ = stage_files
    batcher = ContinuousGenerateBatcher(_port_pipeline(root, temperature=0.0))

    def broken(*args):
        raise RuntimeError("CUDA error: an illegal memory access was encountered")

    batcher._chunk_fn = broken
    fut = batcher.submit({"prompt": PROMPT, "num_replicas": 2})
    with pytest.raises(RuntimeError, match="illegal memory access"):
        fut.result(timeout=60)
    assert batcher.stats.as_dict()["errors"] == 1
    t0 = time.monotonic()
    batcher.close(timeout=5, drain_s=1)
    assert time.monotonic() - t0 < 10
    for mids in ([0, 1], [2, 1]):   # an inpaint row, and one with nothing to fill
        with pytest.raises(RuntimeError, match="closed"):
            batcher.submit({"prompt": "x", "masked_ids": mids})


# --- inpainting ------------------------------------------------------------------

def _is_subsequence(sub: str, seq: str) -> bool:
    it = iter(seq)
    return all(c in it for c in sub)


@pytest.mark.parametrize("route", ["continuous", "packed", "maskgit"])
def test_inpaint_routes_answer_and_keep_residues(stage_files, route):
    """/v1/inpaint on its three routes — rows on the continuous scheduler
    (``continuous_inpaint``), the packed confidence inpainter beside the
    trajectory scheduler (k=8, early exit at chunk 16), MaskGIT rows merged
    into generate dispatches — answers 200: every ``?`` filled, the committed
    residues kept in order; /v1/metrics names the route and counts it."""
    from biom3_tpu_torch.serving import BioM3Server

    root, _, _ = stage_files
    kw = {"continuous": dict(temperature=1.0),
          "packed": dict(temperature=0.0, positions_per_step=8, chunk_steps=16),
          "maskgit": dict(temperature=1.0, sampler_mode="maskgit", maskgit_steps=4)}[route]
    server = BioM3Server(_port_pipeline(root, **kw), port=0, max_wait_s=0.02,
                         continuous_inpaint=route == "continuous")
    server.start()
    base = f"http://{server.host}:{server.port}"
    try:
        res = _post(f"{base}/v1/inpaint", {"prompt": PROMPT, "sequence": "MK??ACDE??",
                                           "num_replicas": 2, "seed": 4})["results"][0]
        full = _post(f"{base}/v1/inpaint", {"prompt": PROMPT, "sequence": "MKACDE"})
        gen = _post(f"{base}/v1/generate", {"prompt": PROMPT, "num_replicas": 1})
        m = _get(f"{base}/v1/metrics")
        health = _get(f"{base}/healthz")
    finally:
        server.close()
    assert res["prompt"] == PROMPT and len(res["sequences"]) == 2
    for seq in res["sequences"]:
        assert _valid(seq) and "?" not in seq and _is_subsequence("MKACDE", seq), seq
    assert full["results"][0]["sequences"] == ["MKACDE", "MKACDE"]
    assert len(gen["results"][0]["sequences"]) == 1
    assert health["continuous_inpaint"] == (route == "continuous")
    assert m["inpaint_mode"] == {"continuous": "continuous", "packed": "packed",
                                 "maskgit": "trajectory"}[route]
    if route == "packed":
        assert m["inpaint"]["requests"] == 2 and m["inpaint"]["errors"] == 0
        assert m["generate"]["requests"] == 1
    else:
        assert m["inpaint"] == {"merged_into_generate": True}
        assert m["generate"]["requests"] == 3 and m["generate"]["errors"] == 0


def test_inpaint_bad_requests_answer_400(stage_files):
    """JAX ``tests/test_serving.py:293-300``: validated and encoded on the
    handler thread, so a bad request answers 400 and never reaches a
    dispatch."""
    from biom3_tpu_torch.serving import BioM3Server

    root, _, _ = stage_files
    server = BioM3Server(_port_pipeline(root, temperature=0.0), port=0)
    server.start()
    base = f"http://{server.host}:{server.port}"
    try:
        for payload in ({"sequence": "MK??"}, {"prompt": "x"}, {"prompt": "x", "sequence": ""},
                        {"prompt": "x", "sequence": "MJ??"},
                        {"prompt": "x", "sequence": "A" * 63},
                        {"prompt": "x", "sequence": "M??", "unknown": "??"},
                        {"prompt": "x", "sequence": "M??", "num_replicas": 0},
                        {"prompt": "x", "sequence": "M??", "seed": -1}):
            with pytest.raises(urllib.error.HTTPError) as err:
                _post(f"{base}/v1/inpaint", payload)
            assert err.value.code == 400, payload
        m = _get(f"{base}/v1/metrics")
    finally:
        server.close()
    assert m["inpaint"]["requests"] == 0 and m["device"]["dispatches"] == 0


def test_seeded_inpaint_reproduces_and_warmup_reports_inpaint_s(stage_files):
    """The packed inpainter at temperature 1: a seeded request's rows fill
    the same alone and beside other traffic, and another seed fills
    otherwise; ``warmup`` reports ``inpaint_s`` and leaves the packing
    counters alone."""
    root, _, _ = stage_files
    pipeline = _port_pipeline(root, temperature=1.0, chunk_steps=16)
    times = pipeline.warmup()
    assert set(times) == {"embed_s", "generate_s", "inpaint_s"}
    assert pipeline.device_stats()["dispatches"] == 0
    req = {"prompt": PROMPT, "sequence": "MK??ACDE??", "seed": 11, "num_replicas": 2}
    a = pipeline.inpaint([dict(req)])
    b = pipeline.inpaint([{"prompt": "co-traffic", "sequence": "????"}, dict(req)])
    assert a[0]["sequences"] == b[1]["sequences"]
    c = pipeline.inpaint([dict(req, seed=12)])
    assert c[0]["sequences"] != a[0]["sequences"]
    assert all("?" not in s for r in a + b + c for s in r["sequences"])


def test_continuous_inpaint_needs_the_continuous_scheduler(stage_files):
    from biom3_tpu_torch.serving import BioM3Server

    root, _, _ = stage_files
    with pytest.raises(ValueError, match="continuous_inpaint requires the continuous"):
        BioM3Server(_port_pipeline(root, temperature=0.0), port=0, continuous=False,
                    continuous_inpaint=True)
    server = BioM3Server(_port_pipeline(root, temperature=0.0), port=0,
                         continuous_inpaint=True)
    server.start()
    try:
        assert server._inpaint_batcher is server._gen_batcher
        assert "inpaint_s" not in server.warmup()
    finally:
        server.close()


def test_continuous_inpaint_temp0_matches_jax_scheduler(stage_files):
    """A seeded inpaint request on both continuous schedulers at temperature
    0: the same row layouts (``_prepare_row``) from the same numpy streams,
    so the same sequences."""
    from biom3_tpu.serving import ContinuousGenerateBatcher as JaxContinuous
    from biom3_tpu.serving import ServingPipeline as JaxPipeline
    from biom3_tpu_torch.serving import ContinuousGenerateBatcher

    root, (j1, j2, j3), _ = stage_files
    mids = j3.vocab.encode_partial("MK??ACDE??LL?", 64)
    req = {"prompt": PROMPT, "num_replicas": 2, "seed": 5, "masked_ids": mids}
    jax_batcher = JaxContinuous(JaxPipeline(j1, j2, j3, rows_per_dispatch=4,
                                            default_replicas=2, seed=0))
    port_batcher = ContinuousGenerateBatcher(_port_pipeline(root, temperature=0.0))
    try:
        want = jax_batcher.submit(dict(req)).result(timeout=300)["sequences"]
        got = port_batcher.submit(dict(req)).result(timeout=120)["sequences"]
    finally:
        jax_batcher.close()
        port_batcher.close()
    assert got == want and all("?" not in s and _is_subsequence("MKACDELL", s) for s in got)


# --- the CLI --------------------------------------------------------------------

def test_run_server_cli_serves_then_exits_on_sigterm(stage_files):
    _, _, flags = stage_files
    proc = subprocess.Popen(
        [sys.executable, "-m", "biom3_tpu_torch.cli.run_server", *flags, "--device", "cpu",
         "--port", "0", "--rows_per_dispatch", "2", "--warmup"],
        cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        base = None
        deadline = time.monotonic() + 120
        while base is None and time.monotonic() < deadline:
            line = proc.stdout.readline()
            if not line:
                break
            if line.startswith("serving on "):
                base = line.split()[-1]
        assert base, proc.stderr.read()[-2000:] if proc.poll() is not None else "no serve line"
        out = _post(f"{base}/v1/generate", {"prompt": PROMPT, "num_replicas": 1, "seed": 1})
        assert len(out["results"][0]["sequences"]) == 1
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()


def test_run_server_refuses_cuda_without_a_card(stage_files):
    """--device cuda is the default and has no CPU fallback."""
    from biom3_tpu_torch.cli import run_server

    if torch.cuda.is_available():
        pytest.skip("a card is present")
    _, _, flags = stage_files
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_server.build_server(run_server.parse_arguments(flags + ["--port", "0"]))

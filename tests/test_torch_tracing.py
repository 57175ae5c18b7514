"""The port's spans (``utils/profiling.py``) on the CPU.

A span records only while a ``torch.profiler`` window is open somewhere in
the process, keeps the spans of threads started before the window, stamps
them on the clock of the profiler's own events, and the serving scheduler and
the train step keep the spans the benchmark's per-layer metrics read.
"""

import threading
import time

import numpy as np
import pytest
import torch

from biom3_tpu_torch.utils import profiling

PROMPT = "membrane transport protein"


def _window():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _since(t0_ns: int, *names: str) -> list:
    return [s for s in profiling.spans() if s.start_ns >= t0_ns and s.name in names]


def test_span_without_a_window_records_nothing(monkeypatch):
    calls = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda *a, **k: calls.append(a) or pytest.fail("record_function"))
    assert not profiling.tracing()
    t0 = time.time_ns()
    with profiling.span("tracing.off", rid=1) as s:
        s.note(rows=3)
    assert profiling.span("a") is profiling.span("b", did=2)   # one shared no-op context
    assert profiling.stamp() is None
    profiling.record("tracing.off", profiling.stamp(), rid=1)
    assert calls == [] and _since(t0, "tracing.off") == []


def test_window_keeps_spans_of_a_thread_started_before_it():
    go, done = threading.Event(), threading.Event()

    def worker():
        assert go.wait(timeout=30)
        for rid in range(3):
            with profiling.span("tracing.outer", rid=rid) as outer:
                with profiling.span("tracing.inner", rid=rid):
                    time.sleep(0.001)
                outer.note(rows=rid + 1)
        done.set()

    t0 = time.time_ns()
    thread = threading.Thread(target=worker, name="tracing-worker")
    thread.start()
    with _window():
        assert profiling.tracing()
        go.set()
        assert done.wait(timeout=30)
    thread.join(timeout=30)
    assert not thread.is_alive() and not profiling.tracing()
    kept = _since(t0, "tracing.outer", "tracing.inner")
    assert sorted((s.name, s.ids["rid"]) for s in kept) == sorted(
        (n, r) for n in ("tracing.outer", "tracing.inner") for r in range(3))
    outer = {s.ids["rid"]: s for s in kept if s.name == "tracing.outer"}
    for s in kept:
        assert s.thread == "tracing-worker" and s.start_ns <= s.end_ns
        if s.name == "tracing.inner":
            o = outer[s.ids["rid"]]
            assert s.parent == "tracing.outer" and o.start_ns <= s.start_ns <= s.end_ns <= o.end_ns
        else:
            assert s.parent is None and s.ids["rows"] == s.ids["rid"] + 1


def test_span_is_on_the_clock_of_the_profilers_events():
    t0 = time.time_ns()
    with _window() as prof:
        with profiling.span("tracing.clock"):
            time.sleep(0.01)
    mine = _since(t0, "tracing.clock")
    theirs = [e for e in prof.profiler.kineto_results.events() if e.name() == "tracing.clock"]
    assert len(mine) == 1 and len(theirs) == 1
    assert abs(theirs[0].start_ns() - mine[0].start_ns) < 2_000_000
    end = theirs[0].start_ns() + theirs[0].duration_ns()
    assert abs(end - mine[0].end_ns) < 2_000_000


@pytest.fixture(scope="module")
def tiny_pipeline(tmp_path_factory):
    """Tiny engines on seeded random weights (no checkpoint), the
    latency preset's decode (k = 8, temperature 0), 4 rows a dispatch."""
    from biom3_tpu_torch.config import Config
    from biom3_tpu_torch.pipeline.stage1 import PenCLEngine
    from biom3_tpu_torch.pipeline.stage2 import FacilitatorEngine
    from biom3_tpu_torch.pipeline.stage3 import ProteoScribeEngine
    from biom3_tpu_torch.serving import ServingPipeline
    from biom3_tpu_torch.tokenizers.synthetic import write_synthetic_wordpiece

    root = tmp_path_factory.mktemp("tracing")
    vocab = write_synthetic_wordpiece(root / "tok")
    torch.manual_seed(0)
    s1 = PenCLEngine(Config({
        "protein_encoder_embedding": 16, "text_encoder_embedding": 32, "esm_num_layers": 1,
        "esm_attention_heads": 2, "bert_num_layers": 1, "bert_num_heads": 2,
        "bert_intermediate_size": 64, "bert_vocab_size": vocab,
        "bert_max_position_embeddings": 32, "proj_embedding_dim": 16, "text_max_length": 32,
        "text_model_path": str(root / "tok")}), device="cpu", text_only=True, use_stack=True)
    s2 = FacilitatorEngine(Config({"emb_dim": 16, "hid_dim": 32, "dropout": 0.0}),
                           device="cpu")
    s3 = ProteoScribeEngine(Config({
        "diffusion_steps": 64, "num_classes": 29, "text_emb_dim": 16, "transformer_dim": 32,
        "transformer_heads": 4, "transformer_depth": 2, "transformer_blocks": 1,
        "transformer_local_heads": 2, "transformer_local_size": 16}), device="cpu",
        use_stack=True, temperature=0.0, positions_per_step=8, chunk_steps=8)
    return ServingPipeline(s1, s2, s3, rows_per_dispatch=4, default_replicas=2, seed=0)


def _serve_in_window(pipeline):
    """Six requests of 1–3 replicas through the trajectory scheduler, all
    submitted and answered inside a window opened on this thread after the
    scheduler's thread started → (the requests' rids, the spans since)."""
    from biom3_tpu_torch.serving import TrajectoryBatcher

    batcher = TrajectoryBatcher(pipeline, max_wait_s=0.02)
    try:
        batcher.submit({"prompt": "warm up", "num_replicas": 1}).result(timeout=120)
        t0 = time.time_ns()
        with _window():
            futs = [batcher.submit({"prompt": f"{PROMPT} {i % 3}", "num_replicas": 1 + i % 3,
                                    "seed": i}) for i in range(6)]
            for f in futs:
                assert len(f.result(timeout=120)["sequences"]) >= 1
        stats = batcher.stats.as_dict()
    finally:
        batcher.close()
    kept = [s for s in profiling.spans() if s.start_ns >= t0 and s.name.startswith("serve.")]
    rids = {s.ids["rid"] for s in kept if s.name == "serve.request"}
    return rids, kept, stats


def test_trajectory_scheduler_links_each_request_to_its_dispatch(tiny_pipeline):
    rids, kept, stats = _serve_in_window(tiny_pipeline)
    assert len(rids) == 6
    queue = {s.ids["rid"]: s for s in kept if s.name == "serve.queue"}
    dispatch = {s.ids["did"]: s for s in kept if s.name == "serve.dispatch"}
    collect = {s.ids["did"]: s for s in kept if s.name == "serve.collect"}
    assert set(queue) == rids
    for rid, q in queue.items():
        did = q.ids["did"]
        assert rid in dispatch[did].ids["rid"] and did in collect
        assert isinstance(collect[did].ids["ready"], bool)
    assert sum(d.ids["rows"] for d in dispatch.values()) == 12    # 6 requests, 12 replicas
    threads = {(s.name, s.thread) for s in kept if s.name in ("serve.dispatch", "serve.collect")}
    assert threads == {("serve.dispatch", "generate-trajectory"),
                       ("serve.collect", "generate-trajectory-collect")}
    assert any(s.name == "serve.embed" and s.ids["rid"] for s in kept)
    # the always-on counters
    assert stats["queue_wait_s_max"] > 0 and stats["queue_wait_s_sum"] >= stats[
        "queue_wait_s_max"]
    assert stats["dispatches_ready_at_collect"] >= len(collect)   # the CPU's ids are there


def test_request_phases_sum_to_the_request(tiny_pipeline):
    """queue → its dispatch's enqueue → the wait for the collect → the
    collect up to the reply: contiguous, and together the request."""
    rids, kept, _ = _serve_in_window(tiny_pipeline)
    by = {(s.name, s.ids.get("rid") if s.name in ("serve.queue", "serve.request")
           else s.ids.get("did")): s for s in kept}
    for rid in rids:
        req, q = by["serve.request", rid], by["serve.queue", rid]
        d, c = by["serve.dispatch", q.ids["did"]], by["serve.collect", q.ids["did"]]
        assert q.start_ns == req.start_ns
        assert q.end_ns <= d.start_ns <= d.end_ns <= c.start_ns <= req.end_ns <= c.end_ns
        phases = [q.end_ns - q.start_ns, d.start_ns - q.end_ns, d.end_ns - d.start_ns,
                  c.start_ns - d.end_ns, req.end_ns - c.start_ns]
        assert min(phases) >= 0
        assert abs(sum(phases) - (req.end_ns - req.start_ns)) < 1_000_000
        assert d.start_ns - q.end_ns < 1_000_000      # the queue ends where the enqueue starts


def test_train_step_keeps_its_phases_in_order():
    from biom3_tpu_torch.config import Config, ProteoScribeConfig
    from biom3_tpu_torch.models.proteoscribe import ProteoScribe
    from biom3_tpu_torch.training.optim import make_optimizer
    from biom3_tpu_torch.training.stage3_task import make_stage3_train_step
    from biom3_tpu_torch.training.state import TrainState

    torch.manual_seed(0)
    cfg = ProteoScribeConfig.from_stage_config(Config({
        "diffusion_steps": 32, "num_classes": 29, "text_emb_dim": 8, "transformer_dim": 32,
        "transformer_heads": 2, "transformer_depth": 1, "transformer_blocks": 1,
        "transformer_local_heads": 1, "transformer_local_size": 8}))
    model = ProteoScribe(cfg)
    state = TrainState(model, make_optimizer("AdamW", model.parameters(), 1e-4, None),
                       with_ema=True)
    step = make_stage3_train_step(state)
    batch = {"tokens": torch.randint(1, 29, (2, 32)), "z_c": torch.randn(2, 8)}
    gen = torch.Generator().manual_seed(0)
    t0 = time.time_ns()
    with _window():
        step(batch, gen)
    kept = sorted(_since(t0, "train.step", "train.forward_backward", "train.optimizer",
                         "train.ema"), key=lambda s: s.start_ns)
    assert [s.name for s in kept] == ["train.step", "train.forward_backward",
                                      "train.optimizer", "train.ema"]
    outer, children = kept[0], kept[1:]
    assert outer.parent is None and outer.ids == {"step": 0}
    for prev, s in zip(children, children[1:]):
        assert prev.end_ns <= s.start_ns
    for s in children:
        assert s.parent == "train.step" and outer.start_ns <= s.start_ns <= s.end_ns <= outer.end_ns
    assert np.isfinite(float(step(batch, gen)["loss"]))          # and nothing kept outside one
    assert len(_since(t0, "train.step")) == 1

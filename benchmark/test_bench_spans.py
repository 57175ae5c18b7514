"""The span metrics on hand-worked traces (CPU): the window, the card's idle
intervals, and each reader's value; a program that keeps no spans gives
none."""

from types import SimpleNamespace

import pytest

from biom3_tpu_torch.utils.profiling import Span
from harness import spans, spec

MS = 1_000_000    # ns


def _trace(device_ops, window_s=0.1, close_us=100_000.0):
    """A trace whose window is [0, close_us] µs; device ops in ms."""
    return SimpleNamespace(
        device_ops=[(n, s * 1e3, e * 1e3) for n, s, e in device_ops],
        host_ops=[("aten::add", 1e3, 2e3), ("cudaDeviceSynchronize", close_us - 50.0, close_us)],
        window_s=window_s)


def _span(name, s_ms, e_ms, **ids):
    return Span(name, "t", int(s_ms * MS), int(e_ms * MS), None, ids)


def _read(name, trace, kept, monkeypatch):
    monkeypatch.setattr(spans, "program_spans", lambda: list(kept))
    return spec.metric_reader(name)(SimpleNamespace(trace=trace, work={}))


def test_window_and_idle_intervals():
    t = _trace([("k", 10, 30), ("k", 20, 40), ("k", 60, 70)])
    win = spans.window_us(t)
    assert win == pytest.approx((0.0, 100_000.0))
    assert spans.idle(t, win) == [(0.0, 10_000.0), (40_000.0, 60_000.0), (70_000.0, 100_000.0)]
    assert spans.idle_under(t, [_span("a", 35, 65), _span("b", 90, 120)], win) == \
        pytest.approx(20_000.0 + 10_000.0)


def test_serve_readers_hand_worked(monkeypatch):
    copy = spans.PINNED_COPY
    t = _trace([("gemm", 5, 30), (copy, 30, 31), ("gemm", 32, 60), (copy, 60, 61),
                ("gemm", 70, 90)])
    kept = [_span("serve.queue", 1, 4, rid=0, did=0), _span("serve.queue", 2, 12, rid=1, did=1),
            _span("serve.queue", 3, 40, rid=2, did=1),
            _span("serve.dispatch", 4, 6, did=0, rows=1, rid=[0]),
            _span("serve.dispatch", 12, 14, did=1, rows=2, rid=[1, 2]),
            _span("serve.collect", 35, 36, did=0, ready=True),     # 4 ms after its copy
            _span("serve.collect", 50, 62, did=1, ready=False),    # waited on the card
            _span("serve.coalesce", 61, 75, rows_start=1, rows_end=2)]
    assert _read("queue_wait_p50_s.serve", t, kept, monkeypatch) == pytest.approx(0.010)
    assert _read("collect_lag_p50_s.serve", t, kept, monkeypatch) == pytest.approx(0.002)
    # idle under the coalesce: [61, 70] ms of a 100 ms window
    assert _read("idle_in_coalesce.serve", t, kept, monkeypatch) == pytest.approx(9.0)


def test_optimizer_idle_per_step_hand_worked(monkeypatch):
    t = _trace([("fwd", 0, 40), ("adam", 45, 50), ("fwd", 52, 92), ("adam", 96, 99)])
    kept = [_span("train.step", 0, 50), _span("train.optimizer", 41, 48),
            _span("train.ema", 48, 51), _span("train.step", 51, 100),
            _span("train.optimizer", 92, 97), _span("train.ema", 97, 99.5)]
    # idle under them: [41, 45] + [50, 51] + [92, 96] + [99, 99.5] = 9.5 ms over 2 steps
    assert _read("optimizer_idle_ms_per_step.train", t, kept, monkeypatch) == \
        pytest.approx(4.75)


@pytest.mark.parametrize("name", ["queue_wait_p50_s.serve", "collect_lag_p50_s.serve",
                                  "idle_in_coalesce.serve",
                                  "optimizer_idle_ms_per_step.train"])
def test_no_spans_or_no_trace_reads_nothing(name, monkeypatch):
    t = _trace([("k", 0, 50)])
    assert _read(name, t, [], monkeypatch) is None
    assert _read(name, None, [_span("serve.queue", 1, 2, rid=0, did=0)], monkeypatch) is None
    monkeypatch.undo()
    monkeypatch.setattr("biom3_tpu_torch.utils.profiling.spans", None)   # a program without them
    assert spans.program_spans() == []

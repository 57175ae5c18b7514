"""The yardstick on the CPU: seeded draws repeat, the roofline and MFU
arithmetic on hand-worked shapes, a cell added as files alone is found by
name, and a measured run without a card fails."""

import json
import pathlib
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from harness import cell, draws, roofline, spec
from traffic import embed, train

HERE = pathlib.Path(__file__).resolve().parent


def test_lengths_are_one_set_in_seed_order():
    mix = {"device_batch": 64, "protein_pad": 1024, "caption_pad": 512,
           "protein_length": {"median": 300, "sigma": 0.6, "low": 30, "high": 1022},
           "caption_length": {"median": 128, "sigma": 0.6, "low": 16, "high": 512}}
    a, b = embed.make_slab(2 ** 40 + 3, 0, mix, 30522), embed.make_slab(2 ** 40 + 3, 0, mix, 30522)
    c = embed.make_slab(17, 0, mix, 30522)
    for key in ("x_p", "x_t", "plen", "clen"):
        assert np.array_equal(a[key], b[key])
    assert np.array_equal(np.sort(a["plen"]), np.sort(c["plen"]))
    assert not np.array_equal(a["plen"], c["plen"])
    assert a["plen"].min() >= 30 and a["plen"].max() <= 1022
    assert np.median(draws.lognormal_lengths(1001, 300, 0.6, 30, 1022)) == 300


def test_train_batches_repeat():
    mix = {"batch": 4, "length": {"median": 20, "sigma": 0.6, "low": 5, "high": 62}}
    dims = {"L": 64, "cond": 8}
    a = train.make_batch(5, 1, mix, dims, "cpu")
    b = train.make_batch(5, 1, mix, dims, "cpu")
    assert torch.equal(a["tokens"], b["tokens"]) and torch.equal(a["z_c"], b["z_c"])
    row = a["tokens"][0]
    n = int(a["lengths"][0])
    assert row[0] == train.START and row[n + 1] == train.END and (row[n + 2:] == train.PAD).all()


def test_gemm_bound_hand_worked():
    w = roofline.gemm(128, 256, 512, int8=False)
    assert w.ops == 2 * 128 * 256 * 512
    nbytes = (128 * 256 + 256 * 512) * 2 + 128 * 512 * 2       # 458,752: bandwidth-bound
    assert w.bound_s == pytest.approx(nbytes / 3.35e12)
    assert roofline.share(w, 2 * w.bound_s) == pytest.approx(50.0)
    big = roofline.gemm(8192, 8192, 8192, int8=True)
    assert big.bound_s == pytest.approx(2 * 8192 ** 3 / 1979e12)   # compute-bound
    assert roofline.share(w, 0.0) is None


def test_attention_and_encoder_counts_hand_worked():
    # 1 row, L 8, d 4, 2 heads of 2 (1 band-local, W 4): band 8·4·2·12 + linear 4·8·2²
    w = roofline.stage3_attention(1, 8, 4, 2, 1, 4, backward=False)
    assert w.ops == 8 * 4 * 2 * 12 + 4 * 8 * 4
    assert roofline.stage3_attention(1, 8, 4, 2, 1, 4, backward=True).ops == 3 * w.ops
    # one layer: k, v on all 3 rows; q, out and the FF on the first
    e = roofline.encoder_gemms(3, 2, 8, 1, int8=True)
    assert e.ops == 2 * 3 * 2 * 4 + 2 * (2 * 2 + 2 * 2 + 2 * 8 + 8 * 2)
    assert roofline.encoder_attention(3, 2, 2).ops == 4 * 9 * 2 + 4 * 3 * 2


def test_mfu_hand_worked():
    assert roofline.mfu(989e12, 2.0) == pytest.approx(50.0)
    assert roofline.mfu(0.0, 2.0) is None


PROBE_KIND = '''
from harness.cell import Outcome, check_le
def run(ctx):
    ctx.work["count"] = ctx.mix["count"]
    return Outcome({"probe_per_s": float(ctx.mix["count"]), "setup_s": 0.5}, attempted=3,
                   failed=0, checks=[check_le("probe_err", 0.0, ctx.mix["limit"])])
'''
PROBE_METRIC = '''
def read(ctx):
    return float(ctx.work["count"]) * 2
'''


def test_cell_added_as_files_is_found_by_name(tmp_path, capsys):
    bench = tmp_path / "benchmark"
    for sub in ("configs", "mixes", "traffic", "metrics"):
        (bench / sub).mkdir(parents=True)
    (bench / "configs" / "cfg-x.json").write_text(json.dumps({"width": 8}))
    (bench / "mixes" / "mix-x.json").write_text(json.dumps({"kind": "probe", "count": 7,
                                                            "limit": 0.1}))
    (bench / "traffic" / "probe.py").write_text(PROBE_KIND)
    (bench / "metrics" / "probe_count.x.py").write_text(PROBE_METRIC)
    (tmp_path / "BENCHMARK.json").write_text(json.dumps({
        "workloads": [{"name": "added", "config": "cfg-x", "traffic": "mix-x", "chips": 1}],
        "end_to_end": [{"name": "probe_per_s", "unit": "x/s", "workloads": ["added"]},
                       {"name": "setup_s", "unit": "s"}],
        "per_layer": [{"name": "probe_count.x", "unit": "1", "moves": "probe_per_s",
                       "workloads": ["added"]}]}))
    c = spec.load_cell("added", root=tmp_path)
    assert c.config == {"width": 8} and c.mix["count"] == 7
    for trace in (False, True):
        assert cell.run("added", 1, 1.0, trace, t_process=time.perf_counter(), device="cpu",
                        root=tmp_path) == 0
        line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert line["correct"] is True
        assert list(line)[-1] == "checks"
        if trace:
            assert line["metrics"] == {"probe_count.x": {"value": 14.0, "unit": "1"}}
        else:
            assert line["metrics"]["probe_per_s"]["value"] == 7.0


def test_measured_run_without_a_card_fails():
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "design-exact",
                          "--seed", str(2 ** 33 + 1), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=HERE.parent)
    assert out.returncode != 0
    assert "{" not in out.stdout
    assert "no card" in out.stderr


def test_arrivals_repeat_and_differ_only_in_order():
    from harness import openloop

    a = openloop.arrival_offsets(draws.rng(9, 7), 4.8, 45.0)
    b = openloop.arrival_offsets(draws.rng(9, 7), 4.8, 45.0)
    c = openloop.arrival_offsets(draws.rng(10, 7), 4.8, 45.0)
    assert np.array_equal(a, b) and len(a) == len(c) == round(4.8 * 45)
    assert a[0] == 0.0 and a[-1] < 45.0 and np.all(np.diff(a) > 0)
    assert np.allclose(np.sort(np.diff(np.append(a, 45.0))), np.sort(np.diff(np.append(c, 45.0))))
    assert not np.array_equal(a, c)


def test_latency_runs_from_the_due_time_and_the_tail_counts_every_request():
    from harness import openloop

    def send(req):
        time.sleep(0.05)
        if req == "bad":
            raise ConnectionError("refused")
        return True, req

    loop = openloop.OpenLoop(send, workers=1)       # one server slot: a queue forms
    start = time.perf_counter() + 0.02
    recs = loop.run(start, [(0.0, i) for i in range(4)] + [(0.0, "bad")])
    lat = [r.latency for r in recs]
    # all five were due at once; each waited for the ones before it
    assert all(abs(r.due - start) < 1e-9 for r in recs)
    for i in range(4):
        assert lat[i] == pytest.approx(0.05 * (i + 1), abs=0.03)
    assert lat[4] == float("inf") and not recs[4].ok
    assert openloop.percentile(lat, 0.95) == float("inf")
    assert openloop.percentile(lat[:4], 0.5) == pytest.approx(0.10, abs=0.03)
    assert openloop.percentile(lat[:4], 1.0) == max(lat[:4])

"""Throughput of the PenCL inference path on one CUDA card.

    python -m biom3_tpu_torch.cli.measure_pencl [--out build/measure_pencl.json]

Full-width towers (ESM2-650M, PubMedBERT-base) with the engine's seeded
random weights, bf16, tanh GELU, the synthetic wordpiece vocab.  Two
protein length mixes: ``demo``, the 5 demo proteins (72-632 residues)
repeated to the batch, and ``full``, random 1022-residue proteins (no PAD
tail); captions are the demo captions repeated.  Measures, and writes as
one JSON object:

* ``esm_tower_ms_{mix}_B{5,16}``: ``fused_esm2_cls`` ms per call, CUDA
  events over ``ITERS`` calls after one warm-up;
* ``bert_ms_{mix}_B16``: the BERT tower and text head (fused-stack path),
  timed the same way;
* ``pencl_pairs_per_sec_{path}_{mix}_B16``: 16 over the median host wall
  time, after a synchronise, of ``WALLS`` warm
  ``PenCLEngine.embed_tokens`` calls, for ``fused-stack`` and ``graph``;
* ``profile_{what}_{mix}_B{B}``: torch.profiler device ms per call,
  summed by kernel group, for the ESM tower and for both paths'
  ``embed_tokens``.

Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from biom3_tpu_torch.cli.run_pencl_inference import DEMO_CAPTIONS, DEMO_SEQUENCES
from biom3_tpu_torch.config import Config
from biom3_tpu_torch.ops.esm2_stack import fused_esm2_cls
from biom3_tpu_torch.pipeline.stage1 import PenCLEngine
from biom3_tpu_torch.tokenizers import write_synthetic_wordpiece

BATCH = 16        # PenCLEngine.embed's batch size
ITERS = 5         # calls per CUDA-event timing
WALLS = 7         # warm calls per wall-time median
RESIDUES = "ACDEFGHIKLMNPQRSTVWY"
# kernel name fragment → profile group (the port's kernels; anything else
# is reported under its own name)
KERNEL_GROUPS = (("gemm_bias_act_wgmma", "gemm_bias_act"), ("gemm_i8_wgmma", "gemm_i8"),
                 ("gemm_dx_wgmma", "gemm_dx"), ("gemm_dw_wgmma", "gemm_dw"),
                 ("esm2_bwd", "esm2_attention_bwd"), ("esm2_attn", "esm2_attention"),
                 ("flash_attn", "flash_attention"),
                 ("dense_attn", "dense_attention"), ("layernorm_bwd", "layernorm_bwd"),
                 ("bias_layernorm", "bias_layernorm"), ("layernorm", "layernorm"),
                 ("esm2_embed", "esm2_embed"),
                 ("quant_rows", "quant_rows"),
                 ("stage3_local_wgmma", "stage3_attention_core"),
                 ("stage3_linear_stats", "stage3_attention_core"),
                 ("stage3_linear_ctx", "stage3_attention_core"),
                 ("stage3_bwd_dq_wgmma", "stage3_attention_bwd"),
                 ("stage3_bwd_dkv_wgmma", "stage3_attention_bwd"),
                 ("lin_bwd", "stage3_attention_bwd"), ("col_sum", "col_sum"),
                 ("local_attn", "local_window_attention"))


def stage1_config(root: pathlib.Path) -> dict:
    """The full-width stage-1 config (ESM2-650M, PubMedBERT-base widths)
    with a synthetic wordpiece vocab under ``root``, also written to
    ``root / "stage1.json"``."""
    vocab = write_synthetic_wordpiece(root / "vocab")
    cfg = {"protein_encoder_embedding": 1280, "text_encoder_embedding": 768,
           "bert_num_layers": 12, "bert_num_heads": 12, "bert_intermediate_size": 3072,
           "bert_vocab_size": vocab, "bert_max_position_embeddings": 512,
           "proj_embedding_dim": 512, "text_max_length": 512,
           "text_model_path": str(root / "vocab")}
    (root / "stage1.json").write_text(json.dumps(cfg))
    return cfg


def event_ms(fn, iters: int) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events after a warm-up."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def wall_s(fn, n: int) -> list[float]:
    """Sorted host wall times of ``n`` warm calls, each ended by a synchronise."""
    fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    return sorted(walls)


def profile_ms(fn, calls: int = 3) -> dict[str, float]:
    """torch.profiler device ms per call of ``fn``, summed by kernel group.
    Only device events count: a host op's device time is that of the
    kernels it launched, which are counted as themselves."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    groups: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CPU:
            continue
        us = ev.self_device_time_total
        if us <= 0:
            continue
        group = next((g for frag, g in KERNEL_GROUPS if frag in ev.key), ev.key[:60])
        groups[group] = groups.get(group, 0.0) + us / calls / 1e3
    return {"device_total": sum(groups.values()),
            **dict(sorted(groups.items(), key=lambda kv: -kv[1]))}


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="PenCL throughput on one CUDA card")
    parser.add_argument("--out", type=str, default="build/measure_pencl.json")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_arguments(argv)
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this measurement needs the card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    res: dict[str, object] = {}

    def say(key: str, value, note: str = "") -> None:
        res[key] = value
        print(f"{key} = {value}{'  ' + note if note else ''}", flush=True)

    with tempfile.TemporaryDirectory(prefix="measure_pencl_") as tmp:
        stage1 = Config(stage1_config(pathlib.Path(tmp)))
        t0 = time.perf_counter()
        engines = {"fused-stack": PenCLEngine(stage1, None, device="cuda", dtype=torch.bfloat16)}
        say("engine_setup_s", time.perf_counter() - t0, "(seeded init, packing the stacks)")
        engines["graph"] = PenCLEngine(stage1, None, device="cuda", dtype=torch.bfloat16,
                                       tower_impl="graph")
        eng = engines["fused-stack"]
        esm = eng.config.esm
        rng = np.random.default_rng(0)
        mixes = {"demo": list(DEMO_SEQUENCES),
                 "full": ["".join(rng.choice(list(RESIDUES), 1022)) for _ in range(BATCH)]}

        def batch(seqs, B):
            """Token ids of B pairs, int32 numpy (what embed_tokens takes)."""
            return eng.tokenize((list(DEMO_CAPTIONS) * B)[:B], (seqs * B)[:B])

        def tower(ids):
            return fused_esm2_cls(ids, **eng._esm_arrays, heads=esm.attention_heads,
                                  gelu=eng.gelu)

        for mix, seqs in mixes.items():
            for B in (5, BATCH):
                ids = eng._ids(batch(seqs, B)[1])
                say(f"esm_tower_ms_{mix}_B{B}", event_ms(lambda: tower(ids), ITERS),
                    f"(non-PAD tokens {int((ids != esm.pad_idx).sum())})")
                say(f"profile_esm_tower_{mix}_B{B}", profile_ms(lambda: tower(ids)))
            x_t, x_p = batch(seqs, BATCH)
            ids_t = eng._ids(x_t)
            say(f"bert_ms_{mix}_B{BATCH}", event_ms(lambda: eng._encode_text(ids_t), ITERS))
            for path, e in engines.items():
                walls = wall_s(lambda: e.embed_tokens(x_t, x_p), WALLS)
                mid = walls[len(walls) // 2]
                say(f"pencl_pairs_per_sec_{path}_{mix}_B{BATCH}", BATCH / mid,
                    f"(median {mid * 1e3:.3f} ms, min {walls[0] * 1e3:.3f}, "
                    f"max {walls[-1] * 1e3:.3f} over {WALLS})")
        x_t, x_p = batch(mixes["demo"], BATCH)
        for path, e in engines.items():
            say(f"profile_embed_tokens_{path}_demo_B{BATCH}",
                profile_ms(lambda: e.embed_tokens(x_t, x_p)))
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1) + "\n")
    return res


if __name__ == "__main__":
    main()

#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``biom3_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the kernels from ``biom3_tpu_torch/csrc`` (seconds);
3. every kernel against its plain PyTorch version on the card at full
   width (Stage 3: L=1024, d=512, 8+8 heads, FF 2048; BERT: L=512, E=768,
   12 heads, FF 3072; ESM2-650M: L=1024, E=1280, 20 heads, FF 5120),
   timed at Stage-3 B=4 / BERT B=2 / ESM B=2 and checked also at the
   batches phase 5 gives them (2 replicas of 1 prompt), at phase 6's ESM
   batch (the 5 demo proteins) and on edge shapes (ragged tiles, ragged
   PAD tails, an all-PAD row): bf16 max|Δ|/max|ref| <= 2e-2, with both
   times;
4. full-width ``fused_stack_logits`` on the kernels (bf16, tanh GELU)
   against the plain f32 ProteoScribe, the full-width BERT tower and
   ``fused_esm2_cls`` against the plain f32 towers, and the PenCL graph
   path (bf16, the flash kernel) against the plain f32 PenCL: min cosine
   >= 0.999;
5. the text→protein CLI (``biom3_tpu_torch.cli.run_e2e``) at full width on
   seeded random weights: 1 prompt, 2 replicas, exact mode (1024 denoise
   steps); checks the sequences;
6. the PenCL CLI (``biom3_tpu_torch.cli.run_pencl_inference``) at full
   width on seeded random weights in the published ``.bin`` layout (LM,
   contact and MLM heads and buffers included): the 5 demo pairs; checks
   the latents and scores; then ``PenCLEngine(tower_impl="graph")`` on the
   same file.

Each of the three paths (phase 5, the CLI of phase 6, the graph engine of
phase 6) runs with the launch counts set to 0 just before it and read just
after, and must have launched exactly its own kernels.  The line before
the last is the kernels' JSON record, the last ``{"ok": true, "device":
{...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import tempfile
import time

import numpy as np

REL_TOL = 2e-2     # bf16 kernel vs plain version, max|Δ| / max|ref|
COS_MIN = 0.999    # drift gate of the serving modes (PARITY.md)
SEED = 0
TIMED_ITERS = 20   # calls per kernel timing
ESM_LAYERS, BERT_LAYERS = 33, 12

# kernel → (source, TPU kernel it replaces)
KERNEL_SOURCES = {
    "gemm_bias_act": ("biom3_tpu_torch/csrc/gemm_bf16.cu",
                      "biom3_tpu/ops/pallas/stack_kernel_tpu.py:765"),
    "stage3_attention_core": ("biom3_tpu_torch/csrc/stage3_attn.cu",
                              "biom3_tpu/ops/pallas/fused_layer_tpu.py:186"),
    "dense_attention": ("biom3_tpu_torch/csrc/dense_attn.cu",
                        "biom3_tpu/ops/pallas/bert_stack_tpu.py:198"),
    "bias_layernorm": ("biom3_tpu_torch/csrc/rowwise.cu",
                       "biom3_tpu/ops/pallas/fused_layer_tpu.py:186"),
    "layernorm": ("biom3_tpu_torch/csrc/rowwise.cu",
                  "biom3_tpu/ops/pallas/fused_layer_tpu.py:269"),
    "embed_tokens": ("biom3_tpu_torch/csrc/rowwise.cu",
                     "biom3_tpu/ops/pallas/stack_kernel_tpu.py:765"),
    "gather_head": ("biom3_tpu_torch/csrc/rowwise.cu",
                    "biom3_tpu/ops/pallas/stack_kernel_tpu.py:765"),
    "esm2_embed": ("biom3_tpu_torch/csrc/rowwise.cu",
                   "biom3_tpu/ops/pallas/esm2_stack_tpu.py:294"),
    "esm2_attention": ("biom3_tpu_torch/csrc/esm2_attn.cu",
                       "biom3_tpu/ops/pallas/esm2_stack_tpu.py:294"),
    "flash_attention": ("biom3_tpu_torch/csrc/flash_attn.cu",
                        "biom3_tpu/ops/pallas/flash_attention_tpu.py:69"),
}

# path → the kernels it launches, and no other
PATH_KERNELS = {
    "e2e": {"gemm_bias_act", "stage3_attention_core", "dense_attention", "bias_layernorm",
            "layernorm", "embed_tokens", "gather_head"},
    "pencl": {"gemm_bias_act", "dense_attention", "layernorm", "esm2_embed", "esm2_attention"},
    "pencl_graph": {"flash_attention"},
}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def rel_err(got, want) -> tuple[float, float]:
    """(max|Δ|, max|Δ| / max|ref|) in f32."""
    got, want = got.float(), want.float()
    if not bool(got.isfinite().all()):
        raise AssertionError("kernel output has non-finite values")
    diff = float((got - want).abs().max())
    return diff, diff / max(float(want.abs().max()), 1e-30)


def min_cosine(a, b) -> float:
    import torch

    return float(torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1).min())


# --------------------------------------------------------------------------
# phase 1-2
# --------------------------------------------------------------------------

def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke test needs the card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
                  f"python {sys.version.split()[0]} count {torch.cuda.device_count()}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


def phase_build() -> None:
    from biom3_tpu_torch.ops import _build

    info = _build.build(force=True)
    _build.library()
    say("build", f"nvcc built {_build.LIB_PATH.name} in {info['seconds']:.1f} s "
                 f"(per-kernel registers and spills: {_build.PTXAS_REPORT})")


# --------------------------------------------------------------------------
# phase 3: kernels vs plain versions at full shapes
# --------------------------------------------------------------------------

def esm_ids(lengths, L: int, g):
    """(len(lengths), L) int32 ESM tokens: <cls>, residues, <eos>, then a
    PAD tail to L; one <mask> in row 0."""
    import torch

    ids = torch.ones((len(lengths), L), dtype=torch.int32, device=g.device)
    for b, n in enumerate(lengths):
        ids[b, 1:n - 1] = torch.randint(4, 24, (n - 2,), generator=g, device=g.device,
                                        dtype=torch.int32)
        ids[b, 0], ids[b, n - 1] = 0, 2
    ids[0, 5] = 32
    return ids


def kernel_cases(B: int, Bb: int, esm_lengths, g) -> dict[str, list]:
    """Kernel → [(kernel call, plain call), ...] at full width, Stage-3 batch
    B (L 1024, d 512, 8 + 8 heads, W 128, FF 2048), BERT batch Bb (L 512,
    E 768, 12 heads, FF 3072) and one ESM2-650M row (L 1024, E 1280, 20
    heads, FF 5120) of each length in ``esm_lengths`` (the rest PAD).  The
    first four GEMMs are one Stage-3 layer's products, then BERT's and
    ESM's; every other kernel's first call is its Stage-3 call
    (``dense_attention``: its BERT call; the ESM kernels and
    ``flash_attention``: their ESM-width call)."""
    import torch

    from biom3_tpu_torch.ops import kernels as K
    from biom3_tpu_torch.ops.rotary import rotary_cos_sin

    dev, bf, f32 = g.device, torch.bfloat16, torch.float32
    L, d, H, NL, W, FF = 1024, 512, 16, 8, 128, 2048
    Lb, E, Hb, FFb = 512, 768, 12, 3072
    Ee, He, FFe = 1280, 20, 5120
    Be = len(esm_lengths)

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def vec(n, base=0.0, scale=0.1):
        return (base + scale * torch.randn(n, generator=g, device=dev)).float()

    def pair(name, *args, **kw):
        return (lambda: getattr(K, name)(*args, **kw),
                lambda: getattr(K, name + "_plain")(*args, **kw))

    x, xf, mid = rnd(B * L, d), rnd(B * L, d, dtype=f32), rnd(B * L, FF)
    xb = rnd(Bb * Lb, E)
    h, s, t = rnd(B, L, d), vec(d, 1.0), vec(d)
    ids = esm_ids(esm_lengths, L, g)
    pad = (ids == 1).int()
    cos, sin = rotary_cos_sin(L, Ee // He, dtype=bf, device=dev)
    xe = rnd(Be * L, Ee)
    return {
        "gemm_bias_act": [
            pair("gemm_bias_act", x, rnd(d, 3 * d, scale=d ** -0.5)),
            pair("gemm_bias_act", x, rnd(d, d, scale=d ** -0.5), vec(d), residual=xf,
                 out_dtype=f32),
            pair("gemm_bias_act", x, rnd(d, FF, scale=d ** -0.5), vec(FF), act="tanh"),
            pair("gemm_bias_act", mid, rnd(FF, d, scale=FF ** -0.5), vec(d), residual=xf),
            pair("gemm_bias_act", xb, rnd(E, 3 * E, scale=E ** -0.5), vec(3 * E)),
            pair("gemm_bias_act", xb, rnd(E, FFb, scale=E ** -0.5), vec(FFb), act="tanh"),
            pair("gemm_bias_act", rnd(Bb * Lb, FFb), rnd(FFb, E, scale=FFb ** -0.5), vec(E),
                 residual=xb, out_dtype=f32),
            pair("gemm_bias_act", xe, rnd(Ee, 3 * Ee, scale=Ee ** -0.5), vec(3 * Ee)),
            pair("gemm_bias_act", xe, rnd(Ee, FFe, scale=Ee ** -0.5), vec(FFe), act="tanh"),
            pair("gemm_bias_act", rnd(Be * L, FFe), rnd(FFe, Ee, scale=FFe ** -0.5), vec(Ee),
                 residual=rnd(Be * L, Ee, dtype=f32)),
        ],
        "stage3_attention_core": [
            pair("stage3_attention_core", rnd(B, L, 3 * d), heads=H, local_heads=NL, window=W)],
        "dense_attention": [pair("dense_attention", rnd(Bb, Lb, 3 * E), heads=Hb)],
        "bias_layernorm": [pair("bias_layernorm", h, rnd(B, d), s, t)],
        "layernorm": [
            pair("layernorm", xf, s, t, eps=1e-6, out_dtype=bf),
            pair("layernorm", rnd(Bb * Lb, E, dtype=f32, scale=3.0), vec(E, 1.0), vec(E),
                 eps=1e-12, out_dtype=bf, want_f32=True),
            # ESM2: LN1 on the bf16 residual, LN2 on the f32 one, the final
            # norm on the bf16 CLS rows with the f32 copy
            pair("layernorm", rnd(Be * L, Ee, scale=3.0), vec(Ee, 1.0), vec(Ee), eps=1e-5,
                 out_dtype=bf),
            pair("layernorm", rnd(Be * L, Ee, dtype=f32, scale=3.0), vec(Ee, 1.0), vec(Ee),
                 eps=1e-5, out_dtype=bf),
            pair("layernorm", rnd(Be, Ee, scale=3.0), vec(Ee, 1.0), vec(Ee), eps=1e-5,
                 out_dtype=bf, want_f32=True),
        ],
        "embed_tokens": [pair("embed_tokens",
                              torch.randint(0, 29, (B, L), generator=g, device=dev,
                                            dtype=torch.int32), rnd(29, d), rnd(L, d))],
        "gather_head": [pair("gather_head", h,
                             torch.randint(0, L, (B, k), generator=g, device=dev,
                                           dtype=torch.int32),
                             s, t, rnd(d, 29, scale=d ** -0.5), vec(29))
                        for k in (1, 8)],
        "esm2_embed": [pair("esm2_embed", ids, rnd(33, Ee))],
        "esm2_attention": [pair("esm2_attention", rnd(Be, L, 3 * Ee), pad, cos, sin,
                                heads=He)],
        "flash_attention": [
            pair("flash_attention", *(rnd(Be, He, L, Ee // He) for _ in range(3)), pad),
            pair("flash_attention", *(rnd(Bb, Hb, Lb, E // Hb) for _ in range(3))),
        ],
    }


def edge_cases(g) -> dict[str, list]:
    """Shapes off the main path that the kernels' tiling must still get
    right: a GEMM with M, N, K off the 128x128x32 tile, a smaller window,
    a length (1000) that leaves ragged query and key tiles, ragged PAD
    tails down to a 3-token protein, an all-PAD row, head dim 32, bf16
    LayerNorm rows off the 8-row block and a width off the 256-column
    stride."""
    import torch

    from biom3_tpu_torch.ops import kernels as K
    from biom3_tpu_torch.ops.rotary import rotary_cos_sin

    dev, bf = g.device, torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    a, w, r = rnd(1000, 264), rnd(264, 200, scale=264 ** -0.5), rnd(1000, 200)
    bias = 0.1 * torch.randn(200, generator=g, device=dev)
    q3, qd = rnd(2, 256, 1536), rnd(3, 200, 2304)
    kw = dict(act="erf", residual=r, out_dtype=torch.float32)
    Le = 1000
    ids = esm_ids([Le, 517, 3], Le, g)
    ids[2, 1:] = 1                                   # <cls> then PAD only
    pad = (ids == 1).int()
    mask = (torch.rand(3, Le, generator=g, device=dev) < 0.25).int()
    mask[1] = 1                                      # every key PAD
    mask[2, 700:] = 1
    cos, sin = rotary_cos_sin(Le, 64, dtype=bf, device=dev)
    qe, table = rnd(3, Le, 768), rnd(33, 1280)
    fl = [rnd(3, 4, Le, 64) for _ in range(3)]
    fl32 = [rnd(2, 3, 130, 32) for _ in range(3)]      # head dim 32, no mask
    # bf16 rows off the 8-row block and d off the warp's 256-column stride
    xl = rnd(1003, 264, scale=3.0)
    ln = (1.0 + 0.1 * torch.randn(264, generator=g, device=dev),
          0.1 * torch.randn(264, generator=g, device=dev))
    return {
        "gemm_bias_act": [(lambda: K.gemm_bias_act(a, w, bias, **kw),
                           lambda: K.gemm_bias_act_plain(a, w, bias, **kw))],
        "stage3_attention_core": [
            (lambda: K.stage3_attention_core(q3, heads=16, local_heads=8, window=64),
             lambda: K.stage3_attention_core_plain(q3, heads=16, local_heads=8, window=64))],
        "dense_attention": [(lambda: K.dense_attention(qd, heads=12),
                             lambda: K.dense_attention_plain(qd, heads=12))],
        "layernorm": [(lambda: K.layernorm(xl, *ln, eps=1e-5, out_dtype=bf, want_f32=True),
                       lambda: K.layernorm_plain(xl, *ln, eps=1e-5, out_dtype=bf,
                                                 want_f32=True))],
        "esm2_embed": [(lambda: K.esm2_embed(ids, table),
                        lambda: K.esm2_embed_plain(ids, table))],
        "esm2_attention": [(lambda: K.esm2_attention(qe, pad, cos, sin, heads=4),
                            lambda: K.esm2_attention_plain(qe, pad, cos, sin, heads=4))],
        "flash_attention": [(lambda: K.flash_attention(*fl, mask),
                             lambda: K.flash_attention_plain(*fl, mask)),
                            (lambda: K.flash_attention(*fl32),
                             lambda: K.flash_attention_plain(*fl32))],
    }


def phase_kernels() -> dict:
    import torch

    from biom3_tpu_torch.cli.measure_pencl import event_ms
    from biom3_tpu_torch.cli.run_pencl_inference import DEMO_SEQUENCES

    g = torch.Generator(device="cuda").manual_seed(SEED)
    # timed: the check shapes (Stage 3 B=4, BERT B=2, ESM B=2 with one
    # full-length and one PAD-tailed row); also checked: the shapes phase
    # 5's run gives the kernels (2 replicas, 1 prompt), phase 6's ESM batch
    # (the 5 demo proteins) and the edge cases
    timed = kernel_cases(4, 2, [1024, 400], g)
    demo = [len(seq) + 2 for seq in DEMO_SEQUENCES]
    checked = [timed, kernel_cases(2, 1, demo, g), edge_cases(g)]
    n_timed = {"gemm_bias_act": 4}     # one Stage-3 layer's four products

    results = {}
    for name, calls in timed.items():
        worst_abs, worst_rel = 0.0, 0.0
        for run, plain in (c for cases in checked for c in cases.get(name, [])):
            got, want = run(), plain()
            torch.cuda.synchronize()
            pairs = zip(got, want) if isinstance(got, tuple) else [(got, want)]
            for a, b in pairs:
                err_abs, err_rel = rel_err(a, b)
                worst_abs, worst_rel = max(worst_abs, err_abs), max(worst_rel, err_rel)
        if worst_rel > REL_TOL:
            raise AssertionError(f"{name}: max|Δ|/max|ref| = {worst_rel:.3e} > {REL_TOL}")
        calls = calls[:n_timed.get(name, 1)]
        ms = event_ms(lambda: [run() for run, _ in calls], TIMED_ITERS)
        plain_ms = event_ms(lambda: [plain() for _, plain in calls], TIMED_ITERS)
        results[name] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms}
        say("kernels", f"{name}: max|Δ| {worst_abs:.3e} rel {worst_rel:.3e} "
                       f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    return results


# --------------------------------------------------------------------------
# phase 4: full-width forwards on the kernels vs the plain f32 modules
# --------------------------------------------------------------------------

def phase_models(pencl) -> None:
    """``pencl``: the seeded full-width f32 PenCL (tanh GELU) on the host;
    it is back there when this returns."""
    import torch

    from biom3_tpu_torch.config import BertConfig, ProteoScribeConfig
    from biom3_tpu_torch.io.state_dict import seeded_init_
    from biom3_tpu_torch.models.bert import BertEncoder
    from biom3_tpu_torch.models.fused_forward import make_stack_apply
    from biom3_tpu_torch.models.pencl import PenCL
    from biom3_tpu_torch.models.proteoscribe import ProteoScribe
    from biom3_tpu_torch.ops.bert_stack import bert_embed, bert_stack_arrays, fused_bert_cls
    from biom3_tpu_torch.ops.esm2_stack import esm2_stack_arrays, fused_esm2_cls

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    cfg = ProteoScribeConfig()
    model = seeded_init_(ProteoScribe(cfg), SEED).to(dev).eval()
    B, k = 4, 8
    ids = torch.randint(0, cfg.num_classes, (B, cfg.max_seq_len), generator=g, device=dev)
    ids = ids * (torch.rand(ids.shape, generator=g, device=dev) < 0.5)   # half absorbing
    t = torch.randint(0, cfg.num_timesteps, (B,), generator=g, device=dev)
    z = torch.randn((B, cfg.cond_dim), generator=g, device=dev)
    pos = torch.randint(0, cfg.max_seq_len, (B, k), generator=g, device=dev)
    with torch.no_grad():
        ref = model(ids, t, z)
        want = torch.gather(ref, 1, pos[..., None].expand(-1, -1, ref.shape[-1]))
        got = make_stack_apply(model, dtype=torch.bfloat16, gelu="tanh")(ids, t, z, pos)
    torch.cuda.synchronize()
    cos = min_cosine(got, want)
    say("models", f"fused_stack_logits (B={B}, k={k}, bf16, tanh) vs plain f32: "
                  f"min logit cosine {cos:.6f}, max|Δ| {float((got - want).abs().max()):.3e}")
    if cos < COS_MIN:
        raise AssertionError(f"stack logit cosine {cos} < {COS_MIN}")

    bcfg = BertConfig(vocab_size=30522)
    bert = seeded_init_(BertEncoder(bcfg), SEED).to(dev).eval()
    x_ids = torch.randint(0, bcfg.vocab_size, (2, 512), generator=g, device=dev)
    with torch.no_grad():
        want = bert(x_ids)["hidden"][:, 0]
        x0 = bert_embed(bert, x_ids, dtype=torch.bfloat16)
        got = fused_bert_cls(x0, **bert_stack_arrays(bert, torch.bfloat16),
                             heads=bcfg.num_heads, gelu="tanh")
    torch.cuda.synchronize()
    cos = min_cosine(got, want)
    say("models", f"fused_bert_cls (B=2, L=512, bf16, tanh) vs plain f32 tower: "
                  f"min CLS cosine {cos:.6f}")
    if cos < COS_MIN:
        raise AssertionError(f"BERT CLS cosine {cos} < {COS_MIN}")
    del model, bert

    ref = pencl.to(dev)
    ecfg = ref.config.esm
    x_p = esm_ids([1024, 400], 1024, g)
    with torch.no_grad():
        want = ref.esm(x_p)["hidden"][:, 0]
        got = fused_esm2_cls(x_p, **esm2_stack_arrays(ref.esm, torch.bfloat16),
                             heads=ecfg.attention_heads, gelu="tanh")
    torch.cuda.synchronize()
    cos = min_cosine(got, want)
    say("models", f"fused_esm2_cls (B=2, L=1024, lengths 1024/400, bf16, tanh) vs plain f32 "
                  f"tower: min CLS cosine {cos:.6f}")
    if cos < COS_MIN:
        raise AssertionError(f"ESM2 CLS cosine {cos} < {COS_MIN}")

    with torch.device(dev):
        graph = PenCL(ref.config, attn_impl="kernel", gelu="tanh")
    graph.load_state_dict(ref.state_dict())
    graph = graph.to(torch.bfloat16).eval()
    x_t = torch.randint(0, ref.config.bert.vocab_size, (2, 512), generator=g, device=dev)
    with torch.no_grad():
        want, got = ref(x_t, x_p), graph(x_t, x_p)
    torch.cuda.synchronize()
    cos = min(min_cosine(got[key], want[key]) for key in want)
    say("models", f"PenCL graph path (B=2, attn_impl=kernel, bf16) vs plain f32 PenCL: "
                  f"min latent cosine {cos:.6f}")
    if cos < COS_MIN:
        raise AssertionError(f"PenCL graph latent cosine {cos} < {COS_MIN}")
    del graph, want, got
    pencl.cpu()
    torch.cuda.empty_cache()


def check_path(path: str, counts: dict) -> None:
    """The path launched every kernel of its own and no other."""
    launched = {name for name, n in counts.items() if n}
    if launched != PATH_KERNELS[path]:
        raise AssertionError(f"{path}: launched {sorted(launched)}, expected "
                             f"{sorted(PATH_KERNELS[path])} ({counts})")


# --------------------------------------------------------------------------
# phase 5: the text→protein CLI at full width
# --------------------------------------------------------------------------

VALID = set("ACDEFGHIKLMNPQRSTVWY" "XUZBO" "-")


def write_stage_files(root: pathlib.Path) -> dict:
    """Seeded random full-width weights in the reference .bin layouts, the
    three stage configs and a synthetic wordpiece vocab → CLI flags."""
    import torch

    from biom3_tpu_torch.cli.measure_pencl import stage1_config

    from biom3_tpu_torch.config import Config, FacilitatorConfig, PenCLConfig, ProteoScribeConfig
    from biom3_tpu_torch.io.state_dict import seeded_init_
    from biom3_tpu_torch.models.facilitator import Facilitator
    from biom3_tpu_torch.models.pencl import PenCLText
    from biom3_tpu_torch.models.proteoscribe import ProteoScribe

    stage = {
        1: stage1_config(root),
        2: {"emb_dim": 512, "hid_dim": 1024, "dropout": 0.0},
        3: {"num_replicas": 2, "batch_size_sample": 32, "diffusion_steps": 1024,
            "num_classes": 29, "text_emb_dim": 512, "transformer_dim": 512,
            "transformer_heads": 16, "transformer_depth": 16, "transformer_blocks": 1,
            "transformer_local_heads": 8, "transformer_local_size": 128},
    }
    models = {
        1: PenCLText(PenCLConfig.from_stage_config(Config(stage[1]))),
        2: Facilitator(FacilitatorConfig.from_stage_config(Config(stage[2]))),
        3: ProteoScribe(ProteoScribeConfig.from_stage_config(Config(stage[3]))),
    }
    flags = []
    for n in (1, 2, 3):
        (root / f"stage{n}.json").write_text(json.dumps(stage[n]))
        torch.save(seeded_init_(models[n], SEED + n).state_dict(), root / f"stage{n}.bin")
        flags += [f"--stage{n}_json", str(root / f"stage{n}.json"),
                  f"--stage{n}_model", str(root / f"stage{n}.bin")]
    return {"flags": flags, "depth": stage[3]["transformer_depth"],
            "steps": stage[3]["diffusion_steps"]}


def phase_e2e() -> dict:
    import torch

    from biom3_tpu_torch.cli import run_e2e
    from biom3_tpu_torch.ops import kernels as K

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = pathlib.Path(tmp)
        files = write_stage_files(root)
        (root / "prompts.txt").write_text(
            "PROTEIN NAME: kinase. FUNCTION: catalyzes transport with atp binding activity\n")
        out = root / "e2e.pt"
        K.reset_launches()
        t0 = time.perf_counter()
        run_e2e.main([*files["flags"], "--prompts", str(root / "prompts.txt"),
                      "--output_path", str(out), "--device", "cuda", "--num_replicas", "2",
                      "--positions_per_step", "1", "--seed", str(SEED)])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = K.launch_counts()
        saved = torch.load(out, weights_only=False)

    z_t, z_c = np.asarray(saved["z_t"]), np.asarray(saved["z_c"])
    if z_t.shape != (1, 512) or z_c.shape != (1, 512):
        raise AssertionError(f"z_t {z_t.shape}, z_c {z_c.shape}: expected (1, 512)")
    if not (np.isfinite(z_t).all() and np.isfinite(z_c).all()):
        raise AssertionError("non-finite z_t / z_c")
    seqs = [s for rep in saved["sequences"].values() for s in rep]
    if len(seqs) != 2:
        raise AssertionError(f"expected 2 sequences, got {len(seqs)}")
    for s in seqs:
        if not 0 < len(s) <= 1024 or set(s) - VALID:
            raise AssertionError(f"invalid sequence (len {len(s)}): {s[:80]!r}")
    if seqs[0] == seqs[1]:
        raise AssertionError("the two replicas are identical")
    check_path("e2e", counts)
    forwards = files["steps"]          # exact mode: one forward per step, one batch
    if counts["stage3_attention_core"] != files["depth"] * forwards:
        raise AssertionError(f"stage3_attention_core launched "
                             f"{counts['stage3_attention_core']} times, expected "
                             f"{files['depth']} x {forwards}")
    say("e2e", f"1 prompt x 2 replicas, exact mode ({forwards} steps): {wall:.2f} s wall; "
               f"lengths {[len(s) for s in seqs]}; launches {counts}")
    return counts


# --------------------------------------------------------------------------
# phase 6: the PenCL CLI at full width, then the graph path
# --------------------------------------------------------------------------

def seeded_pencl(stage1: dict):
    """The full-width PenCL of ``stage1`` with seeded random weights, f32 on
    the host, plain attention and tanh GELU (the reference of phase 4)."""
    from biom3_tpu_torch.config import Config, PenCLConfig
    from biom3_tpu_torch.io.state_dict import seeded_init_
    from biom3_tpu_torch.models.pencl import PenCL

    cfg = PenCLConfig.from_stage_config(Config(stage1))
    return seeded_init_(PenCL(cfg, gelu="tanh"), SEED + 4).eval()


def reference_only_keys(sd: dict, cfg) -> dict:
    """What a published PenCL ``.bin`` holds beyond the inference model, at
    its shapes: fair-esm's LM head (weight tied to embed_tokens), contact
    head and rotary buffers, BERT's MLM head and HF's position_ids."""
    import torch

    esm, bert = cfg.esm, cfg.bert
    E, Eb, Vb = esm.embed_dim, bert.hidden_size, bert.vocab_size
    pe, te = "protein_encoder.model.", "text_encoder.model."
    z = torch.zeros
    out = {pe + "lm_head.weight": sd[pe + "embed_tokens.weight"],
           pe + "lm_head.bias": z(esm.vocab_size),
           pe + "lm_head.dense.weight": z(E, E), pe + "lm_head.dense.bias": z(E),
           pe + "lm_head.layer_norm.weight": torch.ones(E), pe + "lm_head.layer_norm.bias": z(E),
           pe + "contact_head.regression.weight": z(1, esm.num_layers * esm.attention_heads),
           pe + "contact_head.regression.bias": z(1),
           te + "cls.predictions.bias": z(Vb),
           te + "cls.predictions.transform.dense.weight": z(Eb, Eb),
           te + "cls.predictions.transform.dense.bias": z(Eb),
           te + "cls.predictions.transform.LayerNorm.weight": torch.ones(Eb),
           te + "cls.predictions.transform.LayerNorm.bias": z(Eb),
           te + "cls.predictions.decoder.weight": z(Vb, Eb),
           te + "cls.predictions.decoder.bias": z(Vb),
           te + "bert.embeddings.position_ids": torch.arange(bert.max_position_embeddings)[None]}
    inv_freq = 1.0 / 10000 ** (torch.arange(0, esm.head_dim, 2).float() / esm.head_dim)
    out.update({f"{pe}layers.{i}.self_attn.rot_emb.inv_freq": inv_freq
                for i in range(esm.num_layers)})
    return out


def phase_pencl(root: pathlib.Path, stage1: dict, pencl) -> dict:
    """The 5 demo pairs through ``run_pencl_inference`` (fused-stack path),
    then through ``PenCLEngine(tower_impl="graph")``, on one seeded
    full-width ``.bin`` → each path's launch counts."""
    import torch

    from biom3_tpu_torch.cli import run_pencl_inference as cli
    from biom3_tpu_torch.config import Config
    from biom3_tpu_torch.ops import kernels as K
    from biom3_tpu_torch.pipeline.stage1 import PenCLEngine, compute_scores

    sd = pencl.state_dict()
    torch.save({**sd, **reference_only_keys(sd, pencl.config)}, root / "pencl.bin")
    out = root / "pencl.pt"
    K.reset_launches()
    t0 = time.perf_counter()
    cli.main(["--json_path", str(root / "stage1.json"), "--model_path", str(root / "pencl.bin"),
              "--output_path", str(out), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"pencl": K.launch_counts()}
    saved = torch.load(out, weights_only=False)

    n = len(cli.DEMO_SEQUENCES)
    batches = -(-n // 16)                       # PenCLEngine.embed's batch_size
    z_t, z_p = (torch.as_tensor(np.asarray(saved[key])) for key in ("z_t", "z_p"))
    if z_t.shape != (n, 512) or z_p.shape != (n, 512):
        raise AssertionError(f"z_t {tuple(z_t.shape)}, z_p {tuple(z_p.shape)}: "
                             f"expected ({n}, 512)")
    if not (z_t.isfinite().all() and z_p.isfinite().all()):
        raise AssertionError("non-finite z_t / z_p")
    scores = compute_scores(z_p, z_t)
    ones = torch.ones(n)
    for key, dim in (("protein_given_text_probs", 0), ("text_given_protein_probs", 1)):
        if not torch.allclose(scores[key].sum(dim), ones, atol=1e-5):
            raise AssertionError(f"{key} does not sum to 1 along axis {dim}")
    if not torch.allclose(scores["homology_matrix"].diagonal(), ones, atol=1e-5):
        raise AssertionError("the homology diagonal is not 1")
    check_path("pencl", counts["pencl"])
    expected = {"esm2_attention": ESM_LAYERS * batches, "dense_attention": BERT_LAYERS * batches,
                "esm2_embed": batches}
    for name, want in expected.items():
        if counts["pencl"][name] != want:
            raise AssertionError(f"{name} launched {counts['pencl'][name]} times, expected {want}")
    say("pencl", f"run_pencl_inference, {n} demo pairs: {wall:.2f} s wall (set-up included); "
                 f"launches {counts['pencl']}")

    engine = PenCLEngine(Config(stage1), str(root / "pencl.bin"), device="cuda",
                         tower_impl="graph")
    K.reset_launches()
    t0 = time.perf_counter()
    g_t, g_p = engine.embed(cli.DEMO_CAPTIONS, cli.DEMO_SEQUENCES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["pencl_graph"] = K.launch_counts()
    del engine
    torch.cuda.empty_cache()
    check_path("pencl_graph", counts["pencl_graph"])
    want = (ESM_LAYERS + BERT_LAYERS) * batches
    if counts["pencl_graph"]["flash_attention"] != want:
        raise AssertionError(f"flash_attention launched {counts['pencl_graph']['flash_attention']} "
                             f"times, expected {want}")
    cos = min(min_cosine(torch.as_tensor(g_t), z_t), min_cosine(torch.as_tensor(g_p), z_p))
    say("pencl", f"graph path (PenCLEngine tower_impl=graph), {n} demo pairs: {wall:.2f} s wall; "
                 f"min latent cosine vs the CLI's fused-stack latents {cos:.6f}")
    if cos < COS_MIN:
        raise AssertionError(f"graph vs fused-stack latent cosine {cos} < {COS_MIN}")
    return counts


def main() -> None:
    device = phase_device()
    phase_build()
    measured = phase_kernels()
    from biom3_tpu_torch.cli.measure_pencl import stage1_config

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = pathlib.Path(tmp)
        stage1 = stage1_config(root)
        pencl = seeded_pencl(stage1)
        phase_models(pencl)
        counts = {"e2e": phase_e2e()}
        counts.update(phase_pencl(root, stage1, pencl))
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
         "replaces": KERNEL_SOURCES[name][1],
         "launches": sum(c[name] for c in counts.values()), **measured[name]}
        for name in KERNEL_SOURCES
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()

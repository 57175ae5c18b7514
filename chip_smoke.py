#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``biom3_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the kernels from ``biom3_tpu_torch/csrc`` (seconds);
3. every kernel against its plain PyTorch version on the card at full
   width (Stage 3: L=1024, d=512, 8+8 heads, FF 2048; BERT: L=512, E=768,
   12 heads, FF 3072), timed at Stage-3 B=4 / BERT B=2 and checked also
   at the batches phase 5 gives them (2 replicas, 1 prompt) and on ragged
   edge shapes: bf16 max|Δ|/max|ref| <= 2e-2, with both times;
4. full-width ``fused_stack_logits`` on the kernels (bf16, tanh GELU)
   against the plain f32 ProteoScribe, and the full-width BERT tower
   against the plain f32 tower: min cosine >= 0.999;
5. the text→protein CLI (``biom3_tpu_torch.cli.run_e2e``) at full width on
   seeded random weights: 1 prompt, 2 replicas, exact mode (1024 denoise
   steps); checks the sequences and that every kernel launched.

The line before the last is the kernels' JSON record, the last
``{"ok": true, "device": {...}}``.  Imports nothing of JAX.
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
}


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def cuda_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events after a warm-up."""
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


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

def kernel_cases(B: int, Bb: int, g) -> dict[str, list]:
    """Kernel → [(kernel call, plain call), ...] at full width, Stage-3 batch
    B (L 1024, d 512, 8 + 8 heads, W 128, FF 2048) and BERT batch Bb (L 512,
    E 768, 12 heads, FF 3072).  The first four GEMMs are one Stage-3
    layer's products, then BERT's; every other kernel's first call is its
    Stage-3 call (``dense_attention``: its BERT call)."""
    import torch

    from biom3_tpu_torch.ops import kernels as K

    dev, bf, f32 = g.device, torch.bfloat16, torch.float32
    L, d, H, NL, W, FF = 1024, 512, 16, 8, 128, 2048
    Lb, E, Hb, FFb = 512, 768, 12, 3072

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
        ],
        "stage3_attention_core": [
            pair("stage3_attention_core", rnd(B, L, 3 * d), heads=H, local_heads=NL, window=W)],
        "dense_attention": [pair("dense_attention", rnd(Bb, Lb, 3 * E), heads=Hb)],
        "bias_layernorm": [pair("bias_layernorm", h, rnd(B, d), s, t)],
        "layernorm": [
            pair("layernorm", xf, s, t, eps=1e-6, out_dtype=bf),
            pair("layernorm", rnd(Bb * Lb, E, dtype=f32, scale=3.0), vec(E, 1.0), vec(E),
                 eps=1e-12, out_dtype=bf, want_f32=True),
        ],
        "embed_tokens": [pair("embed_tokens",
                              torch.randint(0, 29, (B, L), generator=g, device=dev,
                                            dtype=torch.int32), rnd(29, d), rnd(L, d))],
        "gather_head": [pair("gather_head", h,
                             torch.randint(0, L, (B, k), generator=g, device=dev,
                                           dtype=torch.int32),
                             s, t, rnd(d, 29, scale=d ** -0.5), vec(29))
                        for k in (1, 8)],
    }


def edge_cases(g) -> dict[str, list]:
    """Shapes off the main path that the kernels' tiling must still get
    right: a GEMM with M, N, K off the 128x128x32 tile, a smaller window,
    and a length that leaves a ragged query tile."""
    import torch

    from biom3_tpu_torch.ops import kernels as K

    dev, bf = g.device, torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    a, w, r = rnd(1000, 264), rnd(264, 200, scale=264 ** -0.5), rnd(1000, 200)
    bias = 0.1 * torch.randn(200, generator=g, device=dev)
    q3, qd = rnd(2, 256, 1536), rnd(3, 200, 2304)
    kw = dict(act="erf", residual=r, out_dtype=torch.float32)
    return {
        "gemm_bias_act": [(lambda: K.gemm_bias_act(a, w, bias, **kw),
                           lambda: K.gemm_bias_act_plain(a, w, bias, **kw))],
        "stage3_attention_core": [
            (lambda: K.stage3_attention_core(q3, heads=16, local_heads=8, window=64),
             lambda: K.stage3_attention_core_plain(q3, heads=16, local_heads=8, window=64))],
        "dense_attention": [(lambda: K.dense_attention(qd, heads=12),
                             lambda: K.dense_attention_plain(qd, heads=12))],
    }


def phase_kernels() -> dict:
    import torch

    g = torch.Generator(device="cuda").manual_seed(SEED)
    # timed: the check shapes (Stage 3 B=4, BERT B=2); also checked: the
    # shapes phase 5's run gives the kernels (2 replicas, 1 prompt) and
    # the edge cases
    timed = kernel_cases(4, 2, g)
    checked = [timed, kernel_cases(2, 1, g), edge_cases(g)]
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
        ms = cuda_ms(lambda: [run() for run, _ in calls])
        plain_ms = cuda_ms(lambda: [plain() for _, plain in calls])
        results[name] = {"max_abs_err": worst_abs, "ms": ms, "plain_ms": plain_ms}
        say("kernels", f"{name}: max|Δ| {worst_abs:.3e} rel {worst_rel:.3e} "
                       f"kernel {ms:.4f} ms plain {plain_ms:.4f} ms")
    return results


# --------------------------------------------------------------------------
# phase 4: full-width forwards on the kernels vs the plain f32 modules
# --------------------------------------------------------------------------

def phase_models() -> None:
    import torch

    from biom3_tpu_torch.config import BertConfig, ProteoScribeConfig
    from biom3_tpu_torch.io.state_dict import seeded_init_
    from biom3_tpu_torch.models.bert import BertEncoder
    from biom3_tpu_torch.models.fused_forward import make_stack_apply
    from biom3_tpu_torch.models.proteoscribe import ProteoScribe
    from biom3_tpu_torch.ops.bert_stack import bert_embed, bert_stack_arrays, fused_bert_cls

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


# --------------------------------------------------------------------------
# phase 5: the text→protein CLI at full width
# --------------------------------------------------------------------------

VALID = set("ACDEFGHIKLMNPQRSTVWY" "XUZBO" "-")


def write_stage_files(root: pathlib.Path) -> dict:
    """Seeded random full-width weights in the reference .bin layouts, the
    three stage configs and a synthetic wordpiece vocab → CLI flags."""
    import torch

    from biom3_tpu_torch.config import Config, FacilitatorConfig, PenCLConfig, ProteoScribeConfig
    from biom3_tpu_torch.io.state_dict import seeded_init_
    from biom3_tpu_torch.models.facilitator import Facilitator
    from biom3_tpu_torch.models.pencl import PenCLText
    from biom3_tpu_torch.models.proteoscribe import ProteoScribe
    from biom3_tpu_torch.tokenizers import write_synthetic_wordpiece

    vocab = write_synthetic_wordpiece(root / "vocab")
    stage = {
        1: {"protein_encoder_embedding": 1280, "text_encoder_embedding": 768,
            "bert_num_layers": 12, "bert_num_heads": 12, "bert_intermediate_size": 3072,
            "bert_vocab_size": vocab, "bert_max_position_embeddings": 512,
            "proj_embedding_dim": 512, "text_max_length": 512,
            "text_model_path": str(root / "vocab")},
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
    if min(counts.values()) <= 0:
        raise AssertionError(f"a kernel never launched on the main path: {counts}")
    forwards = files["steps"]          # exact mode: one forward per step, one batch
    if counts["stage3_attention_core"] != files["depth"] * forwards:
        raise AssertionError(f"stage3_attention_core launched "
                             f"{counts['stage3_attention_core']} times, expected "
                             f"{files['depth']} x {forwards}")
    say("e2e", f"1 prompt x 2 replicas, exact mode ({forwards} steps): {wall:.2f} s wall; "
               f"lengths {[len(s) for s in seqs]}; launches {counts}")
    return counts


def main() -> None:
    device = phase_device()
    phase_build()
    measured = phase_kernels()
    phase_models()
    counts = phase_e2e()
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
         "replaces": KERNEL_SOURCES[name][1], "launches": counts[name], **measured[name]}
        for name in KERNEL_SOURCES
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()

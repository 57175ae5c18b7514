"""Certify the int8 serving modes on a TRAINED model (not random init).

Port of the JAX package's ``tools/certify_int8.py``.  The int8 drift gates
run on seeded random weights; trained transformers can develop activation
outliers that quantize worse (the LLM.int8 failure mode — the per-token
dynamic × per-out-channel scheme is the standard mitigation, but it should
be MEASURED).  This harness trains the toy ProteoScribe on the
class-conditioned copy task (``certify_task``), then compares the stack
forward (``models/fused_forward.make_stack_apply``, erf GELU) in bf16
against its int8-FF and int8-FF+proj modes on the trained weights:

  * temp-0 sequences: exact-match fraction vs the first mode (greedy
    decoding is the most quantization-sensitive surface);
  * logit agreement: max |Δ| and min cosine on a probe batch (16 random
    positions a row, numpy seeds 7 and 11 as in the JAX tool);
  * task quality: coherence / class accuracy per mode.

On the card the stack forward runs its kernels in bf16; ``--device cpu``
runs their plain versions in f32, as the JAX tool's ``--interpret``.

  python -m biom3_tpu_torch.tools.certify_int8 --steps 600 --batch 64
  python -m biom3_tpu_torch.tools.certify_int8 --device cpu --steps 2 \\
      --batch 2 --sample-batch 2 --seq-len 32
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from biom3_tpu_torch.diffusion.sampler import make_sampler, sample_permutations
from biom3_tpu_torch.models.fused_forward import make_stack_apply
from biom3_tpu_torch.tools.certify_task import (
    MODES,
    build_and_train,
    coherence_stats,
    make_batch,
)

QUANT = {"bf16": ("none", "none"), "int8-ff": ("int8", "none"),
         "int8-ff+proj": ("int8", "int8")}


def probe_inputs(B: int, L: int, num_timesteps: int):
    """The logit probe's (x (B, L), t (B,), pos (B, 16)) int32 numpy: a mode
    token repeated, a random timestep and 16 random positions a row."""
    prng = np.random.default_rng(11)
    x = (MODES[prng.integers(0, 2, B), prng.integers(0, 4, B)][:, None]
         * np.ones((B, L), np.int32)).astype(np.int32)
    t = prng.integers(0, num_timesteps, B).astype(np.int32)
    pos = np.stack([prng.permutation(L)[:16] for _ in range(B)]).astype(np.int32)
    return x, t, pos


def certify_rows(model, modes, z_c: torch.Tensor, cls: np.ndarray, path: torch.Tensor, *,
                 dtype: torch.dtype, sample: bool = True):
    """One row per mode (the first the reference) → (rows, {mode: temp-0
    ids (B, L) numpy}; empty without ``sample``)."""
    cfg = model.config
    dev = z_c.device
    x, t, pos = (torch.from_numpy(a).to(dev)
                 for a in probe_inputs(z_c.shape[0], cfg.max_seq_len, cfg.num_timesteps))
    rows, ids = [], {}
    ref_logits = ref_seqs = None
    for name in modes:
        ff_quant, proj_quant = QUANT[name]
        apply_fn = make_stack_apply(model, dtype=dtype, gelu="erf", ff_quant=ff_quant,
                                    proj_quant=proj_quant)
        logits = apply_fn(x, t, z_c, pos).float().cpu().numpy()
        row = {"mode": name}
        seqs = None
        if sample:
            sampler = make_sampler(apply_fn, cfg.num_timesteps, temperature=0.0,
                                   chunk_steps=None, apply_takes_positions=True)
            seqs = ids[name] = sampler(z_c, path).cpu().numpy()
            cons, class_ok, diversity = coherence_stats(seqs, cls)
            row.update({
                "coherence_mean": round(float(cons.mean()), 4),
                "class_acc": round(float(class_ok.mean()), 3),
                "mode_diversity": round(diversity, 3),
            })
        if ref_logits is None:
            ref_logits, ref_seqs = logits, seqs
        else:
            cos = (logits * ref_logits).sum(-1) / (
                np.linalg.norm(logits, axis=-1) * np.linalg.norm(ref_logits, axis=-1) + 1e-9)
            row.update({
                "logit_max_abs_delta": round(float(np.abs(logits - ref_logits).max()), 4),
                "logit_min_cosine": round(float(cos.min()), 6),
            })
            if seqs is not None:
                row.update({
                    "temp0_seq_exact_match": round(
                        float((seqs == ref_seqs).all(axis=1).mean()), 3),
                    "temp0_tok_agreement": round(float((seqs == ref_seqs).mean()), 5),
                })
        rows.append(row)
    return rows, ids


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="certify the int8 serving modes on the trained toy")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--sample-batch", type=int, default=64)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--state-path", default=None,
                    help="torch file shared with certify_blocked/inpaint: load the trained "
                         "params if present, save otherwise")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="cuda: the kernels in bf16; cpu: their plain versions in f32 (pair "
                         "with small --steps/--batch/--seq-len)")
    ap.add_argument("--modes", nargs="+", default=list(QUANT), choices=list(QUANT),
                    help="subset of quant modes to certify (the first is the comparison "
                         "reference)")
    ap.add_argument("--no-sample", action="store_true",
                    help="skip the temp-0 sampler comparison (logit probe only)")
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    cfg, model, _ = build_and_train(args.steps, args.batch, args.seq_len,
                                    state_path=args.state_path, device=args.device)
    dev = torch.device(args.device)
    B = args.sample_batch
    _, z_c, cls = make_batch(np.random.default_rng(7), B, cfg.max_seq_len, cfg.cond_dim,
                                  dev)
    path = sample_permutations(torch.Generator(device=dev).manual_seed(42), B, cfg.max_seq_len)
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    rows, _ = certify_rows(model, args.modes, z_c, cls, path, dtype=dtype,
                           sample=not args.no_sample)
    for row in rows:
        print(json.dumps(row), flush=True)
    return rows


if __name__ == "__main__":
    main()

"""Where bf16 moves Stage-1 (PenCL) training on one CUDA card, by loss term.

    python -m biom3_tpu_torch.cli.measure_stage1 [--out build/measure_stage1.json]

Full-width PenCL (ESM2-650M, PubMedBERT-base widths, projection heads to
512) on seeded weights, ``pfam`` batches of full-length and PAD-tailed
proteins with fixed masks.  For each scale of the projection heads' output
LayerNorms (1, the seeded init, and ``LATENT_SCALE``), measures and writes
as one JSON object:

* ``grad_cos_{impl}_{terms}_scale{s}``: the cosine between the whole
  gradient of the contrastive terms (``loss_align + loss_intra``) or of the
  MLM terms (``loss_text_mask + loss_seq_mask``) in bf16, on the kernels
  (``layer-block``) or on torch ops (``plain``), and the f32 module's, same
  weights (rounded to bf16) and batch of 2 pairs, dropout off; and
  ``grad_norm_f32_{terms}_scale{s}``, the norm of the f32 gradient;
* ``steps_scale{s}``: every loss term at each of ``STEPS`` AdamW steps
  (rate ``LR``) of ``layer-block`` on one fixed batch of 4 pairs.

The seeded towers give nearly parallel latents, so the contrastive terms'
gradient is a difference of nearly equal terms, which bf16 rounding moves
at any scale; at the seeded scale (latent norm ~22.6, a LayerNorm over
512) it is also most of the whole gradient.  ``chip_smoke.py`` phase 8
seeds the heads at ``LATENT_SCALE``, where it is a small part of it.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import tempfile

import numpy as np
import torch

from biom3_tpu_torch.cli.measure_pencl import stage1_config
from biom3_tpu_torch.config import Config, PenCLConfig
from biom3_tpu_torch.data.stage1_data import mask_tokens
from biom3_tpu_torch.io.state_dict import seeded_init_
from biom3_tpu_torch.models.pencl import PenCL
from biom3_tpu_torch.training.stage1_task import (
    make_stage1_optimizer,
    make_stage1_train_step,
    stage1_loss_fn,
)
from biom3_tpu_torch.training.state import TrainState

LATENT_SCALE = 0.05   # the projection heads' output LayerNorm scale in chip_smoke.py
TEXT_MASK_ID, PROTEIN_MASK_ID = 4, 32   # [MASK] of the synthetic vocab, ESM <mask>
TERMS = {"contrastive": ("loss_align", "loss_intra"),
         "mlm": ("loss_text_mask", "loss_seq_mask")}
STEPS, LR, SEED = 16, 1e-3, 0


def stage1_batch(cfg: PenCLConfig, lengths, rng: np.random.Generator, dev) -> dict:
    """A ``pfam`` training batch, int32 on ``dev``: ``lengths`` is (SwissProt
    residue counts, Pfam residue counts); proteins are <cls>, residues,
    <eos>, PAD to 1024; captions are [CLS], 8-40 random wordpieces, [SEP],
    PAD to ``text_max_length``; the masked copies come from
    ``mask_tokens`` (fixed masks)."""
    V, Lt = cfg.bert.vocab_size, cfg.text_max_length
    batch = {}
    for prefix, counts in zip(("", "pfam_"), lengths):
        protein = np.full((len(counts), cfg.seq_max_length), 1, np.int32)
        text = np.zeros((len(counts), Lt), np.int32)
        for b, k in enumerate(counts):
            protein[b, 0], protein[b, 1:k + 1], protein[b, k + 1] = 0, rng.integers(4, 24, k), 2
            m = int(rng.integers(8, 41))
            text[b, 0], text[b, 1:m + 1], text[b, m + 1] = 2, rng.integers(5, V, m), 3
        batch[prefix + "protein_tokens"], batch[prefix + "text_tokens"] = protein, text
        batch[prefix + "protein_tokens_masked"] = mask_tokens(
            protein, PROTEIN_MASK_ID, (0, 1, 2), random_ids=np.arange(4, 24), rng=rng)
        batch[prefix + "text_tokens_masked"] = mask_tokens(
            text, TEXT_MASK_ID, (0, 1, 2, 3, 4), random_ids=np.arange(5, V), rng=rng)
    return {k: torch.from_numpy(v).to(dev) for k, v in batch.items()}


def seeded_stage1(cfg: PenCLConfig, seed: int, latent_scale: float = LATENT_SCALE,
                  **kw) -> PenCL:
    """The f32 training PenCL on the host from ``seed``, its projection
    heads' output LayerNorms (scale and shift) times ``latent_scale``."""
    model = seeded_init_(PenCL(cfg, mlm_heads=True, **kw), seed)
    with torch.no_grad():
        for head in (model.protein_projection, model.text_projection):
            head.layer_norm.weight.mul_(latent_scale)
            head.layer_norm.bias.mul_(latent_scale)
    return model


def _loss_kw(cfg: PenCLConfig) -> dict:
    return dict(temperature=cfg.temperature, dataset_type="pfam", text_mask_id=TEXT_MASK_ID,
                protein_mask_id=PROTEIN_MASK_ID)


def grad_cosines(cfg: PenCLConfig, batch: dict, latent_scale: float) -> dict[str, float]:
    """Cosine of each term group's bf16 gradient with the f32 module's."""
    ref = seeded_stage1(cfg, SEED + 9, latent_scale, remat=True)
    with torch.no_grad():
        for p in ref.parameters():
            p.copy_(p.bfloat16())
    ref = ref.cuda()

    def grad(model, keys):
        model.eval()
        model.zero_grad(set_to_none=True)
        _, aux = stage1_loss_fn(model, batch, **_loss_kw(cfg))
        sum(aux[k] for k in keys).backward()
        return torch.cat([(p.grad if p.grad is not None else torch.zeros_like(p)).float().flatten()
                          for p in model.parameters()])

    want = {name: grad(ref, keys) for name, keys in TERMS.items()}
    out = {f"grad_norm_f32_{name}": float(g.norm()) for name, g in want.items()}
    for impl in ("layer-block", "plain"):
        model = PenCL(cfg, attn_impl=impl, dtype=torch.bfloat16, remat=impl == "plain",
                      mlm_heads=True).cuda()
        model.load_state_dict(ref.state_dict())
        for name, keys in TERMS.items():
            out[f"grad_cos_{impl}_{name}"] = float(torch.nn.functional.cosine_similarity(
                grad(model, keys), want[name], dim=0))
        del model
        torch.cuda.empty_cache()
    return out


def step_terms(cfg: PenCLConfig, batch: dict, latent_scale: float) -> list[dict[str, float]]:
    """Every loss term of each of ``STEPS`` ``layer-block`` train steps."""
    init = seeded_stage1(cfg, SEED + 10, latent_scale).state_dict()
    with torch.device("cuda"):
        model = PenCL(cfg, attn_impl="layer-block", dtype=torch.bfloat16, mlm_heads=True)
    model.load_state_dict(init)
    rates = Config({"protein_encoder_lr": LR, "text_encoder_lr": LR, "head_lr": LR})
    step = make_stage1_train_step(TrainState(model, make_stage1_optimizer(rates, model)),
                                  **_loss_kw(cfg))
    torch.manual_seed(SEED)   # dropout
    keys = ("loss", *TERMS["contrastive"], *TERMS["mlm"])
    rows = [step(batch) for _ in range(STEPS)]
    return [{k: round(float(aux[k]), 4) for k in keys} for aux in rows]


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="Stage-1 training's bf16 error by loss term")
    parser.add_argument("--out", type=str, default="build/measure_stage1.json")
    return parser.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_arguments(argv)
    if not torch.cuda.is_available():
        sys.exit("torch.cuda.is_available() is false: this measurement needs the card")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    res: dict[str, object] = {}
    with tempfile.TemporaryDirectory(prefix="measure_stage1_") as tmp:
        cfg = PenCLConfig.from_stage_config(Config(stage1_config(pathlib.Path(tmp))))
    small = stage1_batch(cfg, ([1022, 398], [700, 1022]), np.random.default_rng(SEED + 9), "cuda")
    fixed = stage1_batch(cfg, ([1022] * 4, [1022] * 4), np.random.default_rng(SEED + 10), "cuda")
    for scale in (1.0, LATENT_SCALE):
        for key, value in grad_cosines(cfg, small, scale).items():
            res[f"{key}_scale{scale}"] = value
            print(f"{key}_scale{scale} = {value:.6f}", flush=True)
        rows = step_terms(cfg, fixed, scale)
        res[f"steps_scale{scale}"] = rows
        for i, row in enumerate(rows, 1):
            print(f"steps_scale{scale} step {i}: {row}", flush=True)
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1) + "\n")
    return res


if __name__ == "__main__":
    main()

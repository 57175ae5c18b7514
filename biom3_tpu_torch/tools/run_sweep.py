"""The bulk generation sweep (prompts × replicas) with its QC table.

Port of the JAX package's ``tools/run_sweep.py``.  Runs the whole pipeline
end to end on the port's three engines — host tokenize → PenCL text embed
→ Facilitator → Stage-3 denoise — over many prompts, then QCs every output
and prints one JSON line with phase timings, prompts/hour, the QC table
(validity, composition, entropy; the reference's
``Stage3_source/eval_metrics.py:259-412``) and the inpaint-recovery probe
(BLOSUM soft accuracy at re-masked positions, on ``training/metrics.py``).
It is a tool: its rate is not a benchmark metric.

No published checkpoints are in the repository (WEIGHTS.md), so the weights
are seeded and the text tower reads the synthetic wordpiece vocab: the
timing and the QC machinery are what this measures.  The stage configs are
built here (the published serving widths; ``--tiny`` shrinks every stage
for a CPU smoke run, which runs the PyTorch modules in f32).  On the card
the engines run bf16 on the kernels, int8 at the engines' default.

  python -m biom3_tpu_torch.tools.run_sweep --prompts 1000 --replicas 5 --mode fast
  python -m biom3_tpu_torch.tools.run_sweep --tiny --device cpu --prompts 4 \\
      --replicas 2 --batch 4 --qc-inpaint-rows 4
"""

from __future__ import annotations

import argparse
import json
import pathlib
import tempfile
import time

import numpy as np
import torch

from biom3_tpu_torch.training.metrics import BLOSUM62_SOFT, DECODE_TO_BLOSUM

# prompt templates: enough lexical variety that tokenization/embedding is
# not degenerately cached; biology-flavored like the reference's captions
_SUBJECTS = [
    "membrane transport protein", "zinc finger transcription factor",
    "atp-dependent kinase", "beta barrel porin", "heat shock chaperone",
    "calcium binding messenger", "serine protease inhibitor",
    "iron sulfur cluster enzyme", "leucine rich repeat receptor",
    "helix turn helix regulator",
]
_QUALIFIERS = [
    "from a thermophilic archaeon", "with high catalytic efficiency",
    "localized to the inner membrane", "involved in dna repair",
    "that binds small peptides", "with a conserved catalytic triad",
    "expressed under oxidative stress", "forming a homodimer",
    "with broad substrate specificity", "stabilized by disulfide bonds",
]

# the stage configs: PubMedBERT-base text tower (text-only engine), the
# Facilitator, the 16-layer 512-d ProteoScribe at L=1024; and their tiny
# twins for the CPU
TINY_S1 = {
    "protein_encoder_embedding": 16, "text_encoder_embedding": 16,
    "esm_num_layers": 1, "esm_attention_heads": 2,
    "bert_num_layers": 1, "bert_num_heads": 2,
    "bert_intermediate_size": 32,
    "bert_max_position_embeddings": 32, "proj_embedding_dim": 8,
    "temperature": 0.8, "text_max_length": 32,
}
TINY_S2 = {"emb_dim": 8, "hid_dim": 16, "dropout": 0.0, "loss_type": "MMD"}
FULL_S1 = {
    "protein_encoder_embedding": 1280, "text_encoder_embedding": 768,
    "esm_num_layers": 1, "esm_attention_heads": 2,  # text_only path
    "bert_num_layers": 12, "bert_num_heads": 12,
    "bert_intermediate_size": 3072,
    "bert_max_position_embeddings": 512, "proj_embedding_dim": 512,
    "temperature": 0.8, "text_max_length": 512,
}
FULL_S2 = {"emb_dim": 512, "hid_dim": 640, "dropout": 0.0, "loss_type": "MMD"}


def stage_configs(tiny: bool, *, batch: int, replicas: int = 2) -> tuple:
    """→ (s1_cfg, s2_cfg, s3_cfg) dicts; the caller adds the tokenizer keys
    (``bert_vocab_size``, ``text_model_path``)."""
    if tiny:
        s3 = {
            "num_replicas": replicas, "batch_size_sample": batch,
            "diffusion_steps": 64, "seed": 0, "task": "proteins",
            "text_emb_dim": 8, "transformer_dim": 32,
            "transformer_heads": 4, "transformer_depth": 2,
            "transformer_blocks": 1, "transformer_local_heads": 2,
            "transformer_local_size": 16, "facilitator": "MMD",
            "context_window_size": 64, "image_size": 8, "num_classes": 29,
        }
        return dict(TINY_S1), dict(TINY_S2), s3
    s3 = {
        "num_replicas": replicas, "batch_size_sample": batch,
        "diffusion_steps": 1024, "seed": 0, "task": "proteins",
        "text_emb_dim": 512, "transformer_dim": 512,
        "transformer_heads": 16, "transformer_depth": 16,
        "transformer_blocks": 1, "transformer_local_heads": 8,
        "transformer_local_size": 128, "facilitator": "MMD",
        "context_window_size": 1024, "image_size": 32, "num_classes": 29,
    }
    return dict(FULL_S1), dict(FULL_S2), s3


def make_prompts(n: int) -> list[str]:
    return [
        f"a {_SUBJECTS[i % len(_SUBJECTS)]} "
        f"{_QUALIFIERS[(i // len(_SUBJECTS)) % len(_QUALIFIERS)]} "
        f"variant {i}"
        for i in range(n)
    ]


def qc_table(ids: np.ndarray, vocab, max_pairwise: int = 256) -> dict:
    """Structural QC over raw decode-table ids (B, L).

    validity: marker structure (exactly one <START>, >=1 <END>, no
    absorbing-state leftovers); composition: residue frequencies and
    per-class entropy (the reference's eval_metrics composition probes);
    diversity: unique fraction + mean pairwise identity on a sample.
    """
    B, L = ids.shape
    start_id = vocab.decode_tokens.index("<START>")
    end_id = vocab.decode_tokens.index("<END>")
    n_start = (ids == start_id).sum(axis=1)
    n_end = (ids == end_id).sum(axis=1)
    n_absorb = (ids == vocab.absorbing_id).sum(axis=1)
    marker_ok = (n_start == 1) & (n_end >= 1) & (n_absorb == 0)

    # per-class (29-way) empirical distribution -> entropy (nats)
    counts = np.bincount(ids.reshape(-1), minlength=vocab.num_classes)
    p = counts / counts.sum()
    class_entropy = float(-(p[p > 0] * np.log(p[p > 0])).sum())
    # mean per-position entropy (positional mode collapse shows here)
    pos_entropy = []
    for j in range(0, L, max(1, L // 64)):  # 64-position subsample
        c = np.bincount(ids[:, j], minlength=vocab.num_classes)
        q = c / c.sum()
        pos_entropy.append(float(-(q[q > 0] * np.log(q[q > 0])).sum()))

    seqs = [vocab.clean_sequence(vocab.decode_ids(row)) for row in ids]
    lengths = np.array([len(s) for s in seqs])
    uniq = len(set(seqs)) / max(1, len(seqs))
    # mean pairwise identity on a subsample (quadratic, so bounded)
    sample = seqs[:max_pairwise]
    ident = []
    for i in range(0, len(sample) - 1, 2):
        a, b = sample[i], sample[i + 1]
        m = min(len(a), len(b))
        if m:
            ident.append(sum(x == y for x, y in zip(a, b)) / m)
    aa = "ACDEFGHIKLMNPQRSTVWY"
    aa_ids = [vocab.decode_tokens.index(c) for c in aa]
    aa_frac = float(np.isin(ids, aa_ids).mean())
    return {
        "n": int(B),
        "marker_valid_frac": round(float(marker_ok.mean()), 4),
        "absorbing_leftover_frac": round(float((n_absorb > 0).mean()), 4),
        "aa_token_frac": round(aa_frac, 4),
        "class_entropy_nats": round(class_entropy, 4),
        "mean_positional_entropy_nats": round(
            float(np.mean(pos_entropy)), 4
        ),
        "len_mean": round(float(lengths.mean()), 1),
        "len_p5": int(np.percentile(lengths, 5)),
        "len_p95": int(np.percentile(lengths, 95)),
        "unique_frac": round(uniq, 4),
        "mean_pairwise_identity": round(
            float(np.mean(ident)) if ident else 0.0, 4
        ),
    }


def inpaint_recovery_probe(engine, z_c: np.ndarray, ids: np.ndarray, *,
                           masked_frac: float = 0.25, seed: int = 0) -> dict:
    """Corruption-recovery QC (the one place BLOSUM soft accuracy is
    defined for a sweep): re-mask ``masked_frac`` of each generated
    sequence's residue positions and inpaint them back conditioned on the
    same z_c (``engine.inpaint_batch``, its draws from a generator seeded
    ``seed``); score recovered vs original at the masked positions with the
    BLOSUM62 soft accuracy's lookup (``training/metrics.py``).  Reference
    counterpart: ``Stage3_source/sampling_analysis.py:21-61``."""
    rng = np.random.default_rng(seed)
    masked = ids.copy()
    # decode table: the 20 residues map into BLOSUM (DECODE_TO_BLOSUM >= 0)
    maskable = DECODE_TO_BLOSUM[ids] >= 0
    mask = maskable & (rng.random(ids.shape) < masked_frac)
    masked[mask] = 0
    filled = np.asarray(engine.inpaint_batch(
        masked, z_c, torch.Generator(device=engine.device).manual_seed(seed)))
    frac = mask.mean()
    if not mask.any():
        return {"masked_frac": 0.0}
    exact = float((filled[mask] == ids[mask]).mean())
    # masked-position-only soft score (reference eval_metrics.py:61-132
    # semantics restricted to the corrupted sites): BLOSUM softmax lookup
    # where the prediction is a residue, hard 0 where it is a marker
    b_pred = DECODE_TO_BLOSUM[filled[mask]]
    b_real = DECODE_TO_BLOSUM[ids[mask]]     # >= 0 by construction
    soft = np.where(b_pred >= 0, BLOSUM62_SOFT[np.maximum(b_pred, 0), b_real], 0.0)
    return {
        "masked_frac": round(float(frac), 4),
        "masked_exact_match": round(exact, 4),
        "masked_blosum_soft_acc": round(float(soft.mean()), 4),
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="the bulk generation sweep with its QC table")
    ap.add_argument("--prompts", type=int, default=1000)
    ap.add_argument("--replicas", type=int, default=5)
    ap.add_argument("--mode", choices=["fast", "exact"], default="fast",
                    help="fast = maskgit (or blocked, --fast-kind); exact = 1-pos/step ARDM "
                         "(reference semantics)")
    ap.add_argument("--fast-kind", choices=["maskgit", "blocked"], default="maskgit")
    ap.add_argument("--maskgit-steps", type=int, default=16)
    ap.add_argument("--batch", type=int, default=32, help="Stage-3 device rows per dispatch")
    ap.add_argument("--temperature", type=float, default=1.0)
    ap.add_argument("--qc-inpaint-rows", type=int, default=32,
                    help="rows for the inpaint-recovery BLOSUM probe (0 disables)")
    ap.add_argument("--out", type=str, default=None, help="also write the JSON report here")
    ap.add_argument("--tiny", action="store_true", help="CPU smoke shapes")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> dict:
    args = parse_args(argv)

    from biom3_tpu_torch.config import Config
    from biom3_tpu_torch.pipeline.stage1 import PenCLEngine
    from biom3_tpu_torch.pipeline.stage2 import FacilitatorEngine
    from biom3_tpu_torch.pipeline.stage3 import ProteoScribeEngine
    from biom3_tpu_torch.tokenizers import write_synthetic_wordpiece

    dev = torch.device(args.device)
    with tempfile.TemporaryDirectory(prefix="run_sweep_") as tmp:
        vocab_size = write_synthetic_wordpiece(pathlib.Path(tmp) / "tok")
        s1_cfg, s2_cfg, s3_cfg = stage_configs(args.tiny, batch=args.batch,
                                               replicas=args.replicas)
        s1_cfg["bert_vocab_size"] = vocab_size
        s1_cfg["text_model_path"] = f"{tmp}/tok"

        dtype = torch.float32 if args.tiny else torch.bfloat16
        t_build0 = time.time()
        s1 = PenCLEngine(Config(s1_cfg), None, device=dev, text_only=True, dtype=dtype)
        s2 = FacilitatorEngine(Config(s2_cfg), None, device=dev)
        s3_kwargs: dict = {"temperature": args.temperature}
        if args.mode == "fast":
            if args.fast_kind == "maskgit":
                s3_kwargs.update(sampler_mode="maskgit", maskgit_steps=args.maskgit_steps)
            else:
                s3_kwargs.update(positions_per_step=8)
        s3 = ProteoScribeEngine(Config(s3_cfg), None, device=dev, dtype=dtype, **s3_kwargs)
        build_s = time.time() - t_build0

        prompts = make_prompts(args.prompts)
        total_rows = args.prompts * args.replicas

        # phase 1: tokenize + embed text (PenCL tower); the first batch timed
        # apart, as it owns the one-time set-up (the tokenizer's load)
        t0 = time.time()
        s1.embed_text(prompts[: args.batch], batch_size=args.batch)
        embed_compile_s = time.time() - t0
        t0 = time.time()
        z_t = s1.embed_text(prompts, batch_size=args.batch)
        embed_s = time.time() - t0
    # phase 2: facilitator
    t0 = time.time()
    z_c = np.asarray(s2(z_t), np.float32)
    facil_s = time.time() - t0

    # phase 3: Stage-3 over the (prompt x replica) grid, fixed-shape slabs
    grid = np.repeat(z_c, args.replicas, axis=0)
    gen = torch.Generator(device=dev).manual_seed(0)
    L = s3.config.max_seq_len
    out_ids = np.zeros((total_rows, L), np.int32)
    t0 = time.time()
    compile_s = None
    for start in range(0, total_rows, args.batch):
        n = min(args.batch, total_rows - start)
        rows = grid[start:start + n]
        if n < args.batch:  # pad the tail to the slab's shape
            rows = np.concatenate([rows, np.repeat(rows[-1:], args.batch - n, axis=0)])
        ids = s3.sample_batch(rows, gen)
        if compile_s is None:
            compile_s = time.time() - t0  # the first slab owns the warm-up
        out_ids[start:start + n] = ids[:n]
    gen_total_s = time.time() - t0
    gen_steady_s = gen_total_s - (compile_s or 0.0)
    n_slabs = -(-total_rows // args.batch)
    # steady-state rate excludes the first (warm-up-owning) slab
    steady_rows = total_rows - min(args.batch, total_rows)
    seqs_per_s = (steady_rows / gen_steady_s if steady_rows and gen_steady_s
                  else total_rows / gen_total_s)

    qc = qc_table(out_ids, s3.vocab)
    probe = None
    if args.qc_inpaint_rows:
        m = min(args.qc_inpaint_rows, total_rows, args.batch)
        t0 = time.time()
        probe = inpaint_recovery_probe(s3, grid[:m], out_ids[:m])
        probe["probe_s"] = round(time.time() - t0, 1)

    wall_s = embed_compile_s + embed_s + facil_s + gen_total_s
    # steady-state excludes the one-time warm-ups
    steady_s = embed_s + facil_s + gen_steady_s
    report = {
        "metric": "sweep_prompts_per_hour",
        "value": round(args.prompts / (wall_s / 3600.0), 1),
        "unit": f"prompts/hour ({args.replicas} replicas each, "
                f"mode={args.mode}, end-to-end incl. tokenize)",
        "value_steady": round(args.prompts / (steady_s / 3600.0), 1) if steady_s else None,
        "config": {
            "prompts": args.prompts, "replicas": args.replicas, "mode": args.mode,
            "fast_kind": args.fast_kind if args.mode == "fast" else None,
            "batch": args.batch, "temperature": args.temperature,
            "tiny": args.tiny, "stack_path": s3.use_stack,
            "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        },
        "phases_s": {
            "build": round(build_s, 1),
            "embed_compile": round(embed_compile_s, 1),
            "tokenize_embed": round(embed_s, 1),
            "facilitator": round(facil_s, 1),
            "stage3_total": round(gen_total_s, 1),
            "stage3_compile": round(compile_s or 0.0, 1),
        },
        "rates": {
            "seqs_per_s_steady": round(seqs_per_s, 3),
            "prompts_per_s_embed": round(args.prompts / embed_s, 1),
            "total_sequences": total_rows,
            "slabs": n_slabs,
        },
        "qc": qc,
        "inpaint_recovery": probe,
    }
    line = json.dumps(report)
    print(line, flush=True)
    if args.out:
        pathlib.Path(args.out).write_text(line + "\n")
    return report


if __name__ == "__main__":
    main()

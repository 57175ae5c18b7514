"""Training and evaluation metrics.

Port of ``biom3_tpu/training/metrics.py``: the Stage-1 contrastive
classification metrics (:29-54), RankMe and the singular spectrum
(:57-74), BLOSUM62 soft accuracy (:77-160, the 24×24 table a copy that
``tests/test_torch_eval.py`` holds equal to the JAX package's) and the
Stage-3 subset (:163-217: the reference's ``compute_ppl``,
``compute_hard_acc``, the time-split accuracy/perplexity and
``compute_pos_entropy``), with masks in place of per-sample Python loops.
"""

from __future__ import annotations

import numpy as np
import torch

from biom3_tpu_torch.tokenizers import STAGE3_DECODE_TOKENS


def contrastive_metrics(logits: torch.Tensor) -> dict:
    """Argmax accuracy of the (2B, 2B) contrastive logits (text rows ×
    protein columns) for the text side, the protein side and their mean
    probabilities (ref PL_wrapper.py:1334-1398); for single-label multiclass
    sklearn's micro precision, recall and F1 all equal the accuracy."""
    logits = logits.float()
    y_true = torch.arange(logits.shape[0], device=logits.device)
    p_text = torch.softmax(logits, dim=-1)
    p_seq = torch.softmax(logits.T, dim=-1)
    out = {}
    for source, p in (("text", p_text), ("seq", p_seq), ("total", (p_seq + p_text) / 2)):
        a = (p.argmax(-1) == y_true).float().mean()
        out.update({f"{source}_{k}": a for k in ("accuracy", "precision", "recall", "f1")})
    return out


# --- RankMe / singular spectrum ---------------------------------------------


def singular_spectrum(z: torch.Tensor, *, quirk_q9: bool = False) -> torch.Tensor:
    """Singular values of the (centered) covariance of embeddings (B, D).

    quirk_q9=True reproduces the reference's 1/1 normalization
    (PL_wrapper.py:1419); default divides by the sample count."""
    z = z.float()
    zc = z - z.mean(0, keepdim=True)
    cov = zc.T @ zc
    if not quirk_q9:
        cov = cov / z.shape[0]
    return torch.linalg.svdvals(cov)


def rankme(singular_values: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """RankMe effective rank: exp(entropy of normalized singular values)."""
    p = singular_values / (singular_values.sum() + eps)
    return torch.exp(-(p * torch.log(p + eps)).sum())


# --- BLOSUM62 ----------------------------------------------------------------

BLOSUM62_ALPHABET = "ARNDCQEGHILKMFPSTWYVBZX*"
# Public BLOSUM62 substitution matrix (Henikoff & Henikoff 1992), the same
# table biopython loads (Stage3_source/eval_metrics.py:21-22).
BLOSUM62 = np.array([
    [ 4,-1,-2,-2, 0,-1,-1, 0,-2,-1,-1,-1,-1,-2,-1, 1, 0,-3,-2, 0,-2,-1, 0,-4],
    [-1, 5, 0,-2,-3, 1, 0,-2, 0,-3,-2, 2,-1,-3,-2,-1,-1,-3,-2,-3,-1, 0,-1,-4],
    [-2, 0, 6, 1,-3, 0, 0, 0, 1,-3,-3, 0,-2,-3,-2, 1, 0,-4,-2,-3, 3, 0,-1,-4],
    [-2,-2, 1, 6,-3, 0, 2,-1,-1,-3,-4,-1,-3,-3,-1, 0,-1,-4,-3,-3, 4, 1,-1,-4],
    [ 0,-3,-3,-3, 9,-3,-4,-3,-3,-1,-1,-3,-1,-2,-3,-1,-1,-2,-2,-1,-3,-3,-2,-4],
    [-1, 1, 0, 0,-3, 5, 2,-2, 0,-3,-2, 1, 0,-3,-1, 0,-1,-2,-1,-2, 0, 3,-1,-4],
    [-1, 0, 0, 2,-4, 2, 5,-2, 0,-3,-3, 1,-2,-3,-1, 0,-1,-3,-2,-2, 1, 4,-1,-4],
    [ 0,-2, 0,-1,-3,-2,-2, 6,-2,-4,-4,-2,-3,-3,-2, 0,-2,-2,-3,-3,-1,-2,-1,-4],
    [-2, 0, 1,-1,-3, 0, 0,-2, 8,-3,-3,-1,-2,-1,-2,-1,-2,-2, 2,-3, 0, 0,-1,-4],
    [-1,-3,-3,-3,-1,-3,-3,-4,-3, 4, 2,-3, 1, 0,-3,-2,-1,-3,-1, 3,-3,-3,-1,-4],
    [-1,-2,-3,-4,-1,-2,-3,-4,-3, 2, 4,-2, 2, 0,-3,-2,-1,-2,-1, 1,-4,-3,-1,-4],
    [-1, 2, 0,-1,-3, 1, 1,-2,-1,-3,-2, 5,-1,-3,-1, 0,-1,-3,-2,-2, 0, 1,-1,-4],
    [-1,-1,-2,-3,-1, 0,-2,-3,-2, 1, 2,-1, 5, 0,-2,-1,-1,-1,-1, 1,-3,-1,-1,-4],
    [-2,-3,-3,-3,-2,-3,-3,-3,-1, 0, 0,-3, 0, 6,-4,-2,-2, 1, 3,-1,-3,-3,-1,-4],
    [-1,-2,-2,-1,-3,-1,-1,-2,-2,-3,-3,-1,-2,-4, 7,-1,-1,-4,-3,-2,-2,-1,-2,-4],
    [ 1,-1, 1, 0,-1, 0, 0, 0,-1,-2,-2, 0,-1,-2,-1, 4, 1,-3,-2,-2, 0, 0, 0,-4],
    [ 0,-1, 0,-1,-1,-1,-1,-2,-2,-1,-1,-1,-1,-2,-1, 1, 5,-2,-2, 0,-1,-1, 0,-4],
    [-3,-3,-4,-4,-2,-2,-3,-2,-2,-3,-2,-3,-1, 1,-4,-3,-2,11, 2,-3,-4,-3,-2,-4],
    [-2,-2,-2,-3,-2,-1,-2,-3, 2,-1,-1,-2,-1, 3,-3,-2,-2, 2, 7,-1,-3,-2,-1,-4],
    [ 0,-3,-3,-3,-1,-2,-2,-3,-3, 3, 1,-2, 1,-1,-2,-2, 0,-3,-1, 4,-3,-2,-1,-4],
    [-2,-1, 3, 4,-3, 0, 1,-1, 0,-3,-4, 0,-3,-3,-2, 0,-1,-4,-3,-3, 4, 1,-1,-4],
    [-1, 0, 0, 1,-3, 3, 4,-2, 0,-3,-3, 1,-1,-3,-1, 0,-1,-3,-2,-2, 1, 4,-1,-4],
    [ 0,-1,-1,-1,-2,-1,-1,-1,-1,-1,-1,-1,-1,-1,-2, 0, 0,-2,-1,-1,-1,-1,-1,-4],
    [-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4,-4, 1],
], dtype=np.float32)

# soft-accuracy lookup: soft[a1, a2] = softmax(BLOSUM62[a1])·onehot(a2) /
# max(softmax(BLOSUM62[a1]))  (ref blosum_acc, eval_metrics.py:24-47)
_probs = np.exp(BLOSUM62) / np.exp(BLOSUM62).sum(axis=1, keepdims=True)
BLOSUM62_SOFT = (_probs / _probs.max(axis=1, keepdims=True)).astype(np.float32)


def _decode_to_blosum_index() -> np.ndarray:
    """Decode-table id (Stage-3 29-token vocab) → BLOSUM62 alphabet index;
    -1: not an amino acid BLOSUM handles ('-', markers: hard-compared)."""
    out = np.full(len(STAGE3_DECODE_TOKENS), -1, np.int32)
    for i, tok in enumerate(STAGE3_DECODE_TOKENS):
        if len(tok) == 1 and tok in BLOSUM62_ALPHABET:
            out[i] = BLOSUM62_ALPHABET.index(tok)
    return out


DECODE_TO_BLOSUM = _decode_to_blosum_index()


def blosum_soft_accuracy(pred_ids: torch.Tensor, real_ids: torch.Tensor) -> torch.Tensor:
    """Soft accuracy over decode-table id sequences (B, L) (ref
    eval_metrics.py:61-132): positions where both ids map into BLOSUM score
    the softmax-substitution lookup, the others exact match; each sample
    averages its soft and hard parts, then the batch averages."""
    pred_ids, real_ids = pred_ids.long(), real_ids.long()
    lookup = torch.as_tensor(DECODE_TO_BLOSUM, device=pred_ids.device).long()
    b_pred, b_real = lookup[pred_ids], lookup[real_ids]
    is_soft = (b_pred >= 0) & (b_real >= 0)
    soft_scores = torch.as_tensor(BLOSUM62_SOFT, device=pred_ids.device)[
        b_pred.clamp(min=0), b_real.clamp(min=0)]
    hard_scores = (pred_ids == real_ids).float()
    n_soft, n_hard = is_soft.sum(-1), (~is_soft).sum(-1)
    soft_avg = (soft_scores * is_soft).sum(-1) / n_soft.clamp(min=1)
    hard_avg = (hard_scores * ~is_soft).sum(-1) / n_hard.clamp(min=1)
    per_sample = torch.where(n_soft == 0, hard_avg,
                             torch.where(n_hard == 0, soft_avg, (soft_avg + hard_avg) / 2))
    return per_sample.mean()


def _entropy(probs: torch.Tensor) -> torch.Tensor:
    probs = probs.float()
    return -(probs * torch.log(probs.clamp(min=1e-30))).sum(-1)


def entropy_ppl(probs: torch.Tensor) -> torch.Tensor:
    """exp(entropy) per position, batch-averaged.  probs: (B, L, C)."""
    return torch.exp(_entropy(probs)).mean()


def hard_accuracy(pred_ids: torch.Tensor, real_ids: torch.Tensor, pad_id: int = 23) -> torch.Tensor:
    """Exact-match accuracy ignoring <PAD> targets."""
    valid = real_ids != pad_id
    n = valid.sum(-1)
    per_sample = ((pred_ids == real_ids) & valid).sum(-1) / n.clamp(min=1)
    return torch.where(n == 0, torch.ones_like(per_sample), per_sample).mean()


def time_split_metrics(pred_ids, real_ids, probs, path, t) -> dict:
    """Hard accuracy and entropy-perplexity over the past (σ < t), current
    (σ = t) and future (σ > t) positions of the sampling path."""
    t = t.reshape(-1, 1)
    ent = _entropy(probs)
    out = {}
    for name, mask in (("prev", path < t), ("current", path == t), ("fut", path > t)):
        maskf = mask.float()
        n = maskf.sum(-1).clamp(min=1)
        has = (maskf.sum(-1) > 0).float()
        acc = ((pred_ids == real_ids).float() * maskf).sum(-1) / n
        out[f"{name}_hard_acc"] = (acc * has).sum() / has.sum().clamp(min=1)
        ppl = (torch.exp(ent) * maskf).sum(-1) / n
        out[f"{name}_ppl"] = (ppl * has).sum() / has.sum().clamp(min=1)
    return out


def positional_entropy(probs: torch.Tensor) -> torch.Tensor:
    """Mean positional entropy."""
    probs = probs.float()
    return (-probs * torch.log(probs.clamp(min=1e-30))).mean()

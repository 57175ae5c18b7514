"""Training metrics.

Port of ``biom3_tpu/training/metrics.py``: the Stage-1 contrastive
classification metrics (:29-54) and the Stage-3 subset (:163-217: the
reference's ``compute_ppl``, ``compute_hard_acc``, the time-split
accuracy/perplexity and ``compute_pos_entropy``), with masks in place of
per-sample Python loops.  BLOSUM soft accuracy and RankMe are not ported
yet.
"""

from __future__ import annotations

import torch


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

"""Stage-3 training metrics.

Port of the Stage-3 subset of ``biom3_tpu/training/metrics.py:163-217``
(the reference's ``compute_ppl``, ``compute_hard_acc``, the time-split
accuracy/perplexity and ``compute_pos_entropy``), with masks in place of
per-sample Python loops.  BLOSUM soft accuracy, RankMe and the contrastive
metrics are not ported yet.
"""

from __future__ import annotations

import torch


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

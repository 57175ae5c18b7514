"""Order-agnostic ARDM (any-order autoregressive diffusion) objective.

Port of ``biom3_tpu/diffusion/oa_ardm.py:26-105`` (the reference's
``Stage3_source/transformer_training_helper.py``):

  * per-row random sampling path σ (a permutation of [0, L)),
  * a random timestep t ~ U[0, L] (inclusive), or the exponentially
    decaying ``weighted`` draw,
  * positions with σ < t keep their true token; the rest become the
    absorbing state 0,
  * ELBO: the sum of log p(x_true) over *unsampled* positions × 1/(L − t + 1),
    negated and batch-averaged.

Random draws come from an explicit ``torch.Generator``; torch and JAX give
different numbers from the same seed, so the tests hand both the same
numpy paths and timesteps.  Token ids here are the +1-shifted training ids.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def sample_random_paths(generator: torch.Generator, batch: int, length: int,
                        device=None) -> torch.Tensor:
    """(B, L) int64: an independent permutation of [0, L) per row."""
    keys = torch.rand((batch, length), generator=generator, device=generator.device)
    return keys.argsort(dim=-1).to(device or generator.device)


def sample_timesteps(generator: torch.Generator, batch: int, length: int, *,
                     option: str = "random", decay_rate: float = 0.005,
                     device=None) -> torch.Tensor:
    """(B,) int64 in [0, L] inclusive; ``weighted`` draws t with probability
    ∝ exp(−decay_rate·t)."""
    if option == "random":
        t = torch.randint(0, length + 1, (batch,), generator=generator, device=generator.device)
    elif option == "weighted":
        w = torch.exp(-decay_rate * torch.arange(length + 1, dtype=torch.float32,
                                                 device=generator.device))
        t = torch.multinomial(w, batch, replacement=True, generator=generator)
    else:
        raise ValueError(f"unknown timestep sampling option {option!r}")
    return t.to(device or generator.device)


def mask_realizations(real_tokens: torch.Tensor, path: torch.Tensor,
                      t: torch.Tensor) -> torch.Tensor:
    """Keep tokens where σ < t, the absorbing state 0 elsewhere."""
    return torch.where(path < t[:, None], real_tokens, torch.zeros_like(real_tokens))


def oa_ardm_loss(logits: torch.Tensor, real_tokens: torch.Tensor, masked_tokens: torch.Tensor,
                 t: torch.Tensor) -> torch.Tensor:
    """Negative OA-ARDM ELBO estimate: logits (B, L, C); tokens (B, L); t (B,)."""
    L = real_tokens.shape[1]
    logp = F.log_softmax(logits.float(), dim=-1)
    logp_true = logp.gather(-1, real_tokens.long()[..., None])[..., 0]
    unsampled = (masked_tokens == 0).float()
    per_row = (logp_true * unsampled).sum(-1)
    return -(per_row / (L - t.float() + 1.0)).mean()

"""Inpainting, corruption and autocomplete for ProteoScribe.

Port of ``biom3_tpu/diffusion/inpainting.py`` (the reference's
``Stage3_source/sampling_analysis.py``):

  * ``corrupt_samples`` — mask all but the first ``perc·num_steps``
    positions of each row's random path;
  * ``autocomplete`` — one forward fills every masked position;
  * ``make_inpainter`` — resume a corrupted sample's trajectory to the end,
    one position a step, in the path's order or most-certain-first;
  * ``extract_samples_with_labels`` — the dataset filter (numpy).

Token ids are the shifted decode-table ids (0 is the absorbing state).
Randomness comes from a ``torch.Generator``, or from each row's Philox
stream (``key_data``, ``diffusion.sampler.row_gumbel``) so that a row's
fills depend on its key alone; at temperature 0 every draw is the argmax
and the ids equal the JAX package's.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from biom3_tpu_torch.diffusion.oa_ardm import mask_realizations, sample_random_paths
from biom3_tpu_torch.diffusion.sampler import apply_logit_filters, row_gumbel


def corrupt_samples(generator: torch.Generator, real_tokens: torch.Tensor, perc: float,
                    num_steps: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Mask all but the first ``t = perc·num_steps`` path positions.

    real_tokens: (B, L) shifted ids.  Returns (masked, path, t)."""
    B, L = real_tokens.shape
    t = torch.full((B,), int(num_steps * perc), dtype=torch.int64, device=real_tokens.device)
    path = sample_random_paths(generator, B, L, device=real_tokens.device)
    return mask_realizations(real_tokens, path, t), path, t


@torch.no_grad()
def autocomplete(apply_fn: Callable, masked_tokens: torch.Tensor, z_c: torch.Tensor | None,
                 t: torch.Tensor, generator: torch.Generator | None = None
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """One-shot fill of every masked position (ref :21-61): the argmax
    without a generator, a categorical draw with one.  Returns (completed
    tokens, per-position probabilities)."""
    logits = apply_fn(masked_tokens, t, z_c).float()
    probs = torch.softmax(logits, dim=-1)
    if generator is None:
        sampled = logits.argmax(dim=-1)
    else:
        sampled = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                    generator=generator).reshape(probs.shape[:-1])
    completed = torch.where(masked_tokens == 0, sampled.to(masked_tokens.dtype), masked_tokens)
    return completed, probs


def make_inpainter(apply_fn: Callable, num_steps: int, *, temperature: float = 1.0,
                   apply_takes_positions: bool = False, chunk_steps: int | None = None,
                   order: str = "path", early_exit: bool = False, top_k: int | None = None,
                   top_p: float | None = None) -> Callable:
    """Resume-from-t denoiser (JAX ``make_inpainter``): finishes a corrupted
    sample's trajectory position by position.

    ``apply_fn(x (B, L) int32, t (B,) int, z_c)`` → logits (B, L, C); with
    ``apply_takes_positions`` ``apply_fn(x, t, z_c, pos (B, k))`` → (B, k,
    C) at the positions asked for (the stack forward's contract).

    ``order="path"``: at step t each row writes its position with
    ``path == t``, and only from its own ``t0`` on (earlier steps no-op).
    ``order="confidence"``: each step fills the still-masked position (id 0)
    whose conditional is most peaked; ``path`` and ``t0`` are ignored, the
    timestep fed to the model is the row's count of revealed positions
    (clamped to L − 1), and a row with nothing masked no-ops.

    ``chunk_steps`` splits the steps into chunks; ``early_exit`` (which
    needs it) stops once no position is masked, checked on the host
    between chunks — one ``(x == 0).any()`` a chunk, the only sync.  The
    result equals the full run's: steps after the last fill no-op.

    Returns ``inpaint(masked (B, L), z_c, path (B, L), t0 (B,),
    generator=None, *, key_data=None) → (B, L) int32``; ``key_data`` (B,
    2) int64 draws row b's noise at step t from its own Philox stream."""
    if order not in ("path", "confidence"):
        raise ValueError(f"order must be 'path' or 'confidence', got {order!r}")
    if chunk_steps and num_steps % chunk_steps != 0:
        raise ValueError(f"num_steps {num_steps} not divisible by chunk_steps {chunk_steps}")
    chunk = chunk_steps or None
    if early_exit and chunk is None:
        raise ValueError("early_exit needs chunk_steps (the exit check runs between chunk "
                         "dispatches)")

    def draw(lg, t, generator, key_data):
        """One token per row of ``lg`` (B, C) f32."""
        if top_k is not None or top_p is not None:
            lg = apply_logit_filters(lg, top_k=top_k, top_p=top_p)
        if temperature == 0.0:
            return lg.argmax(dim=-1)
        if key_data is not None:
            steps = torch.full((lg.shape[0], 1), t, dtype=torch.int64, device=lg.device)
            return (lg / temperature + row_gumbel(key_data, steps, lg.shape[-1])[:, 0]
                    ).argmax(dim=-1)
        probs = torch.softmax(lg / temperature, dim=-1)
        return torch.multinomial(probs, 1, generator=generator)[:, 0]

    def path_step(x, z_c, path, t0, t, generator, key_data):
        B = x.shape[0]
        tb = torch.full((B,), t, dtype=torch.int32, device=x.device)
        at_t = path == t
        write = at_t & (t >= t0)[:, None]       # rows whose trajectory has reached t
        pos = at_t.int().argmax(dim=1)          # each row's one position of step t
        if apply_takes_positions:
            lg = apply_fn(x, tb, z_c, pos[:, None].to(torch.int32))[:, 0]
        else:
            out = apply_fn(x, tb, z_c)
            lg = out[torch.arange(B, device=x.device), pos]
        smp = draw(lg.float(), t, generator, key_data)
        return torch.where(write, smp[:, None].to(x.dtype), x)

    def conf_step(x, filled, z_c, t, generator, key_data):
        B, L = x.shape
        # the revealed count, clamped to the trained range (a fully revealed
        # row would feed t = L, one past the time-bias table)
        tb = filled.sum(dim=1).clamp(max=L - 1).to(torch.int32)
        if apply_takes_positions:
            pos_all = torch.arange(L, dtype=torch.int32, device=x.device).expand(B, L)
            full = apply_fn(x, tb, z_c, pos_all.contiguous()).float()
        else:
            full = apply_fn(x, tb, z_c).float()
        conf = torch.log_softmax(full, dim=-1).amax(dim=-1).masked_fill(filled, float("-inf"))
        pos = conf.argmax(dim=1)                # ties to the lower index, as jnp.argmax
        smp = draw(full[torch.arange(B, device=x.device), pos], t, generator, key_data)
        # a row with nothing masked must no-op: its argmax over −inf is arbitrary
        wrote = ((pos[:, None] == torch.arange(L, device=x.device)) & ~filled
                 & (~filled).any(dim=1, keepdim=True))
        return torch.where(wrote, smp[:, None].to(x.dtype), x), filled | wrote

    @torch.no_grad()
    def inpaint(masked_tokens, z_c, path, t0, generator: torch.Generator | None = None, *,
                key_data=None):
        if temperature != 0.0 and generator is None and key_data is None:
            raise ValueError("a generator or key_data is required when temperature > 0")
        x = torch.as_tensor(masked_tokens).to(torch.int32)
        filled = x != 0
        if order == "path":
            path = torch.as_tensor(path, device=x.device).long()
            t0 = torch.as_tensor(t0, device=x.device).long()
        n = chunk or num_steps
        for start in range(0, num_steps, n):
            if early_exit and not bool((x == 0).any()):
                break
            for t in range(start, start + n):
                if order == "confidence":
                    x, filled = conf_step(x, filled, z_c, t, generator, key_data)
                else:
                    x = path_step(x, z_c, path, t0, t, generator, key_data)
        return x

    return inpaint


def extract_samples_with_labels(data: np.ndarray, labels: np.ndarray, target_label: int,
                                total_num: int, *, pad_included: bool = False) -> dict:
    """Filter (data, label) pairs by class label (ref :65-92); applies the
    +1 absorbing-state shift unless ids already include it."""
    sel = np.where(np.asarray(labels) == target_label)[0][:total_num]
    samples = np.asarray(data)[sel]
    if not pad_included:
        samples = samples + 1
    return {"sample": list(samples), "label": list(np.asarray(labels)[sel])}

"""Denoising sampler for ProteoScribe (path-ordered OA-ARDM).

Port of ``biom3_tpu/diffusion/sampler.py`` — ``make_sampler`` in path
order and its ``gather_step`` contract (:176-206,264-279),
``apply_logit_filters`` (:36-56) and ``sample_permutations`` (:426):

* start from all-absorbing x = 0;
* at outer step i (time t = i·k) decode the k positions
  ``inv[:, t:t+k]``, where ``inv = argsort(path)`` is the inverse of each
  row's sampling order: forward the model, sample one token per position
  (``temperature=0`` takes the argmax), write it only there.

The steps run as a Python loop, one model call each.  ``chunk_steps`` keeps
the JAX sampler's contract (it must divide the outer step count there,
where it sizes one device dispatch) and is validated the same way; a
Python loop needs no chunking.  Randomness comes from a ``torch.Generator``: at
temperature > 0 the tokens follow the same distribution as the JAX
sampler's, not its bits.
"""

from __future__ import annotations

from typing import Callable

import torch


def apply_logit_filters(logits: torch.Tensor, *, top_k: int | None = None,
                        top_p: float | None = None) -> torch.Tensor:
    """Top-k / nucleus filtering over the last axis."""
    if top_k is not None:
        kth = torch.sort(logits, dim=-1).values[..., -top_k, None]
        logits = logits.masked_fill(logits < kth, float("-inf"))
    if top_p is not None:
        sorted_logits = torch.sort(logits, dim=-1, descending=True).values
        probs = torch.softmax(sorted_logits, dim=-1)
        cum = torch.cumsum(probs, dim=-1)
        # smallest logit still inside the nucleus; the argmax is always kept
        inside = cum - probs < top_p
        inside[..., 0] = True
        min_keep = torch.where(inside, sorted_logits,
                               torch.full_like(sorted_logits, float("inf")))
        min_keep = min_keep.min(dim=-1, keepdim=True).values
        logits = logits.masked_fill(logits < min_keep, float("-inf"))
    return logits


def sample_permutations(generator: torch.Generator, batch: int, length: int) -> torch.Tensor:
    """(batch, length) random sampling orders on the generator's device
    (ref run_ProteoScribe_sample.py:108)."""
    noise = torch.rand((batch, length), generator=generator, device=generator.device)
    return torch.argsort(noise, dim=-1).to(torch.int32)


def make_sampler(apply_fn: Callable, num_steps: int, *, temperature: float = 1.0,
                 chunk_steps: int | None = None, positions_per_step: int = 1,
                 top_k: int | None = None, top_p: float | None = None,
                 apply_takes_positions: bool = False) -> Callable:
    """``apply_fn(x (B, L) int32, t (B,) int, z_c)`` → logits (B, L, C), or
    with ``apply_takes_positions`` ``apply_fn(x, t, z_c, pos (B, k))`` →
    (B, k, C) logits at the decode positions only.

    Returns ``sample(z_c, path, generator=None) → (B, L) int32``."""
    k = positions_per_step
    if num_steps % k:
        raise ValueError(f"num_steps {num_steps} not divisible by k={k}")
    outer = num_steps // k
    chunk = min(chunk_steps or outer, outer)
    if outer % chunk:
        raise ValueError(f"outer steps {outer} not divisible by chunk {chunk}")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")

    def step(z_c, inv, inv32, x, i, generator):
        B = x.shape[0]
        t = i * k
        pos = inv[:, t:t + k]
        t_vec = torch.full((B,), t, dtype=torch.int32, device=x.device)
        if apply_takes_positions:
            picked = apply_fn(x, t_vec, z_c, inv32[:, t:t + k].contiguous())
        else:
            out = apply_fn(x, t_vec, z_c)
            picked = torch.gather(out, 1, pos[..., None].expand(-1, -1, out.shape[-1]))
        lg = picked.float()
        if top_k is not None or top_p is not None:
            lg = apply_logit_filters(lg, top_k=top_k, top_p=top_p)
        if temperature == 0.0:
            smp = lg.argmax(dim=-1)
        else:
            probs = torch.softmax(lg / temperature, dim=-1)
            smp = torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                    generator=generator).reshape(B, k)
        x.scatter_(1, pos, smp.to(x.dtype))

    @torch.no_grad()
    def sample(z_c, path, generator: torch.Generator | None = None):
        if temperature != 0.0 and generator is None:
            raise ValueError("a generator is required when temperature > 0")
        B, L = path.shape
        x = torch.zeros((B, L), dtype=torch.int32, device=path.device)
        inv = torch.argsort(path.long(), dim=-1)
        inv32 = inv.to(torch.int32)
        for i in range(outer):
            step(z_c, inv, inv32, x, i, generator)
        return x

    return sample

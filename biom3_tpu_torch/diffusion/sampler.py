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

``make_chunk_stepper`` (JAX ``:284-423``) is the device half of continuous
batching: each row advances from its own step offset, so rows at different
trajectory phases share one dispatch.  Its randomness must be per row — a
row's tokens may depend only on its own key, whatever shares the dispatch,
so that a seeded request reproduces in any batch mix.  The JAX stepper
keeps one ``jax.random`` key per row.  One ``torch.Generator`` cannot do
that, and a generator per row costs B launches a step.  Here the row's key
is two 32-bit words, and its Gumbel noise is a pure function of (key
words, decode step, class): Philox-4x32-10 (Salmon et al., SC'11) written
in vectorised int64 torch ops (every product split into 16-bit halves, so
nothing overflows), one call per chunk for all its steps.  The key words
never change along a trajectory — the counter carries the position — so the
device carry is the key as given at admission.  Temperature 0 takes the
RNG-free argmax, as in JAX.
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


# Philox-4x32-10 (Salmon, Moraes, Dror, Shaw, "Parallel random numbers: as
# easy as 1, 2, 3", SC'11): round multipliers and Weyl key increments
PHILOX_M = (0xD2511F53, 0xCD9E8D57)
PHILOX_W = (0x9E3779B9, 0xBB67AE85)
MASK32 = 0xFFFFFFFF


def _mulhilo(a: torch.Tensor, m: int):
    """(hi, lo) 32-bit words of a · m for int64 tensors a < 2^32 and a
    32-bit constant m, without an int64 overflow."""
    x = (a >> 16) * m                       # < 2^48
    y = (a & 0xFFFF) * m                    # < 2^48
    z = x + (y >> 16)                       # a·m = z·2^16 + (y & 0xFFFF)
    return z >> 16, ((z & 0xFFFF) << 16) | (y & 0xFFFF)


def philox4x32(ctr, key):
    """Philox-4x32-10 of counters ``ctr`` (four int64 tensors of 32-bit
    words) under ``key`` (two, broadcastable) → four int64 tensors of
    32-bit words."""
    c0, c1, c2, c3 = ctr
    k0, k1 = key
    for _ in range(10):
        hi0, lo0 = _mulhilo(c0, PHILOX_M[0])
        hi1, lo1 = _mulhilo(c2, PHILOX_M[1])
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
        k0, k1 = (k0 + PHILOX_W[0]) & MASK32, (k1 + PHILOX_W[1]) & MASK32
    return c0, c1, c2, c3


def row_gumbel(key_data: torch.Tensor, steps: torch.Tensor, num_classes: int) -> torch.Tensor:
    """Gumbel noise (B, *steps.shape[1:], C) f32: for row b, decode step
    ``steps[b, ...]`` and class c, a function of (key_data[b], step, c)
    alone.  ``key_data`` (B, 2) int64 holds each row's two 32-bit key
    words."""
    B = key_data.shape[0]
    lead = (B,) + (1,) * (steps.dim() - 1) + (1,)
    k0, k1 = (key_data[:, i].reshape(lead) for i in (0, 1))
    cls = torch.arange(num_classes, device=steps.device, dtype=torch.int64)
    s = (steps.long() & MASK32)[..., None]
    zero = torch.zeros_like(s)
    x = philox4x32((s, cls.expand(s.shape[:-1] + (num_classes,)), zero, zero), (k0, k1))[0]
    u = ((x >> 8).float() + 0.5) * 2.0 ** -24            # (0, 1): 24 bits, centred
    return -torch.log(-torch.log(u))


def make_chunk_stepper(apply_fn: Callable, num_steps: int, *, chunk_steps: int,
                       positions_per_step: int = 1, temperature: float = 1.0,
                       top_k: int | None = None, top_p: float | None = None,
                       apply_takes_positions: bool = False) -> Callable:
    """Per-row-offset chunk stepper (JAX ``make_chunk_stepper``).

    Returns ``chunk_fn(z_c (B, C), inv (B, L) int, x (B, L) int32, t0 (B,)
    int, key_data (B, 2) int64, key_data_new (B, 2) int64, fresh (B,) bool
    = t0 == 0) → (x', key_data')``, advancing every row ``chunk_steps``
    outer steps (× ``positions_per_step`` positions each) from its own
    offset ``t0``; every argument is a tensor on the device, and nothing in
    a chunk waits on the device.  Row semantics, as in JAX:

    * ``inv[b, t]`` is the position row ``b`` decodes at step ``t``;
    * a ``fresh`` row is reset on the device — ``x`` to the absorbing state
      0, its key to ``key_data_new`` — so the scheduler keeps both carries on
      the device across chunks;
    * rows with ``t0 >= num_steps`` are inert: they compute but never
      write; with k > 1 a step straddling ``num_steps`` writes only its
      positions before it;
    * a row's noise depends only on its key (``row_gumbel``), so a seeded
      row reproduces in any batch mix; temperature 0 takes the argmax.
    """
    k = positions_per_step
    if num_steps % k:
        raise ValueError(f"num_steps {num_steps} not divisible by k={k}")
    outer = num_steps // k
    if chunk_steps < 1 or outer % chunk_steps:
        raise ValueError(f"outer steps {outer} not divisible by chunk {chunk_steps}")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")

    @torch.no_grad()
    def chunk_fn(z_c, inv, x, t0, key_data, key_data_new, fresh=None):
        B, L = x.shape
        dev = x.device
        if fresh is None:
            fresh = t0 == 0
        x = torch.where(fresh[:, None], torch.zeros_like(x), x)
        key_data = torch.where(fresh[:, None], key_data_new, key_data)
        t0 = t0.long()
        offs = torch.arange(k, device=dev)
        lpos = torch.arange(L, device=dev)
        noise = None
        for i in range(chunk_steps):
            t = t0 + i * k
            tm = t.clamp(max=num_steps - 1)
            steps_k = tm[:, None] + offs[None, :]
            active = (t[:, None] < num_steps) & (steps_k < num_steps)
            pos = torch.gather(inv, 1, steps_k.clamp(max=L - 1))
            if apply_takes_positions:
                picked = apply_fn(x, tm, z_c, pos)
            else:
                out = apply_fn(x, tm, z_c)
                picked = torch.gather(out, 1, pos[..., None].expand(-1, -1, out.shape[-1]))
            lg = picked.float()
            if top_k is not None or top_p is not None:
                lg = apply_logit_filters(lg, top_k=top_k, top_p=top_p)
            if temperature == 0.0:
                smp = lg.argmax(dim=-1)
            else:
                if noise is None:   # every decode step of the chunk: (B, chunk, k, C)
                    steps = (t0[:, None, None] + offs
                             + (torch.arange(chunk_steps, device=dev) * k)[None, :, None])
                    noise = row_gumbel(key_data, steps, lg.shape[-1])
                smp = (lg / temperature + noise[:, i]).argmax(dim=-1)
            # one-hot write, masked per position: inert rows and straddling
            # tails (whose clamped positions repeat) write nothing
            oh = (pos[:, :, None] == lpos) & active[:, :, None]
            new_vals = (oh * smp[:, :, None]).sum(1).to(x.dtype)
            x = torch.where(oh.any(1), new_vals, x)
        return x, key_data

    return chunk_fn

"""Denoising samplers for ProteoScribe.

Port of ``biom3_tpu/diffusion/sampler.py``: ``make_sampler`` (:59-281) in
its three modes, ``apply_logit_filters`` (:36-56),
``sample_permutations`` (:426), ``make_chunk_stepper`` (:284-423) and
``make_maskgit_sampler`` (:432-558).

* path order (OA-ARDM, the reference): start from all-absorbing x = 0; at
  outer step i (time t = i·k) decode the k positions ``inv[:, t:t+k]``,
  where ``inv = argsort(path)`` is the inverse of each row's sampling
  order: forward the model, sample one token per position
  (``temperature=0`` takes the argmax), write it only there;
* confidence order: each forward sees every position, and the k
  still-masked ones whose conditionals are most peaked are decoded;
* legacy replay: the reference's batched-update quirk (SURVEY.md Q5);
* MaskGIT: every position sampled each step, the most confident committed
  by a cosine schedule, L tokens in a few forwards.

Where JAX takes ``jax.lax.top_k`` or ``jnp.argsort`` the port sorts stably
(``torch.sort(stable=True)``), so ties go to the lower index as there;
log-softmax and the comparisons run in f32.

The steps run as a Python loop, one model call each.  ``chunk_steps`` keeps
the JAX sampler's contract (it must divide the outer step count there,
where it sizes one device dispatch) and is validated the same way; a
Python loop needs no chunking.  Randomness comes from a ``torch.Generator``: at
temperature > 0 the tokens follow the same distribution as the JAX
sampler's, not its bits.

``make_chunk_stepper`` (JAX ``:284-423``) is the device half of continuous
batching: each row advances from its own step offset, so rows at different
trajectory phases share one dispatch, and an inpaint row enters with its
partial sequence (``x_new``) as generate rows enter with zeros.  Its randomness must be per row — a
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

import math
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


def _gumbel(generator: torch.Generator, shape, device) -> torch.Tensor:
    """Standard Gumbel noise (f32) drawn from ``generator``."""
    u = torch.rand(shape, generator=generator, device=device)
    return -torch.log(-torch.log(u.clamp(min=torch.finfo(torch.float32).tiny)))


def _positions(B: int, L: int, device) -> torch.Tensor:
    """(B, L) int32: every position, the full-grid gather of the stack."""
    return torch.arange(L, dtype=torch.int32, device=device).expand(B, L).contiguous()


def make_sampler(apply_fn: Callable, num_steps: int, *, temperature: float = 1.0,
                 legacy_batch_update: bool = False, return_trajectory: bool = False,
                 chunk_steps: int | None = None, positions_per_step: int = 1,
                 top_k: int | None = None, top_p: float | None = None,
                 head_fn: Callable | None = None, apply_takes_positions: bool = False,
                 order: str = "path") -> Callable:
    """``apply_fn(x (B, L) int32, t (B,) int, z_c)`` → logits (B, L, C); with
    ``head_fn(h) → logits`` it returns the final hidden states (B, L, D)
    instead and the head runs on the gathered positions only; with
    ``apply_takes_positions`` ``apply_fn(x, t, z_c, pos (B, k))`` → (B, k,
    C) logits at the decode positions.

    ``order="path"`` decodes each row's sampled order; ``"confidence"``
    (JAX ``confidence_step``) scores every still-masked position of the
    full logit grid by its peakedness, max log-softmax, and decodes the k
    most certain (ties to the lower index, as ``jax.lax.top_k``); ``path``
    is then ignored.  ``legacy_batch_update`` replays the reference's
    batched-update quirk (SURVEY.md Q5): at step t every row writes its
    sampled token at the union of all rows' step-t positions; it needs the
    full grid (no ``head_fn``, no positions) and k = 1.

    Returns ``sample(z_c, path, generator=None, *, key_data=None) → (B, L)
    int32``, or ``(x, traj)`` with ``traj`` (outer steps, B, L) under
    ``return_trajectory``.  ``key_data`` (B, 2) int64 draws the noise of
    the new modes from each row's Philox stream (``row_gumbel``) instead
    of the generator, so a row's tokens depend on its key alone."""
    if order not in ("path", "confidence"):
        raise ValueError(f"order must be 'path' or 'confidence', got {order!r}")
    if order == "confidence" and legacy_batch_update:
        raise ValueError("legacy_batch_update replays Q5's random-order quirk; "
                         "incompatible with confidence ordering")
    k = positions_per_step
    if num_steps % k:
        raise ValueError(f"num_steps {num_steps} not divisible by k={k}")
    outer = num_steps // k
    chunk = min(chunk_steps or outer, outer)
    if outer % chunk:
        raise ValueError(f"outer steps {outer} not divisible by chunk {chunk}")
    if legacy_batch_update and k != 1:
        raise ValueError("legacy_batch_update requires positions_per_step=1")
    if legacy_batch_update and head_fn is not None:
        raise ValueError("legacy_batch_update needs full-grid logits; drop head_fn")
    if apply_takes_positions and (legacy_batch_update or head_fn is not None):
        raise ValueError("apply_takes_positions is a complete contract — incompatible "
                         "with legacy_batch_update/head_fn")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")

    def forward_at(x, t_vec, z_c, pos, pos32):
        """(B, k, C) f32 logits at ``pos``."""
        if apply_takes_positions:
            return apply_fn(x, t_vec, z_c, pos32).float()
        out = apply_fn(x, t_vec, z_c)
        picked = torch.gather(out, 1, pos[..., None].expand(-1, -1, out.shape[-1]))
        return (picked if head_fn is None else head_fn(picked)).float()

    def full_grid(x, t_vec, z_c):
        """(B, L, C) f32 logits at every position."""
        B, L = x.shape
        if apply_takes_positions:
            return apply_fn(x, t_vec, z_c, _positions(B, L, x.device)).float()
        out = apply_fn(x, t_vec, z_c)
        return (out if head_fn is None else head_fn(out)).float()

    def draw(lg, generator, key_data, t):
        """One token per row of ``lg`` (B, n, C): argmax at temperature 0,
        else a categorical draw (the generator's multinomial, or Gumbel-max
        on the rows' Philox streams at decode steps t .. t + n - 1)."""
        if top_k is not None or top_p is not None:
            lg = apply_logit_filters(lg, top_k=top_k, top_p=top_p)
        if temperature == 0.0:
            return lg.argmax(dim=-1)
        if key_data is not None:
            B, n, C = lg.shape
            steps = (t + torch.arange(n, device=lg.device)).expand(B, n)
            return (lg / temperature + row_gumbel(key_data, steps, C)).argmax(dim=-1)
        probs = torch.softmax(lg / temperature, dim=-1)
        return torch.multinomial(probs.reshape(-1, probs.shape[-1]), 1,
                                 generator=generator).reshape(lg.shape[:-1])

    def path_step(z_c, inv, inv32, x, i, generator):
        B = x.shape[0]
        t = i * k
        t_vec = torch.full((B,), t, dtype=torch.int32, device=x.device)
        pos = inv[:, t:t + k]
        lg = forward_at(x, t_vec, z_c, pos, inv32[:, t:t + k].contiguous())
        x.scatter_(1, pos, draw(lg, generator, None, t).to(x.dtype))

    def legacy_step(z_c, path, x, t, generator):
        B = x.shape[0]
        t_vec = torch.full((B,), t, dtype=torch.int32, device=x.device)
        lg = apply_fn(x, t_vec, z_c).float()
        sampled = draw(lg, generator, None, t)
        write = (path == t).any(dim=0)[None, :]            # union over the batch (Q5)
        x.copy_(torch.where(write, sampled.to(x.dtype), x))

    def confidence_step(z_c, x, filled, i, generator, key_data):
        B = x.shape[0]
        t = i * k
        t_vec = torch.full((B,), t, dtype=torch.int32, device=x.device)
        full = full_grid(x, t_vec, z_c)
        conf = torch.log_softmax(full, dim=-1).amax(dim=-1)
        conf = conf.masked_fill(filled, float("-inf"))
        pos = torch.sort(conf, dim=1, descending=True, stable=True).indices[:, :k]
        lg = torch.gather(full, 1, pos[..., None].expand(-1, -1, full.shape[-1]))
        x.scatter_(1, pos, draw(lg, generator, key_data, t).to(x.dtype))
        filled.scatter_(1, pos, True)

    @torch.no_grad()
    def sample(z_c, path, generator: torch.Generator | None = None, *, key_data=None):
        if temperature != 0.0 and generator is None and key_data is None:
            raise ValueError("a generator is required when temperature > 0")
        if key_data is not None and (legacy_batch_update or order == "path"):
            raise ValueError("key_data streams serve confidence order; path order's are "
                             "make_chunk_stepper's")
        B, L = path.shape
        x = torch.zeros((B, L), dtype=torch.int32, device=path.device)
        traj = []
        if legacy_batch_update:
            for t in range(num_steps):
                legacy_step(z_c, path, x, t, generator)
                if return_trajectory:
                    traj.append(x.clone())
        elif order == "confidence":
            filled = torch.zeros((B, L), dtype=torch.bool, device=path.device)
            for i in range(outer):
                confidence_step(z_c, x, filled, i, generator, key_data)
                if return_trajectory:
                    traj.append(x.clone())
        else:
            inv = torch.argsort(path.long(), dim=-1)
            inv32 = inv.to(torch.int32)
            for i in range(outer):
                path_step(z_c, inv, inv32, x, i, generator)
                if return_trajectory:
                    traj.append(x.clone())
        return (x, torch.stack(traj)) if return_trajectory else x

    return sample


def maskgit_schedule(L: int, steps: int) -> list[int]:
    """Masked positions left after each MaskGIT step: ceil(L·cos(π/2·s/S)),
    the last 0, made strictly decreasing (every step commits at least one)."""
    m = [int(math.ceil(L * math.cos(math.pi / 2 * s / steps))) for s in range(1, steps + 1)]
    m[-1] = 0
    for i in range(steps - 2, -1, -1):
        m[i] = max(m[i], m[i + 1] + 1)
    return m


# counter words of the MaskGIT row streams (``row_gumbel``'s ``stream``):
# the token draw and the commit ranking's noise
MASKGIT_TOKEN_STREAM, MASKGIT_RANK_STREAM = 1, 2


def make_maskgit_sampler(apply_fn: Callable, num_positions: int, *, steps: int = 16,
                         temperature: float = 1.0, choice_temperature: float = 4.5,
                         top_k: int | None = None, top_p: float | None = None,
                         head_fn: Callable | None = None,
                         apply_takes_positions: bool = False) -> Callable:
    """Parallel iterative re-masking (MaskGIT, Chang et al. 2022; JAX
    ``make_maskgit_sampler``): L tokens in ``steps`` forwards.  Each step
    samples every position from the current conditional (full logit grid),
    commits the most confident — the committed positions first, then by the
    sampled token's log-probability plus Gumbel noise annealed from
    ``choice_temperature`` to 0 — up to L − m_s of ``maskgit_schedule``,
    and re-masks the rest to 0.  The model's timestep is each row's
    committed count, clamped to L − 1.  Committed tokens never change.

    Returns ``sample(z_c, path=None, generator=None, *, x0=None,
    key_data=None) → (B, L) int32``: ``path`` is ignored; ``x0`` (B, L)
    resumes from a partial sequence whose nonzero positions are committed;
    ``key_data`` (B, 2) int64 draws the noise from each row's Philox
    streams (token and rank streams apart, counters (step, class,
    position)) instead of the generator."""
    L = num_positions
    if steps < 1 or steps > L:
        raise ValueError(f"steps must be in [1, {L}], got {steps}")
    if temperature < 0.0:
        raise ValueError(f"temperature must be >= 0, got {temperature}")
    mask_schedule = maskgit_schedule(L, steps)
    anneal = [choice_temperature * (1.0 - (s + 1) / steps) for s in range(steps)]

    def logits(x, t, z_c):
        B = x.shape[0]
        if apply_takes_positions:
            return apply_fn(x, t, z_c, _positions(B, L, x.device)).float()
        out = apply_fn(x, t, z_c)
        return (out if head_fn is None else head_fn(out)).float()

    def step(z_c, x, filled, s, generator, key_data):
        B = x.shape[0]
        committed = filled.sum(dim=1)
        # the committed count conditions the model, clamped to the trained
        # range; the unclamped count floors the keep target below
        t = committed.clamp(max=L - 1).to(torch.int32)
        lg = logits(x, t, z_c)
        if top_k is not None or top_p is not None:
            lg = apply_logit_filters(lg, top_k=top_k, top_p=top_p)
        logp = torch.log_softmax(lg, dim=-1)
        lane = torch.arange(L, device=x.device).expand(B, L)
        step_ids = torch.full((B, L), s, dtype=torch.int64, device=x.device)
        if temperature == 0.0:
            smp = lg.argmax(dim=-1)
        elif key_data is not None:
            g = row_gumbel(key_data, step_ids, lg.shape[-1], lane=lane,
                           stream=MASKGIT_TOKEN_STREAM)
            smp = (lg / temperature + g).argmax(dim=-1)
        else:
            smp = (lg / temperature + _gumbel(generator, lg.shape, x.device)).argmax(dim=-1)
        conf = torch.gather(logp, -1, smp[..., None])[..., 0]
        if temperature != 0.0 and choice_temperature > 0.0:
            if key_data is not None:
                g = row_gumbel(key_data, step_ids, 1, lane=lane, stream=MASKGIT_RANK_STREAM)[..., 0]
            else:
                g = _gumbel(generator, conf.shape, x.device)
            conf = conf + anneal[s] * g
        # committed positions outrank every candidate and are never
        # re-masked (the keep target floors at the committed count)
        conf = conf.masked_fill(filled, float("inf"))
        order = torch.argsort(-conf, dim=1, stable=True)
        rank = torch.argsort(order, dim=1, stable=True)
        target = torch.clamp(committed, min=L - mask_schedule[s])
        new_filled = rank < target[:, None]
        x = torch.where(new_filled, torch.where(filled, x, smp.to(x.dtype)), torch.zeros_like(x))
        return x, new_filled

    @torch.no_grad()
    def sample(z_c, path=None, generator: torch.Generator | None = None, *, x0=None,
               key_data=None):
        if temperature != 0.0 and generator is None and key_data is None:
            raise ValueError("a generator or key_data is required when temperature > 0")
        B = z_c.shape[0]
        if x0 is None:
            x = torch.zeros((B, L), dtype=torch.int32, device=z_c.device)
        else:
            x = torch.as_tensor(x0, device=z_c.device).to(torch.int32)
        filled = x != 0
        for s in range(steps):
            x, filled = step(z_c, x, filled, s, generator, key_data)
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


def row_gumbel(key_data: torch.Tensor, steps: torch.Tensor, num_classes: int, *,
               lane: torch.Tensor | None = None, stream: int = 0) -> torch.Tensor:
    """Gumbel noise (B, *steps.shape[1:], C) f32: for row b, decode step
    ``steps[b, ...]`` and class c, a function of (key_data[b], step, c)
    alone — the Philox counter is (step, class, lane, stream), ``lane``
    (shaped as ``steps``, default 0) a further word such as a position, and
    ``stream`` keeps apart draws that share the other three.  ``key_data``
    (B, 2) int64 holds each row's two 32-bit key words."""
    B = key_data.shape[0]
    lead = (B,) + (1,) * (steps.dim() - 1) + (1,)
    k0, k1 = (key_data[:, i].reshape(lead) for i in (0, 1))
    cls = torch.arange(num_classes, device=steps.device, dtype=torch.int64)
    s = (steps.long() & MASK32)[..., None]
    zero = torch.zeros_like(s)
    word2 = zero if lane is None else (lane.long() & MASK32)[..., None]
    x = philox4x32((s, cls.expand(s.shape[:-1] + (num_classes,)), word2, zero + stream),
                   (k0, k1))[0]
    u = ((x >> 8).float() + 0.5) * 2.0 ** -24            # (0, 1): 24 bits, centred
    return -torch.log(-torch.log(u))


def make_chunk_stepper(apply_fn: Callable, num_steps: int, *, chunk_steps: int,
                       positions_per_step: int = 1, temperature: float = 1.0,
                       top_k: int | None = None, top_p: float | None = None,
                       apply_takes_positions: bool = False) -> Callable:
    """Per-row-offset chunk stepper (JAX ``make_chunk_stepper``).

    Returns ``chunk_fn(z_c (B, C), inv (B, L) int, x (B, L) int32, t0 (B,)
    int, key_data (B, 2) int64, key_data_new (B, 2) int64, fresh (B,) bool
    = t0 == 0, x_new (B, L) int32 = zeros) → (x', key_data')``, advancing
    every row ``chunk_steps`` outer steps (× ``positions_per_step``
    positions each) from its own offset ``t0``; every argument is a tensor
    on the device, and nothing in a chunk waits on the device.  Row
    semantics, as in JAX:

    * ``inv[b, t]`` is the position row ``b`` decodes at step ``t``;
    * a ``fresh`` row is reset on the device — ``x`` to ``x_new`` (the
      absorbing state 0 to generate; a partial sequence for an inpaint row,
      which starts at ``t0 = num_steps − n_masked`` with its masked
      positions on the ``inv`` tail), its key to ``key_data_new`` — so the
      scheduler keeps both carries on the device across chunks;
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
    def chunk_fn(z_c, inv, x, t0, key_data, key_data_new, fresh=None, x_new=None):
        B, L = x.shape
        dev = x.device
        if fresh is None:
            fresh = t0 == 0
        x = torch.where(fresh[:, None], torch.zeros_like(x) if x_new is None else x_new, x)
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

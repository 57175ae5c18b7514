"""Ring attention: exact softmax attention with the sequence over a mesh axis.

Port of ``biom3_tpu/ops/ring_attention.py:26-110``.  q, k and v split along
L over the positions of one mesh axis (the other axes at index 0); each
position keeps its query block and an f32 online-softmax state while the
key/value blocks and their PAD masks travel round the ring, one position
on per hop (JAX ``lax.ppermute`` with ``perm = (i, i+1 mod n)``: here a
copy to the next position's device).  After n hops every query block has
seen every key, so the result is full attention, with O(L/n) score memory
a position.

The numerics are JAX's: scores in f32, PAD keys at -1e9 (not -inf, so an
all-PAD block still normalizes), the running max starting at -inf, and
``acc / s`` cast to v's dtype.  The per-hop products are ``torch.matmul``
(JAX computes them as ``einsum`` outside any Pallas kernel).  Every step is
a torch op, so the function is differentiable through autograd.
"""

from __future__ import annotations

import torch

from biom3_tpu_torch.parallel.sharding import device_context

NEG_INF = -1e9


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mesh, *,
                   axis: str = "tp", padding_mask: torch.Tensor | None = None) -> torch.Tensor:
    """q, k, v (B, H, L, D); padding_mask (B, L), True at PAD keys →
    (B, H, L, D) on q's device.  L must divide by the axis size."""
    devices = mesh.axis_devices(axis)
    n = len(devices)
    B, H, L, D = q.shape
    if L % n:
        raise ValueError(f"sequence length {L} not divisible by the {n} positions of mesh "
                         f"axis {axis!r}")
    if padding_mask is None:
        padding_mask = torch.zeros((B, L), dtype=torch.bool, device=q.device)
    scale = D ** -0.5
    Ls = L // n
    blocks = [(d, slice(i * Ls, (i + 1) * Ls)) for i, d in enumerate(devices)]
    qs = [(q[:, :, s].to(d).float() * scale) for d, s in blocks]
    kv = [(k[:, :, s].to(d), v[:, :, s].to(d), padding_mask[:, s].to(d)) for d, s in blocks]
    state = [(torch.full((B, H, Ls, 1), float("-inf"), device=d),
              torch.zeros((B, H, Ls, 1), device=d),
              torch.zeros((B, H, Ls, D), device=d)) for d, _ in blocks]
    for hop in range(n):
        for i, (d, _) in enumerate(blocks):
            k_cur, v_cur, mask_cur = kv[i]
            m, s, acc = state[i]
            with device_context(d):
                dots = qs[i] @ k_cur.float().transpose(-1, -2)
                dots = dots.masked_fill(mask_cur[:, None, None, :], NEG_INF)
                m_new = torch.maximum(m, dots.amax(-1, keepdim=True))
                corr = torch.exp(m - m_new)
                e = torch.exp(dots - m_new)
                state[i] = (m_new, s * corr + e.sum(-1, keepdim=True),
                            acc * corr + e @ v_cur.float())
        if hop < n - 1:   # position i's key/value block moves on to position i + 1
            kv = [tuple(t.to(blocks[i][0], non_blocking=True) for t in kv[i - 1])
                  for i in range(n)]
    return torch.cat([(acc / s).to(v.dtype).to(q.device) for _, s, acc in state], dim=2)

"""Ring attention: exact softmax attention with the sequence over a mesh axis.

Port of ``biom3_tpu/ops/ring_attention.py:26-110``.  ``ring_attention`` is
one process over the positions of its own mesh; ``ring_attention_sharded``
is the per-rank body for a group that spans processes.  q, k and v split along
L over the positions of one mesh axis (the other axes at index 0); each
position keeps its query block and an f32 online-softmax state while the
key/value blocks and their PAD masks travel round the ring, one position
on per hop (JAX ``lax.ppermute`` with ``perm = (i, i+1 mod n)``: here a
copy to the next position's device).  After n hops every query block has
seen every key, so the result is full attention, with O(L/n) score memory
a position.  In ``ring_attention_sharded`` each rank of a
``torch.distributed`` group holds one block, and the blocks travel by
point-to-point sends (JAX's ``lax.ppermute`` inside ``shard_map``).

The numerics are JAX's: scores in f32, PAD keys at -1e9 (not -inf, so an
all-PAD block still normalizes), the running max starting at -inf, and
``acc / s`` cast to v's dtype.  The per-hop products are ``torch.matmul``
(JAX computes them as ``einsum`` outside any Pallas kernel).  Every step is
a torch op, so the function is differentiable through autograd.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

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


class _Ring:
    """One rank's place in ``group``'s ring: the exchange that sends
    tensors to the next rank and receives the previous rank's.  gloo sends
    and receives host tensors only, so a CUDA tensor on a gloo group goes
    through host buffers; NCCL sends device tensors as they are."""

    def __init__(self, group):
        self.group = group
        self.n = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.staged = dist.get_backend(group) == "gloo"

    def start(self, tensors, *, backward: bool = False) -> tuple[list, list]:
        """Post the sends of ``tensors`` to the next rank (the previous one
        when ``backward``) and the receives from the other side → (receive
        buffers, pending works)."""
        step = -1 if backward else 1
        to, frm = (self.rank + step) % self.n, (self.rank - step) % self.n
        # a bool mask travels as bytes
        sends = [t.detach().contiguous().view(torch.uint8) if t.dtype == torch.bool
                 else t.detach().contiguous() for t in tensors]
        if self.staged:
            sends = [t.cpu() for t in sends]
        recvs = [torch.empty_like(t) for t in sends]
        ops = [dist.P2POp(dist.isend, t, group=self.group, group_peer=to) for t in sends]
        ops += [dist.P2POp(dist.irecv, t, group=self.group, group_peer=frm) for t in recvs]
        return recvs, (dist.batch_isend_irecv(ops), sends)

    @staticmethod
    def finish(recvs, pending, like) -> list:
        """Wait for ``start``'s works → the received tensors on the devices
        of ``like``."""
        for work in pending[0]:
            work.wait()
        return [r.to(t.device).view(t.dtype) for r, t in zip(recvs, like)]


class _Hop(torch.autograd.Function):
    """k, v and the PAD mask from the previous rank of the ring, posted
    before the hop's products (``wait`` collects them after).  The
    backward sends the received blocks' gradients the other way round."""

    @staticmethod
    def forward(ctx, ring, box, k, v, mask):
        ctx.ring = ring
        recvs, pending = ring.start((k, v, mask))
        box["wait"] = lambda: _Ring.finish(recvs, pending, (k, v, mask))
        out = tuple(torch.empty_like(t) for t in (k, v, mask))
        ctx.mark_non_differentiable(out[2])
        return out

    @staticmethod
    def backward(ctx, dk, dv, _):
        like = [dk, dv]
        recvs, pending = ctx.ring.start(like, backward=True)
        dk_prev, dv_prev = _Ring.finish(recvs, pending, like)
        return None, None, dk_prev, dv_prev, None


def _hop(ring, k, v, mask):
    """Start the hop → a function that waits for it and returns the next
    (k, v, mask), holding the autograd link to this rank's blocks."""
    box = {}
    k_next, v_next, mask_next = _Hop.apply(ring, box, k, v, mask)

    def wait():
        with torch.no_grad():
            for dst, src in zip((k_next, v_next, mask_next), box["wait"]()):
                dst.detach().copy_(src)
        return k_next, v_next, mask_next

    return wait


def ring_attention_sharded(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group=None,
                           padding_mask: torch.Tensor | None = None,
                           scale: float | None = None) -> torch.Tensor:
    """Per-rank body (JAX ``ring_attention_sharded``): q, k, v (B, H,
    L_shard, D) of this rank of ``group`` (default the whole world), rank
    r holding the sequence's block r; ``padding_mask`` (B, L_shard), True
    at this block's PAD keys → this block's (B, H, L_shard, D) output.

    Each rank keeps its query block and an f32 (m, s, acc) state; on hop h
    it posts its current key/value block and mask to rank r + 1 and the
    receive from rank r − 1, computes the hop's products while they
    travel, then takes the received block.  Hop n − 1 sends nothing.  The
    function is differentiable: a hop's backward sends the received
    blocks' gradients back to the rank they came from."""
    ring = _Ring(group)
    B, H, Ls, D = q.shape
    scale = D ** -0.5 if scale is None else scale
    if padding_mask is None:
        padding_mask = torch.zeros((B, Ls), dtype=torch.bool, device=q.device)
    qf = q.float() * scale
    m = torch.full((B, H, Ls, 1), float("-inf"), device=q.device)
    s = torch.zeros((B, H, Ls, 1), device=q.device)
    acc = torch.zeros((B, H, Ls, D), device=q.device)
    k_cur, v_cur, mask_cur = k, v, padding_mask
    for hop in range(ring.n):
        wait = _hop(ring, k_cur, v_cur, mask_cur) if hop < ring.n - 1 else None
        dots = qf @ k_cur.float().transpose(-1, -2)
        dots = dots.masked_fill(mask_cur[:, None, None, :], NEG_INF)
        m_new = torch.maximum(m, dots.amax(-1, keepdim=True))
        corr = torch.exp(m - m_new)
        e = torch.exp(dots - m_new)
        m, s, acc = m_new, s * corr + e.sum(-1, keepdim=True), acc * corr + e @ v_cur.float()
        if wait is not None:
            k_cur, v_cur, mask_cur = wait()
    return (acc / s).to(v.dtype)

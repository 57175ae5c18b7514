"""Local (sliding-window, bucketed) attention — plain PyTorch.

Port of ``biom3_tpu/ops/local_attention.py:45-85`` (lucidrains
``local_attention``, non-causal, look_backward = look_forward = 1): each
window of W queries attends to the keys of windows w-1, w, w+1 under one
softmax, with out-of-range windows masked at -1e9.  Used by the plain
``models/proteoscribe.py`` and as the plain version of the band-local heads
of ``ops.kernels.stage3_attention_core``.

``impl="plain"`` is the JAX package's ``impl="xla"``; ``impl="kernel"`` is
its ``impl="pallas"``: the ``local_window_attention`` kernel
(``csrc/local_attn.cu``), forward only, at the Pallas kernel's rounding
points (on a CPU tensor its wrapper runs the same plain math).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

NEG_INF = -1e9


def _band_mask(num_windows: int, window: int, device) -> torch.Tensor:
    """(num_windows, 3·window) bool mask; True = masked (out of range)."""
    w_idx = torch.arange(num_windows, device=device)[:, None]
    k_win = w_idx + torch.arange(3, device=device)[None, :] - 1
    invalid = (k_win < 0) | (k_win >= num_windows)
    return invalid.repeat_interleave(window, dim=-1)


def _look_around(x: torch.Tensor) -> torch.Tensor:
    """(..., nw, W, D) → (..., nw, 3W, D): [prev, self, next] window concat."""
    padded = F.pad(x, (0, 0, 0, 0, 1, 1))
    nw = x.shape[-3]
    return torch.cat([padded[..., 0:nw, :, :], padded[..., 1:nw + 1, :, :],
                      padded[..., 2:nw + 2, :, :]], dim=-2)


IMPLS = ("plain", "kernel")


def local_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           window: int, impl: str = "plain") -> torch.Tensor:
    """q, k, v: (..., L, D) with L % window == 0 → (..., L, D).  Scores and
    softmax in f32; the probabilities are cast to v's dtype before the
    value product, as the reference does in bf16.  ``impl="kernel"`` takes
    (B, H, L, D) and runs the kernel."""
    if impl not in IMPLS:
        raise ValueError(f"local attention impl must be one of {IMPLS}, got {impl!r}")
    if impl == "kernel":
        from biom3_tpu_torch.ops import kernels   # kernels imports this module

        return kernels.local_window_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                              window=window)
    *lead, L, D = q.shape
    if L % window:
        raise ValueError(f"sequence length {L} not divisible by window {window}")
    nw = L // window
    dtype = v.dtype

    def bucket(x):
        return x.reshape(*lead, nw, window, D).float()

    bq, bk, bv = bucket(q), _look_around(bucket(k)), _look_around(bucket(v))
    dots = (bq @ bk.transpose(-1, -2)) * D ** -0.5
    dots = dots.masked_fill(_band_mask(nw, window, q.device)[:, None, :], NEG_INF)
    attn = torch.softmax(dots, dim=-1).to(dtype).float()
    return (attn @ bv).reshape(*lead, L, D).to(dtype)

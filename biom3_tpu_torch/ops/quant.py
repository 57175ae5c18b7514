"""Shared int8 quantization helpers of the serving stacks.

The port's copy of ``biom3_tpu/ops/pallas/quant.py`` in torch, equal to it
bit for bit (``tests/test_torch_quant.py``).  Scheme (the standard weight-
only + dynamic-activation GEMM recipe): weights are per-out-channel
symmetric int8 (``w ≈ q · s``, contracted axis kept full precision in the
scale); activations are quantized per token (per row — or per column in
the transposed layouts) right before each matmul, the product accumulates
in int32, and the two rank-1 scale vectors fuse into a single f32 rescale
of the int32 accumulator.  On the card the dynamic quant is the
``quant_rows`` kernel and the product ``gemm_i8`` (``ops/kernels.py``);
these functions are their plain form and the packing step.
"""

from __future__ import annotations

import torch


def _div(a, b) -> torch.Tensor:
    """IEEE a / b in f32, one of them a Python number.  Torch computes
    ``127 / t`` as ``t.reciprocal() * 127``, and on the card multiplies a
    tensor by the reciprocal of a Python divisor: both round twice, where
    JAX and the kernels divide once."""
    like = a if isinstance(a, torch.Tensor) else b
    a, b = (x if isinstance(x, torch.Tensor)
            else torch.tensor(x, dtype=torch.float32, device=like.device) for x in (a, b))
    return torch.div(a, b)


def quantize_weight_int8(w: torch.Tensor):
    """Per-out-channel symmetric int8: w ≈ q · s with s = amax_col/127.

    ``w`` is (..., in, out); returns (q int8 same shape, s f32 (..., out)).
    Contracted axis stays full precision in the scale — the standard
    weight-only GEMM quantization."""
    w = w.float()
    s = _div(torch.clamp(w.abs().amax(dim=-2, keepdim=True), min=1e-12), 127.0)
    q = torch.clamp(torch.round(w / s), -127, 127).to(torch.int8)
    return q, s.squeeze(-2)


def quant_rows(z: torch.Tensor):
    """Dynamic per-row symmetric int8: z ≈ q · a with a = amax_row/127.

    For (tokens, features) activations ahead of a row-contracting matmul;
    returns (q int8, a f32 (rows, 1)).  amax is computed in f32 — bf16
    inputs would otherwise round BOTH the quant multiplier and the dequant
    scale independently (~2^-9 each, non-cancelling)."""
    zf = z.float()
    amax = torch.clamp(zf.abs().amax(dim=1, keepdim=True), min=1e-6)
    q = torch.clamp(torch.round(zf * _div(127.0, amax)), -127.0, 127.0).to(torch.int8)
    return q, amax * (1.0 / 127.0)


def quant_cols(z: torch.Tensor):
    """Per-column twin of :func:`quant_rows` for transposed
    (features, tokens) activations; returns (q int8, a f32 (1, cols))."""
    zf = z.float()
    amax = torch.clamp(zf.abs().amax(dim=0, keepdim=True), min=1e-6)
    q = torch.clamp(torch.round(zf * _div(127.0, amax)), -127.0, 127.0).to(torch.int8)
    return q, amax * (1.0 / 127.0)

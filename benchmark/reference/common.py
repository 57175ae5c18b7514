"""Shared pieces of the plain references: the precision policy of their matrix
products, LayerNorm, GELU and the seeded-weight layout rules.

Every reference runs in float32 with TF32 off (``strict_f32``).  A
``Precision`` decides how each matrix product is computed:

* ``Precision()`` — float32, the reference itself;
* ``Precision(bits=4, kinds=("proj", "ff"))`` — the products the program runs
  in int8 computed with int4 codes instead (symmetric, per output channel for
  the weight, per row for the activation), the rest in float32: the control
  of a cell whose program states int8 products;
* ``Precision(bits=8, kinds=ALL_KINDS)`` — every product with int8 codes, the
  gradients' products too: the control of a cell whose program trains in
  bfloat16.

Nothing here imports the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

ALL_KINDS = ("proj", "ff", "head", "cond", "attn")


def strict_f32() -> None:
    """Float32 products stay float32 on the card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fake_quant(x: torch.Tensor, bits: int, dim: int = -1) -> torch.Tensor:
    """Symmetric round-to-nearest codes of ``bits`` bits with one scale per
    slice along ``dim`` (its amax), returned dequantized in float32."""
    qmax = 2 ** (bits - 1) - 1
    x = x.float()
    scale = x.abs().amax(dim=dim, keepdim=True).clamp(min=1e-12) / qmax
    return torch.clamp(torch.round(x / scale), -qmax, qmax) * scale


class _QuantLinear(torch.autograd.Function):
    """y = q(x) q(W)ᵀ; the backward's products take q(dy) with q(W) and q(x)."""

    @staticmethod
    def forward(ctx, x, w, bits):
        ctx.save_for_backward(x, w)
        ctx.bits = bits
        return fake_quant(x, bits) @ fake_quant(w, bits).t()

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        bits = ctx.bits
        dy2, x2 = dy.reshape(-1, dy.shape[-1]), x.reshape(-1, x.shape[-1])
        # each product's codes scaled along the dimension it keeps
        dx = fake_quant(dy2, bits) @ fake_quant(w, bits, dim=0)
        dw = fake_quant(dy2.t(), bits) @ fake_quant(x2, bits, dim=0)
        return dx.reshape(x.shape), dw, None


class Precision:
    def __init__(self, bits: int | None = None, kinds: tuple[str, ...] = ()):
        self.bits, self.kinds = bits, tuple(kinds)

    def linear(self, x, w, b=None, kind: str = "other"):
        """x (..., in) · w (out, in)ᵀ + b."""
        x, w = x.float(), w.float()
        if self.bits is not None and kind in self.kinds:
            y = _QuantLinear.apply(x, w, self.bits)
        else:
            y = x @ w.t()
        return y if b is None else y + b.float()

    def matmul(self, a, b, kind: str = "attn"):
        """a @ b for the attention's own products (scores, context)."""
        a, b = a.float(), b.float()
        if self.bits is not None and kind in self.kinds:
            return fake_quant(a, self.bits) @ fake_quant(b, self.bits, dim=-2)
        return a @ b


FP32 = Precision()


def layer_norm(x, w, b, eps: float):
    return F.layer_norm(x.float(), (x.shape[-1],), w.float(), b.float(), eps)


def gelu(x):
    """The published models' exact (erf) GELU."""
    return 0.5 * x * (1.0 + torch.erf(x / math.sqrt(2.0)))


def init_rule(name: str, shape) -> tuple[float, float]:
    """(mean, std) of a seeded leaf: embedding and position tables N(0, 1)
    (``nn.Embedding``'s own), matrices N(0, 1/fan_in), a 1-D ``weight`` (a
    LayerNorm scale) 1 + N(0, 0.1²), any other vector (a bias) N(0, 0.02²)."""
    leaf = name.rsplit(".", 1)[-1]
    if len(shape) >= 2:
        return 0.0, 1.0 if "emb" in name else shape[-1] ** -0.5
    if leaf == "weight":
        return 1.0, 0.1
    return 0.0, 0.02

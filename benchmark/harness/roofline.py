"""The yardstick's arithmetic: the card's peaks, a roofline bound, and the
matrix work of the benchmark's models counted from the shapes the inputs need.

Peaks of one NVIDIA H100 SXM (data sheet, dense, at the 700 W limit): 989
TFLOP/s bf16, 1979 TOP/s int8, 3.35 TB/s HBM.  A bound is Σ max(ops / peak,
bytes / bandwidth) over the products of a call; a roofline share is the bound
over the device time of the kernels that did that work.  Each input byte is
counted read once and each output byte written once.

``Work`` collects (ops, bytes, peak) terms.  The counting functions below take
the real lengths of the inputs: a padded position that changes no result is
not work the inputs need.
"""

from __future__ import annotations

import dataclasses

PEAK_BF16 = 989e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12


@dataclasses.dataclass
class Work:
    ops: float = 0.0          # all operations (for MFU: matrix FLOPs)
    bound_s: float = 0.0      # Σ max(ops/peak, bytes/bandwidth)

    def add(self, ops: float, nbytes: float, peak: float, times: float = 1.0) -> "Work":
        self.ops += ops * times
        self.bound_s += max(ops / peak, nbytes / PEAK_BYTES) * times
        return self

    def __iadd__(self, other: "Work") -> "Work":
        self.ops += other.ops
        self.bound_s += other.bound_s
        return self


def share(work: Work, seconds: float) -> float | None:
    """The roofline share in %, or None where no kernel of the family ran."""
    if seconds <= 0.0 or work.bound_s <= 0.0:
        return None
    return 100.0 * work.bound_s / seconds


def mfu(flops: float, seconds: float) -> float | None:
    """Matrix FLOPs over the bf16 peak for ``seconds``, in %."""
    if seconds <= 0.0 or flops <= 0.0:
        return None
    return 100.0 * flops / (seconds * PEAK_BF16)


def gemm(m: float, k: float, n: float, *, int8: bool, out_bytes: int = 2) -> Work:
    """One product (m, k) · (k, n): int8 codes in, or bf16 in; ``out_bytes``
    a written element."""
    ops = 2.0 * m * k * n
    in_bytes = 1 if int8 else 2
    nbytes = (m * k + k * n) * in_bytes + m * n * out_bytes
    return Work().add(ops, nbytes, PEAK_INT8 if int8 else PEAK_BF16)


# --- ProteoScribe (Stage 3) ------------------------------------------------

def stage3_layer_gemms(rows: float, d: int, ff: int, *, int8: bool, backward: bool) -> Work:
    """A layer's four products on ``rows`` rows (q/k/v fused, out, w1, w2);
    with ``backward`` also their dX and dW products (bf16)."""
    w = Work()
    for k, n in ((d, 3 * d), (d, d), (d, ff), (ff, d)):
        w += gemm(rows, k, n, int8=int8)
        if backward:
            w += gemm(rows, n, k, int8=False)      # dX = dY · Wᵀ
            w += gemm(k, rows, n, int8=False, out_bytes=4)   # dW = Xᵀ · dY, f32
    return w


def stage3_attention(batch: int, L: int, d: int, heads: int, local: int, W: int, *,
                     backward: bool) -> Work:
    """The attention of one layer over ``batch`` rows of length L: the band
    heads count 3W keys a query (QKᵀ and PV), the linear heads 4·L·dh² a row
    (k'ᵀv and q'·context); q, k, v read once and the output written once
    (bf16).  The backward adds twice the products (dQ, dK, dV and dP), reads
    q, k, v and the output's gradient and writes dq, dk, dv."""
    dh = d // heads
    ops = batch * (local * L * 4.0 * dh * 3 * W + (heads - local) * 4.0 * L * dh * dh)
    w = Work().add(ops, batch * L * 4 * d * 2, PEAK_BF16)
    if backward:
        w.add(2 * ops, batch * L * 7 * d * 2, PEAK_BF16)
    return w


def stage3_cond_flops(batch: int, d: int, depth: int, cond: int) -> float:
    """The condition MLP's two products for ``batch`` rows (the time MLP
    is a table)."""
    return 2.0 * batch * (cond * 4 * d + 4 * d * d * depth)


# --- PenCL (Stage 1) -------------------------------------------------------

def encoder_gemms(n: int, E: int, ff: int, layers: int, *, int8: bool) -> Work:
    """A pre- or post-LN encoder's products on one sequence of ``n`` real
    tokens whose output is its first row: every layer on all n rows, but the
    last computes k and v on all rows and q, out and the FF on the first."""
    w = Work()
    for _ in range(layers - 1):
        for k, m_n in ((E, 3 * E), (E, E), (E, ff), (ff, E)):
            w += gemm(n, k, m_n, int8=int8)
    w += gemm(n, E, 2 * E, int8=int8)
    for k, m_n in ((E, E), (E, E), (E, ff), (ff, E)):
        w += gemm(1, k, m_n, int8=int8)
    return w


def encoder_attention(n: int, E: int, layers: int) -> Work:
    """Full attention of ``n`` real tokens over ``n`` keys (QKᵀ, PV) in every
    layer but the last, whose one needed query reads all keys; q, k, v read
    and the output written once (bf16)."""
    w = Work()
    for _ in range(layers - 1):
        w.add(4.0 * n * n * E, n * 4 * E * 2, PEAK_BF16)
    w.add(4.0 * n * E, (2 * n + 2) * E * 2, PEAK_BF16)
    return w

"""Wrappers of the port's CUDA kernels, each beside its plain PyTorch version.

Every wrapper checks device, dtype, shape and contiguity, then:

* on a CUDA tensor it launches its kernel (``csrc/``, built on first use by
  ``ops/_build.py``) on the current stream and adds one to its
  ``launches`` count — no fallback: a refused launch raises;
* on a CPU tensor it runs the plain version, which keeps the kernel's
  rounding points (values that the kernel stores as bf16 are cast to the
  input dtype), so on the card the two compare like with like.

Layouts follow the JAX package: activations (rows, features), weights
(d_in, d_out).  On the card activations and weights are bf16 and biases and
LayerNorm parameters f32; on the CPU everything is f32.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from biom3_tpu_torch.ops import _build
from biom3_tpu_torch.ops import local_attention as _local
from biom3_tpu_torch.ops.linear_attention import linear_attention
from biom3_tpu_torch.ops.local_attention import _band_mask, _look_around
from biom3_tpu_torch.ops.quant import _div as _quant_div
from biom3_tpu_torch.ops.quant import quant_rows as _quant_rows_f32
from biom3_tpu_torch.ops.rotary import apply_rotary

_ACT = {"none": 0, "erf": 1, "tanh": 2}
NEG_INF = -1e9  # score of a PAD key (biom3_tpu/ops/attention.py:13)


def _check(name: str, t, *, dtypes, ndim: int | None = None, shape=None,
           device=None, vectors: bool = False) -> None:
    """``vectors``: the kernel reads this tensor in 16-byte vectors."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a tensor, got {type(t).__name__}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if ndim is not None and t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
    if device is not None and t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if vectors and t.is_cuda and t.data_ptr() % 16:
        raise ValueError(f"{name}: read in 16-byte vectors, so it must be 16-byte aligned")


def _compute_dtypes(x: torch.Tensor):
    """Activations and weights: bf16 on the card, f32 on the CPU."""
    return (torch.bfloat16,) if x.is_cuda else (torch.float32,)


def _stream(x: torch.Tensor) -> int:
    if x.device.index != torch.cuda.current_device():
        raise ValueError(f"tensor on {x.device}, current device is "
                         f"cuda:{torch.cuda.current_device()}")
    return torch.cuda.current_stream(x.device).cuda_stream


def _ptr(t: torch.Tensor | None):
    return None if t is None else t.data_ptr()


def gelu(x: torch.Tensor, impl: str) -> torch.Tensor:
    """``erf`` (exact) or ``tanh`` GELU (fused_layer_tpu.py:61-79)."""
    if impl not in ("erf", "tanh"):
        raise ValueError(f"gelu impl must be 'erf' or 'tanh', got {impl!r}")
    return F.gelu(x, approximate="none" if impl == "erf" else "tanh")


def _layernorm_f32(x: torch.Tensor, scale, shift, eps: float) -> torch.Tensor:
    """Two-pass LayerNorm in f32 (fused_layer_tpu.py:82-97)."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    return (xf - mean) * torch.rsqrt(var + eps) * scale.float() + shift.float()


# --------------------------------------------------------------------------
# gemm_bias_act  (csrc/gemm_bf16.cu)
# --------------------------------------------------------------------------

def gemm_bias_act(a: torch.Tensor, w: torch.Tensor, bias: torch.Tensor | None = None, *,
                  act: str = "none", residual: torch.Tensor | None = None,
                  out_dtype: torch.dtype | None = None, want_pre: bool = False):
    """``act(a @ w + bias) + residual`` → (M, N) in ``out_dtype`` (default
    a's dtype).  a (M, K), w (K, N); bias (N,) f32; residual (M, N) f32 or
    a's dtype.  With ``want_pre`` also returns ``a @ w + bias`` in f32 (the
    pre-activation the GELU backward needs)."""
    cd = _compute_dtypes(a)
    _check("a", a, dtypes=cd, ndim=2, vectors=True)
    M, K = a.shape
    _check("w", w, dtypes=(a.dtype,), ndim=2, device=a.device, vectors=True)
    if w.shape[0] != K:
        raise ValueError(f"w: shape {tuple(w.shape)} does not contract with a {tuple(a.shape)}")
    N = w.shape[1]
    if bias is not None:
        _check("bias", bias, dtypes=(torch.float32,), shape=(N,), device=a.device)
    if residual is not None:
        _check("residual", residual, dtypes=(torch.float32, a.dtype), shape=(M, N),
               device=a.device, vectors=True)
    if act not in _ACT:
        raise ValueError(f"act must be one of {sorted(_ACT)}, got {act!r}")
    out_dtype = out_dtype or a.dtype
    if out_dtype not in (torch.float32, a.dtype):
        raise TypeError(f"out_dtype {out_dtype} must be f32 or {a.dtype}")
    if not a.is_cuda:
        return gemm_bias_act_plain(a, w, bias, act=act, residual=residual, out_dtype=out_dtype,
                                   want_pre=want_pre)
    if K % 8 or N % 8:
        raise ValueError(f"gemm_bias_act needs K % 8 == 0 and N % 8 == 0, got K={K} N={N}")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    pre = torch.empty((M, N), dtype=torch.float32, device=a.device) if want_pre else None
    _build.launch("b3_gemm_bias_act", _ptr(a), _ptr(w), _ptr(bias), _ptr(residual), _ptr(pre),
                  _ptr(out), M, N, K, _ACT[act],
                  int(residual is not None and residual.dtype == torch.bfloat16),
                  int(out_dtype == torch.float32), _stream(a))
    gemm_bias_act.launches += 1
    return (out, pre) if want_pre else out


def gemm_bias_act_plain(a, w, bias=None, *, act="none", residual=None, out_dtype=None,
                        want_pre=False):
    pre = a.float() @ w.float()
    if bias is not None:
        pre = pre + bias.float()
    y = gelu(pre, act) if act != "none" else pre
    if residual is not None:
        y = y + residual.float()
    y = y.to(out_dtype or a.dtype)
    return (y, pre) if want_pre else y


def gelu_grad(x: torch.Tensor, impl: str) -> torch.Tensor:
    """d gelu / dx for ``erf`` or ``tanh`` GELU (layer_block_tpu.py:71-81)."""
    if impl == "erf":
        return 0.5 * (1.0 + torch.erf(x * 0.7071067811865476)) + \
            x * torch.exp(-0.5 * x * x) * 0.3989422804014327
    if impl == "tanh":
        c = 0.7978845608028654
        t = torch.tanh(c * (x + 0.044715 * x * x * x))
        return 0.5 * (1.0 + t) + 0.5 * x * (1.0 - t * t) * c * (1.0 + 3 * 0.044715 * x * x)
    raise ValueError(f"gelu impl must be 'erf' or 'tanh', got {impl!r}")


_DGELU = {"erf": 3, "tanh": 4}


def gemm_dx(dy: torch.Tensor, w: torch.Tensor, *, gelu_of: torch.Tensor | None = None,
            gelu: str = "erf", out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """Input gradient ``dy @ wᵀ`` → (M, N): dy (M, K), w (N, K) (the
    forward's (d_in, d_out) weight).  With ``gelu_of`` (M, N) f32 — the
    forward's pre-activation h — the product is multiplied by gelu'(h)."""
    cd = _compute_dtypes(dy)
    _check("dy", dy, dtypes=cd, ndim=2, vectors=True)
    M, K = dy.shape
    _check("w", w, dtypes=(dy.dtype,), ndim=2, device=dy.device, vectors=True)
    if w.shape[1] != K:
        raise ValueError(f"w: shape {tuple(w.shape)} does not contract with dy {tuple(dy.shape)}")
    N = w.shape[0]
    if gelu_of is not None:
        _check("gelu_of", gelu_of, dtypes=(torch.float32,), shape=(M, N), device=dy.device,
               vectors=True)
        if gelu not in _DGELU:
            raise ValueError(f"gelu must be one of {sorted(_DGELU)}, got {gelu!r}")
    out_dtype = out_dtype or dy.dtype
    if out_dtype not in (torch.float32, dy.dtype):
        raise TypeError(f"out_dtype {out_dtype} must be f32 or {dy.dtype}")
    if not dy.is_cuda:
        return gemm_dx_plain(dy, w, gelu_of=gelu_of, gelu=gelu, out_dtype=out_dtype)
    if K % 8 or N % 8:
        raise ValueError(f"gemm_dx needs K % 8 == 0 and N % 8 == 0, got K={K} N={N}")
    out = torch.empty((M, N), dtype=out_dtype, device=dy.device)
    _build.launch("b3_gemm_dx", _ptr(dy), _ptr(w), _ptr(gelu_of), _ptr(out), M, N, K,
                  _DGELU[gelu] if gelu_of is not None else 0, int(out_dtype == torch.float32),
                  int(gemm_dx_plan(M, N, _sm_count(dy.device.index)) == 128), _stream(dy))
    gemm_dx.launches += 1
    return out


def gemm_dx_plain(dy, w, *, gelu_of=None, gelu="erf", out_dtype=None):
    y = dy.float() @ w.float().t()
    if gelu_of is not None:
        y = y * gelu_grad(gelu_of.float(), gelu)
    return y.to(out_dtype or dy.dtype)


def gemm_dx_plan(rows: int, n: int, sms: int = 132) -> int:
    """gemm_dx's tile rows: 128 (128x128, two consumer warpgroups) where
    those tiles cover every SM, else 64 (64x128).  Both run two persistent
    blocks an SM; the reduced dim is never split.  (A sweep of both tiles
    at the Stage-3 products over 4096 and 32768 rows and the ESM2 ones
    over 2048 and 4096 rows on an H100, PERF.md: the 128x128 tile won
    every product whose tiles cover the SMs, the N = 512 ones included;
    short of them, at N = 512 over 4096 rows, 64x128 won the K = 512
    product by a third and the two stayed close at longer K.)"""
    return 128 if -(-rows // 128) * -(-n // 128) >= sms else 64


DW_MIN_KTILES = 64   # gemm_dw: least 64-row k-tiles a split sums (4096 rows)


def gemm_dw_plan(rows: int, k: int, n: int, sms: int = 132) -> tuple[int, int, int]:
    """gemm_dw's tile and split rule → (tile rows, splits, rows a split).
    Persistent blocks run two an SM on either tile.  A split costs an f32
    (k, n) slab to write and sum and pays off only over long reductions, so
    a split sums at least ``DW_MIN_KTILES`` k-tiles; the 128x128 tile is
    taken where its tiles times those splits still fill one wave of 2·sms
    blocks, else 64x128; then as many splits as keep tiles times splits
    within that wave.  Every row lies in exactly one split, and none is
    empty.  (A sweep of both tiles and 1-16 splits on an H100 at the
    Stage-3 and ESM2 products over 4096 and 32768 rows, PERF.md.)"""
    ktiles = max(1, -(-rows // 64))
    most = max(1, ktiles // DW_MIN_KTILES)
    bm = 128 if -(-k // 128) * -(-n // 128) * most >= 2 * sms else 64
    tiles = -(-k // bm) * -(-n // 128)
    per = -(-ktiles // max(1, min(2 * sms // tiles, most)))
    return bm, -(-ktiles // per), per * 64


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def gemm_dw(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Weight gradient ``xᵀ @ dy`` → (K, N) f32: x (M, K), dy (M, N), the M
    rows summed in f32 (the whole batch in one call), in a fixed order:
    the same inputs give the same bits."""
    cd = _compute_dtypes(x)
    _check("x", x, dtypes=cd, ndim=2, vectors=True)
    M, K = x.shape
    _check("dy", dy, dtypes=(x.dtype,), ndim=2, device=x.device, vectors=True)
    if dy.shape[0] != M:
        raise ValueError(f"dy: shape {tuple(dy.shape)} has not the {M} rows of x")
    N = dy.shape[1]
    if not x.is_cuda:
        return gemm_dw_plain(x, dy)
    if K % 8 or N % 8 or M == 0:
        raise ValueError(f"gemm_dw needs K % 8 == 0, N % 8 == 0 and rows, got M={M} K={K} N={N}")
    out = torch.empty((K, N), dtype=torch.float32, device=x.device)
    bm, splits, chunk = gemm_dw_plan(M, K, N, _sm_count(x.device.index))
    ws = torch.empty((splits, K, N), dtype=torch.float32, device=x.device) if splits > 1 else None
    _build.launch("b3_gemm_dw", _ptr(x), _ptr(dy), _ptr(out), _ptr(ws), K, N, M, chunk,
                  int(bm == 128), _stream(x))
    gemm_dw.launches += 1
    return out


def gemm_dw_plain(x, dy):
    return x.float().t() @ dy.float()


# --------------------------------------------------------------------------
# stage3_attention_core  (csrc/stage3_attn.cu)
# --------------------------------------------------------------------------

def stage3_attention_core(qkv: torch.Tensor, *, heads: int, local_heads: int,
                          window: int) -> torch.Tensor:
    """(B, L, 3d) fused [q | k | v] → (B, L, d) head outputs, local heads
    first: band-local heads (±1 window, joint softmax) then linear heads."""
    d = _check_stage3_qkv(qkv, heads, local_heads, window)
    B, L, _ = qkv.shape
    if not qkv.is_cuda:
        return stage3_attention_core_plain(qkv, heads=heads, local_heads=local_heads,
                                           window=window)
    dh = d // heads
    tile = min(window, 128 if dh == 32 else 64)
    if dh not in (32, 64) or (local_heads and (window % tile or tile % 8)):
        raise ValueError(f"stage3_attention_core kernel needs head dim 32 or 64 and a "
                         f"window that tiles by {tile}; got Dh={dh} window={window}")
    out = torch.empty((B, L, d), dtype=qkv.dtype, device=qkv.device)
    floats, plan = _stage3_linear_scratch(qkv, heads, local_heads)
    ws = torch.empty(floats, dtype=torch.float32, device=qkv.device) if floats else None
    _build.launch("b3_stage3_attention_core", _ptr(qkv), _ptr(out), _ptr(ws), B, L, d, heads,
                  local_heads, window, *plan, _stream(qkv))
    stage3_attention_core.launches += 1
    return out


def _check_stage3_qkv(qkv: torch.Tensor, heads: int, local_heads: int, window: int) -> int:
    """The checks of the Stage-3 attention cores → d."""
    _check("qkv", qkv, dtypes=_compute_dtypes(qkv), ndim=3, vectors=True)
    B, L, d3 = qkv.shape
    if d3 % 3 or (d3 // 3) % heads:
        raise ValueError(f"qkv last dim {d3} is not 3·d with d divisible by heads={heads}")
    if not 0 <= local_heads <= heads:
        raise ValueError(f"local_heads {local_heads} outside [0, {heads}]")
    if local_heads and L % window:
        raise ValueError(f"L={L} not divisible by window={window}")
    return d3 // 3


def _stage3_linear_scratch(qkv, heads: int, local_heads: int):
    """The linear heads' split (``stage3_linear_plan``) and the f32 scratch
    it takes, as ``csrc/stage3_linear.cuh``'s LinWs reads it: per pair the
    statistics of each 64 rows (max and Σexp a channel), ctx, and with more
    than one chunk the chunks' parts of ctx → (floats, (chunks, per, srows,
    lrows))."""
    B, L, d3 = qkv.shape
    dh = d3 // 3 // heads
    pairs = B * (heads - local_heads)
    chunks, per, srows, lrows = stage3_linear_plan(L, pairs, _sm_count(qkv.device.index))
    floats = pairs * (-(-L // LIN_MIN_ROWS) * 2 * dh + dh * dh + (chunks > 1) * chunks * dh * dh)
    return floats, (chunks, per, srows, lrows)


LIN_MIN_ROWS = 64    # stage3_attention_core: least sequence rows a linear-heads chunk
LIN_OUT_ROWS = 128   # ... and the rows of one band block, the least of a linear output block


def stage3_linear_plan(L: int, pairs: int, sms: int = 132) -> tuple[int, int, int, int]:
    """The linear heads' sequence splits → (ctx chunks, rows a ctx chunk,
    rows a statistics block, output rows a block).  ctx: about two (chunk,
    pair) blocks an SM, each chunk of at least ``LIN_MIN_ROWS`` rows; the
    softmax statistics: the fewest rows (64 · 2^k, up to 256) that keep
    the blocks within about eight an SM; the output rows: the most (128 ·
    2^k, up to 512) that still give two blocks an SM.  At L=1024 and 8
    linear heads: B=2's 16 pairs and B=4's 32 in 16 and 8 ctx chunks,
    statistics of 64 rows, output blocks of 128; B=32's 256 in one chunk,
    statistics of 256, output blocks of 512 (the fastest of those tried on
    an H100).  Every row lies in exactly one chunk of each split, and none
    is empty."""
    pairs = max(pairs, 1)
    chunks = max(1, min(2 * sms // pairs, L // LIN_MIN_ROWS))
    per = -(-L // chunks)
    srows = LIN_MIN_ROWS
    while srows < 4 * LIN_MIN_ROWS and srows < L and pairs * -(-L // srows) > 8 * sms:
        srows *= 2
    lrows = LIN_OUT_ROWS
    while lrows < 4 * LIN_OUT_ROWS and lrows < L and pairs * -(-L // (2 * lrows)) >= 2 * sms:
        lrows *= 2
    return -(-L // per), per, srows, lrows


def stage3_attention_core_plain(qkv, *, heads, local_heads, window):
    B, L, d3 = qkv.shape
    d = d3 // 3
    q, k, v = (t.reshape(B, L, heads, d // heads).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    outs = []
    if local_heads:
        outs.append(_local.local_window_attention(q[:, :local_heads], k[:, :local_heads],
                                                  v[:, :local_heads], window=window))
    if heads > local_heads:
        outs.append(linear_attention(q[:, local_heads:], k[:, local_heads:],
                                     v[:, local_heads:]))
    return torch.cat(outs, dim=1).transpose(1, 2).reshape(B, L, d)


# --------------------------------------------------------------------------
# stage3_attention_core_i8  (csrc/stage3_attn_i8.cu + stage3_attn.cu's linear heads)
# --------------------------------------------------------------------------

def stage3_attention_core_i8(qkv: torch.Tensor, *, heads: int, local_heads: int, window: int,
                             codes: bool = False, pq: bool = False):
    """``stage3_attention_core`` with the band-local heads' QKᵀ and PV in
    int8 (``fused_stack_logits(attn_quant="int8")``, stack_kernel_tpu.py:
    112-180); the linear heads as there, in the compute dtype.  q and k are
    quantized per (head, token) over Dh, v per (head, channel) over L, p
    per (head, query) after the f32 softmax.  ``codes=True`` also returns
    ``(q8, sq, k8, sk, v8, sv)``: q8, k8 (B, local, L, Dh) int8, sq, sk (B,
    local, L) f32, v8 (B, local, Dh, L) int8 and sv (B, local, Dh) f32.
    ``pq=True`` (a check of the kernel's p codes; on the card only) also
    returns them as uint8 (B, local, L, 3·window) at
    ``stage3_i8_band_plain``'s band positions, 0 outside a row's band."""
    d = _check_stage3_qkv(qkv, heads, local_heads, window)
    B, L, _ = qkv.shape
    if not qkv.is_cuda:
        if pq:
            raise ValueError("pq=True reads the kernel's p codes: a CUDA tensor only")
        return stage3_attention_core_i8_plain(qkv, heads=heads, local_heads=local_heads,
                                              window=window, codes=codes)
    dh = d // heads
    if dh not in (32, 64) or (local_heads and window % 4):
        raise ValueError(f"stage3_attention_core_i8 kernel needs head dim 32 or 64 and a window "
                         f"that is a multiple of 4; got Dh={dh} window={window}")
    if local_heads and stage3_i8_band_smem(L, window, dh) > I8_MAX_SMEM:
        raise ValueError(f"stage3_attention_core_i8 kernel: the band of window {window} at "
                         f"L={L}, Dh={dh} does not fit one block's shared memory")
    dev, nl = qkv.device, local_heads
    Lp = -(-L // 32) * 32
    # two buffers, carved at 16-byte offsets (L % 4 == 0): int8 q8, k8 (B,
    # local, L, Dh) and v8 (B, local, Dh, Lp), keys in PV order; f32 sq, sk
    # (B, local, L), sv (B, local, Dh) and the linear heads' scratch
    n_qk, n_s = B * nl * L * dh, B * nl * L
    floats, plan = _stage3_linear_scratch(qkv, heads, nl)
    out = torch.empty((B, L, d), dtype=qkv.dtype, device=dev)
    i8 = torch.empty(2 * n_qk + B * nl * dh * Lp, dtype=torch.int8, device=dev)
    f32 = torch.empty(2 * n_s + B * nl * dh + floats, dtype=torch.float32, device=dev)
    pq_out = (torch.zeros((B, nl, L, 3 * window), dtype=torch.uint8, device=dev)
              if pq and nl else None)
    a, f = i8.data_ptr(), f32.data_ptr()
    _build.launch("b3_stage3_attention_i8", _ptr(qkv), _ptr(out), a, f, a + n_qk, f + 4 * n_s,
                  a + 2 * n_qk, f + 8 * n_s, f + 4 * (2 * n_s + B * nl * dh) if floats else None,
                  _ptr(pq_out), B, L, d, heads, nl, window,
                  stage3_i8_quant_plan(L, B * nl, _sm_count(dev.index)), *plan, _stream(qkv))
    stage3_attention_core_i8.launches += 1
    result = [out]
    if codes:
        q8, k8 = i8[:n_qk].view(B, nl, L, dh), i8[n_qk:2 * n_qk].view(B, nl, L, dh)
        order = torch.tensor(stage3_i8_pv_order(), device=dev)
        keys = torch.empty_like(order).scatter_(0, order, torch.arange(32, device=dev))
        v8 = i8[2 * n_qk:].view(B, nl, dh, Lp // 32, 32)[..., keys].view(B, nl, dh, Lp)
        sq, sk = f32[:n_s].view(B, nl, L), f32[n_s:2 * n_s].view(B, nl, L)
        sv = f32[2 * n_s:2 * n_s + B * nl * dh].view(B, nl, dh)
        result.append((q8, sq, k8, sk, v8[..., :L].contiguous(), sv))
    if pq:
        result.append(pq_out if nl else torch.zeros((B, 0, L, 3 * window), dtype=torch.uint8,
                                                    device=dev))
    return result[0] if len(result) == 1 else tuple(result)


I8_BQ, I8_KT = 128, 128       # stage3_attention_core_i8: queries a band block, keys a tile
I8_MAX_SMEM = 232448          # dynamic shared memory one block may have on an H100


def stage3_i8_pv_order() -> list[int]:
    """The key (0..31) at each position of a 32-key group of the kernel's
    v codes.  A thread's S accumulator (wgmma m64nN s32) holds the columns
    8q + 2·(lane % 4) + e of its rows r and r + 8; the s8 register A
    fragment of a k32 step holds, in registers 0 (row r) and 1 (row r + 8),
    the keys 4·(lane % 4) + i, and in registers 2 and 3 those + 16.  The
    kernel packs a row's q = 0, 1 into the first register of the pair and
    q = 2, 3 into the second, so column c = 8q + 2t + e lands at position
    16·(q // 2) + 4t + 2·(q % 2) + e; v8 keeps each key at its column's
    position (``csrc/stage3_attn_i8.cu``'s ``pv_pos``)."""
    order = [0] * 32
    for c in range(32):
        q, t, e = c // 8, (c % 8) // 2, c % 2
        order[16 * (q // 2) + 4 * t + 2 * (q % 2) + e] = c
    return order


@functools.cache
def stage3_i8_quant_plan(L: int, pairs: int, sms: int = 132) -> int:
    """Rows a block of ``stage3_attention_core_i8``'s quantize pre-pass
    takes (a multiple of 128): the sequence in the fewest chunks that give
    about two blocks an SM over ``pairs`` (batch row, band head) pairs, at
    most one a 128 rows.  Every block reads its head's whole v for the
    column amax, so fewer chunks read less; at L=1024 and 8 band heads B=4
    (32 pairs) gets 8 chunks of 128 rows (256 blocks), B=32 (256) 2 of
    512."""
    tiles = -(-L // 128)
    chunks = max(1, min(tiles, -(-2 * sms // max(pairs, 1))))
    return -(-tiles // chunks) * 128


def stage3_i8_band_tiles(L: int, window: int) -> list[tuple[int, int]]:
    """(first key, 128-key tiles) of each 128-query band block of
    ``stage3_attention_core_i8``: the union of its rows' bands, its first
    key rounded down to a multiple of 32 (a PV key group starts there)."""
    plan = []
    for q0 in range(0, L, I8_BQ):
        last = min(q0 + I8_BQ, L) - 1
        lo = max(0, (q0 // window - 1) * window)
        hi = min(L, (last // window + 2) * window)
        kt0 = lo // 32 * 32
        plan.append((kt0, -(-(hi - kt0) // I8_KT)))
    return plan


def stage3_i8_half_tiles(L: int, window: int) -> list[list[tuple[int, bool]]]:
    """The 64-key half tiles each 64-row warpgroup of
    ``stage3_attention_core_i8``'s band kernel computes, in its block's
    tiles: (first key, whether every valid row of the warpgroup sees all
    its keys, so that it skips the masks); one list a warpgroup with a row
    below L.  A half tile outside every row's band is not computed."""
    out = []
    for blk, (kt0, tiles) in enumerate(stage3_i8_band_tiles(L, window)):
        for row0 in range(blk * I8_BQ, min(L, blk * I8_BQ + I8_BQ), 64):
            last = min(row0 + 63, L - 1)
            u_lo = max(0, (row0 // window - 1) * window)     # the union of the rows' bands
            u_hi = min(L, (last // window + 2) * window)
            f_lo = max(0, (last // window - 1) * window)     # the keys every row sees
            f_hi = min(L, (row0 // window + 2) * window)
            out.append([(k0, f_lo <= k0 and k0 + 64 <= f_hi)
                        for k0 in range(kt0, kt0 + I8_KT * tiles, 64)
                        if k0 < u_hi and k0 + 64 > u_lo])
    return out


@functools.cache
def stage3_i8_band_smem(L: int, window: int, dh: int) -> int:
    """Shared memory of ``stage3_attention_core_i8``'s band kernel: the q
    tile and every staged tile (k codes, v codes, k scales padded to 1 KB)
    of the widest band, its barriers, 1 KB of alignment; at least the
    linear heads' output rows' (ctx and a q' tile in f32)."""
    tiles = max(n for _, n in stage3_i8_band_tiles(L, window))
    band = 1024 + I8_BQ * dh + tiles * (2 * I8_KT * dh + 1024) + (tiles + 1) * 8
    return max(band, (dh * dh + dh * I8_BQ) * 4 + 1024)


def _i8_codes(x: torch.Tensor, dim: int):
    """Symmetric int8 over ``dim`` (stack_kernel_tpu.py:129-134): amax =
    max(max|x|, 1e-6), codes rint(x · (127 / amax)) clipped to ±127, scale
    amax · (1/127) → (codes, scale without ``dim``)."""
    xf = x.float()
    amax = xf.abs().amax(dim, keepdim=True).clamp(min=1e-6)
    q = torch.round(xf * _quant_div(127.0, amax)).clamp(-127.0, 127.0).to(torch.int8)
    return q, (amax * (1.0 / 127.0)).squeeze(dim)


def stage3_attention_core_i8_plain(qkv, *, heads, local_heads, window, codes=False):
    """The TPU kernel's int8 band product on (B, L, 3d) rows: each window's
    queries against the keys of windows w-1..w+1 that exist (the edge
    windows' 2W), here as a masked 3W band (``stage3_i8_band_plain``)."""
    B, L, d3 = qkv.shape
    d = d3 // 3
    dh, nl = d // heads, local_heads
    q, k, v = (t.reshape(B, L, heads, dh).transpose(1, 2) for t in qkv.split(d, dim=-1))
    outs = []
    q8, sq = _i8_codes(q[:, :nl], -1)
    k8, sk = _i8_codes(k[:, :nl], -1)
    v8, sv = _i8_codes(v[:, :nl].transpose(-1, -2), -1)          # (B, nl, Dh, L) over L
    if nl:
        o, _ = stage3_i8_band_plain(q8, sq, k8, sk, v8, sv, window=window)
        outs.append(o.to(qkv.dtype))
    if heads > nl:
        outs.append(linear_attention(q[:, nl:], k[:, nl:], v[:, nl:]))
    out = torch.cat(outs, dim=1).transpose(1, 2).reshape(B, L, d)
    return (out, (q8.contiguous(), sq.contiguous(), k8.contiguous(), sk.contiguous(),
                  v8.contiguous(), sv.contiguous())) if codes else out


def stage3_i8_band_plain(q8, sq, k8, sk, v8, sv, *, window, rounding="plain"):
    """The band heads' int8 attention from their codes (q8, k8 (B, nl, L,
    Dh), v8 (B, nl, Dh, L)) → (f32 output (B, nl, L, Dh), p codes (B, nl,
    L, 3W) at band position j = key − (w−1)·W, 0 outside the band).  The
    sums of code products are exact, as the kernel's int32 ones: QKᵀ as f32
    matrix products (Dh·127² < 2^24), PV, up to 3W·127², as f64 ones,
    rounded to f32 as the kernel converts its int32 sums.

    ``rounding="plain"``: the TPU kernel's, s = int32 · s_q · s_k ·
    Dh^-0.5, p = softmax(s), pq = rint(p · (127 / max p)).
    ``rounding="kernel"``: the band kernel's, x = int32 · s_k, m = max x ·
    c with c = s_q · Dh^-0.5 · log2 e, e = exp2(fma(x, c, −m)), pq =
    rint(127 · e), pamax = 1 / Σe (``csrc/stage3_attn_i8.cu``; exp2 here is
    torch's, the kernel's the hardware's approximation)."""
    if rounding not in ("plain", "kernel"):
        raise ValueError(f"rounding must be 'plain' or 'kernel', got {rounding!r}")
    B, nl, L, dh = q8.shape
    nw, W = L // window, window
    qw = q8.float().reshape(B, nl, nw, W, dh)
    kw = _look_around(k8.float().reshape(B, nl, nw, W, dh))   # (B, nl, nw, 3W, Dh)
    skw = _look_around(sk.reshape(B, nl, nw, W, 1))[..., 0]  # (B, nl, nw, 3W)
    dots = qw @ kw.transpose(-1, -2)                          # int32 sums, exact
    band = _band_mask(nw, W, q8.device)[:, None, :]
    sqw = sq.reshape(B, nl, nw, W, 1)
    if rounding == "plain":
        s = dots * sqw * skw[..., None, :]
        s = (s * dh ** -0.5).masked_fill(band, float("-inf"))
        e = torch.exp(s - s.amax(-1, keepdim=True))
        p = e / e.sum(-1, keepdim=True)
        pamax = p.amax(-1, keepdim=True).clamp(min=1e-6)
        pq = torch.round(p * _quant_div(127.0, pamax))            # 0..127
    else:
        x = (dots * skw[..., None, :]).masked_fill(band, float("-inf"))
        log2e = torch.tensor(1.4426950408889634, dtype=torch.float32)
        c = sqw * (log2e / torch.tensor(float(dh)).sqrt())
        m = x.amax(-1, keepdim=True) * c
        y = (x.double() * c.double() - m.double()).float()      # one rounding, as an FMA
        e = torch.exp2(y).masked_fill(band, 0.0)
        pamax = _quant_div(1.0, e.sum(-1, keepdim=True)).clamp(min=1e-6)
        pq = torch.round(e.double() * 127.0).float()               # one rounding, as an FMA
    vw = _look_around(v8.float().transpose(-1, -2).reshape(B, nl, nw, W, dh))
    acc = (pq.double() @ vw.double()).float()                     # int32 sums, exact
    o = acc * sv[:, :, None, None, :] * (pamax * (1.0 / 127.0))
    return o.reshape(B, nl, L, dh), pq.reshape(B, nl, L, 3 * W).to(torch.uint8)


# --------------------------------------------------------------------------
# dense_attention  (csrc/dense_attn.cu)
# --------------------------------------------------------------------------

def dense_attention(qkv: torch.Tensor, *, heads: int) -> torch.Tensor:
    """(B, L, 3E) fused [q | k | v] → (B, L, E): unmasked softmax attention
    per head (the BERT tower; PAD tokens attend)."""
    _check("qkv", qkv, dtypes=_compute_dtypes(qkv), ndim=3, vectors=True)
    B, L, e3 = qkv.shape
    if e3 % 3 or (e3 // 3) % heads:
        raise ValueError(f"qkv last dim {e3} is not 3·E with E divisible by heads={heads}")
    E = e3 // 3
    if not qkv.is_cuda:
        return dense_attention_plain(qkv, heads=heads)
    if E // heads not in (32, 64):
        raise ValueError(f"dense_attention kernel needs head dim 32 or 64, got {E // heads}")
    out = torch.empty((B, L, E), dtype=qkv.dtype, device=qkv.device)
    _build.launch("b3_dense_attention", _ptr(qkv), _ptr(out), B, L, E, heads, _stream(qkv))
    dense_attention.launches += 1
    return out


def dense_attention_plain(qkv, *, heads):
    B, L, e3 = qkv.shape
    E = e3 // 3
    q, k, v = (t.reshape(B, L, heads, E // heads).transpose(1, 2).float()
               for t in qkv.split(E, dim=-1))
    dots = (q @ k.transpose(-1, -2)) * (E // heads) ** -0.5
    p = torch.softmax(dots, dim=-1).to(qkv.dtype).float()
    return (p @ v).to(qkv.dtype).transpose(1, 2).reshape(B, L, E)


# --------------------------------------------------------------------------
# flash_attention  (csrc/flash_attn.cu)
# --------------------------------------------------------------------------

def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    padding_mask: torch.Tensor | None = None) -> torch.Tensor:
    """q, k, v (B, H, L, D), padding_mask (B, L) int32 (nonzero = PAD key)
    or None → (B, H, L, D): softmax attention, PAD keys at -1e9."""
    _check("q", q, dtypes=_compute_dtypes(q), ndim=4, vectors=True)
    _check("k", k, dtypes=(q.dtype,), shape=q.shape, device=q.device, vectors=True)
    _check("v", v, dtypes=(q.dtype,), shape=q.shape, device=q.device, vectors=True)
    B, H, L, D = q.shape
    if padding_mask is not None:
        _check("padding_mask", padding_mask, dtypes=(torch.int32,), shape=(B, L),
               device=q.device)
    if not q.is_cuda:
        return flash_attention_plain(q, k, v, padding_mask)
    if D not in (32, 64):
        raise ValueError(f"flash_attention kernel needs head dim 32 or 64, got {D}")
    out = torch.empty_like(q)
    _build.launch("b3_flash_attention", _ptr(q), _ptr(k), _ptr(v), _ptr(padding_mask),
                  _ptr(out), B, H, L, D, _stream(q))
    flash_attention.launches += 1
    return out


def flash_attention_plain(q, k, v, padding_mask=None):
    """f32 scores and softmax, probabilities rounded to v's dtype
    (biom3_tpu/ops/attention.py:61-74)."""
    dots = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    if padding_mask is not None:
        dots = dots.masked_fill(padding_mask.bool()[:, None, None, :], NEG_INF)
    p = torch.softmax(dots, dim=-1).to(v.dtype).float()
    return (p @ v.float()).to(v.dtype)


# --------------------------------------------------------------------------
# esm2_attention  (csrc/esm2_attn.cu)
# --------------------------------------------------------------------------

def esm2_attention(qkv: torch.Tensor, padding_mask: torch.Tensor, cos: torch.Tensor,
                   sin: torch.Tensor, *, heads: int) -> torch.Tensor:
    """(B, L, 3E) fused [q | k | v], padding_mask (B, L) int32 (nonzero =
    PAD key), rotary tables cos, sin (L, Dh) in qkv's dtype → (B, L, E):
    GPT-NeoX rotary on q and k, then softmax attention per head with PAD
    keys at -1e9 (the ESM2 tower)."""
    _check("qkv", qkv, dtypes=_compute_dtypes(qkv), ndim=3, vectors=True)
    B, L, e3 = qkv.shape
    if e3 % 3 or (e3 // 3) % heads:
        raise ValueError(f"qkv last dim {e3} is not 3·E with E divisible by heads={heads}")
    E = e3 // 3
    dh = E // heads
    _check("padding_mask", padding_mask, dtypes=(torch.int32,), shape=(B, L),
           device=qkv.device)
    _check("cos", cos, dtypes=(qkv.dtype,), shape=(L, dh), device=qkv.device, vectors=True)
    _check("sin", sin, dtypes=(qkv.dtype,), shape=(L, dh), device=qkv.device, vectors=True)
    if not qkv.is_cuda:
        return esm2_attention_plain(qkv, padding_mask, cos, sin, heads=heads)
    if dh not in (32, 64):
        raise ValueError(f"esm2_attention kernel needs head dim 32 or 64, got {dh}")
    out = torch.empty((B, L, E), dtype=qkv.dtype, device=qkv.device)
    ops = torch.empty((2, B, heads, L, dh), dtype=qkv.dtype, device=qkv.device)  # rotated q, k
    _build.launch("b3_esm2_attention", _ptr(qkv), _ptr(padding_mask), _ptr(cos), _ptr(sin),
                  _ptr(out), _ptr(ops), B, L, E, heads, _stream(qkv))
    esm2_attention.launches += 1
    return out


def _esm2_heads(qkv, cos, sin, heads):
    """(B, L, 3E) → q, k rotated in qkv's dtype and v, each (B, H, L, Dh)."""
    B, L, e3 = qkv.shape
    E = e3 // 3
    q, k, v = (t.reshape(B, L, heads, E // heads).transpose(1, 2)
               for t in qkv.split(E, dim=-1))
    return apply_rotary(q, cos, sin), apply_rotary(k, cos, sin), v


def _esm2_probs(q, k, padding_mask):
    """f32 softmax of the rotated scores with -1e9 added on PAD keys, as
    the TPU kernel adds its ``padneg`` (esm2_block_tpu.py:105, :218): the
    probabilities equal the -1e9 fill's (a PAD key's is 0 when a real key
    exists; an all-PAD row is uniform), and the gradient is the TPU
    kernel's, which reaches the scores of an all-PAD row."""
    dots = (q.float() @ k.float().transpose(-1, -2)) * q.shape[-1] ** -0.5
    return torch.softmax(dots + NEG_INF * padding_mask.float()[:, None, None, :], dim=-1)


def esm2_attention_plain(qkv, padding_mask, cos, sin, *, heads):
    B, L, e3 = qkv.shape
    q, k, v = _esm2_heads(qkv, cos, sin, heads)
    p = _esm2_probs(q, k, padding_mask).to(v.dtype).float()
    return (p @ v.float()).to(v.dtype).transpose(1, 2).reshape(B, L, e3 // 3)


# --------------------------------------------------------------------------
# row-wise kernels  (csrc/rowwise.cu)
# --------------------------------------------------------------------------

def bias_layernorm(h: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor, *, eps: float = 1e-6):
    """h (B, L, d) + bias (B, d) → (xb f32, LayerNorm(xb) in h's dtype), on
    ``layernorm``'s kernels with the bias added as h is read."""
    _check("h", h, dtypes=_compute_dtypes(h), ndim=3, vectors=True)
    B, L, d = h.shape
    _check("bias", bias, dtypes=(h.dtype,), shape=(B, d), device=h.device, vectors=True)
    _check("scale", scale, dtypes=(torch.float32,), shape=(d,), device=h.device)
    _check("shift", shift, dtypes=(torch.float32,), shape=(d,), device=h.device)
    if not h.is_cuda:
        return bias_layernorm_plain(h, bias, scale, shift, eps=eps)
    if d % 8:
        raise ValueError(f"bias_layernorm kernel needs d % 8 == 0, got d={d}")
    xb = torch.empty((B, L, d), dtype=torch.float32, device=h.device)
    xn = torch.empty_like(h)
    _build.launch("b3_bias_layernorm", _ptr(h), _ptr(bias), _ptr(scale), _ptr(shift),
                  _ptr(xb), _ptr(xn), B * L, L, d, eps, _stream(h))
    bias_layernorm.launches += 1
    return xb, xn


def bias_layernorm_plain(h, bias, scale, shift, *, eps=1e-6):
    xb = h.float() + bias.float()[:, None, :]
    return xb, _layernorm_f32(xb, scale, shift, eps).to(h.dtype)


def layernorm(x: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor, *, eps: float,
              out_dtype: torch.dtype, want_f32: bool = False):
    """LayerNorm over the last dim of x (rows, d), f32 or ``out_dtype`` in.
    Returns y in ``out_dtype``, or (y, y in f32) with ``want_f32``.
    ``out_dtype`` f32 writes the f32 output alone (the int8 FF's input)."""
    cd = _compute_dtypes(x)
    _check("x", x, dtypes=(torch.float32,) + cd, vectors=True)
    d = x.shape[-1]
    _check("scale", scale, dtypes=(torch.float32,), shape=(d,), device=x.device, vectors=True)
    _check("shift", shift, dtypes=(torch.float32,), shape=(d,), device=x.device, vectors=True)
    if out_dtype not in (torch.float32,) + cd:
        raise TypeError(f"out_dtype {out_dtype} not in {(torch.float32,) + cd}")
    if not x.is_cuda:
        return layernorm_plain(x, scale, shift, eps=eps, out_dtype=out_dtype,
                               want_f32=want_f32)
    if d % 8:
        raise ValueError(f"layernorm kernel needs d % 8 == 0, got d={d}")
    f32_only = out_dtype == torch.float32
    y = None if f32_only else torch.empty(x.shape, dtype=out_dtype, device=x.device)
    y32 = torch.empty(x.shape, dtype=torch.float32, device=x.device) \
        if want_f32 or f32_only else None
    _build.launch("b3_layernorm", _ptr(x), int(x.dtype == torch.float32), _ptr(scale),
                  _ptr(shift), _ptr(y), _ptr(y32), x.numel() // d, d, eps, _stream(x))
    layernorm.launches += 1
    if f32_only:
        y = y32
    return (y, y32) if want_f32 else y


def layernorm_plain(x, scale, shift, *, eps, out_dtype, want_f32=False):
    y32 = _layernorm_f32(x, scale, shift, eps)
    return (y32.to(out_dtype), y32) if want_f32 else y32.to(out_dtype)


def embed_tokens(ids: torch.Tensor, tok: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
    """ids (B, L) int32, tok (V, d), pos (≥L, d) → tok[ids] + pos[:L] (B, L, d).
    The kernel trusts ids to lie in [0, V): checking would synchronise."""
    _check("ids", ids, dtypes=(torch.int32,), ndim=2)
    _check("tok", tok, dtypes=_compute_dtypes(tok), ndim=2, device=ids.device, vectors=True)
    _check("pos", pos, dtypes=(tok.dtype,), ndim=2, device=ids.device, vectors=True)
    B, L = ids.shape
    d = tok.shape[1]
    if pos.shape[0] < L or pos.shape[1] != d:
        raise ValueError(f"pos: shape {tuple(pos.shape)} cannot serve L={L}, d={d}")
    if not ids.is_cuda:
        return embed_tokens_plain(ids, tok, pos)
    if d % 8:
        raise ValueError(f"embed_tokens kernel needs d % 8 == 0, got {d}")
    out = torch.empty((B, L, d), dtype=tok.dtype, device=ids.device)
    _build.launch("b3_embed_tokens", _ptr(ids), _ptr(tok), _ptr(pos), _ptr(out), B * L, L, d,
                  _stream(ids))
    embed_tokens.launches += 1
    return out


def embed_tokens_plain(ids, tok, pos):
    L = ids.shape[1]
    return (tok[ids.long()].float() + pos[:L].float()).to(tok.dtype)


HEAD_CLASSES = 32   # columns of the packed head: gather_head's products are n32


def pad_head(head_w: torch.Tensor) -> torch.Tensor:
    """(d, C) head → (d, 32), zero columns past C: the layout
    ``gather_head``'s kernel reads.  Pack it once with the weights."""
    d, C = head_w.shape
    if C > HEAD_CLASSES:
        raise ValueError(f"gather_head takes at most {HEAD_CLASSES} classes, got {C}")
    out = head_w.new_zeros((d, HEAD_CLASSES))
    out[:, :C] = head_w
    return out


def gather_head(h: torch.Tensor, pos: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                head_w: torch.Tensor, head_b: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Final LayerNorm + head at the k positions ``pos`` (B, k) int32 of h
    (B, L, d) → (B, k, C) f32, C = len(head_b); ``head_w`` (d, ≥ C) is read
    in its first C columns — on the card it must be ``pad_head``'s (d, 32).
    The kernel trusts pos to lie in [0, L): checking would synchronise."""
    _check("h", h, dtypes=_compute_dtypes(h), ndim=3, vectors=True)
    B, L, d = h.shape
    _check("pos", pos, dtypes=(torch.int32,), ndim=2, device=h.device)
    if pos.shape[0] != B:
        raise ValueError(f"pos: batch {pos.shape[0]} != {B}")
    _check("scale", scale, dtypes=(torch.float32,), shape=(d,), device=h.device, vectors=True)
    _check("shift", shift, dtypes=(torch.float32,), shape=(d,), device=h.device, vectors=True)
    _check("head_b", head_b, dtypes=(torch.float32,), ndim=1, device=h.device)
    C = head_b.shape[0]
    _check("head_w", head_w, dtypes=(h.dtype,), ndim=2, device=h.device, vectors=True)
    if head_w.shape[0] != d or head_w.shape[1] < C:
        raise ValueError(f"head_w: shape {tuple(head_w.shape)} does not take d={d}, C={C}")
    if not h.is_cuda:
        return gather_head_plain(h, pos, scale, shift, head_w, head_b, eps=eps)
    if head_w.shape[1] != HEAD_CLASSES:
        raise ValueError(f"head_w: the kernel reads the head packed by pad_head, (d, "
                         f"{HEAD_CLASSES}); got {tuple(head_w.shape)}")
    if d % 16:
        raise ValueError(f"gather_head kernel needs d % 16 == 0, got {d}")
    k = pos.shape[1]
    out = torch.empty((B, k, C), dtype=torch.float32, device=h.device)
    _build.launch("b3_gather_head", _ptr(h), _ptr(pos), _ptr(scale), _ptr(shift),
                  _ptr(head_w), _ptr(head_b), _ptr(out), B, L, k, d, C, eps, _stream(h))
    gather_head.launches += 1
    return out


def gather_head_plain(h, pos, scale, shift, head_w, head_b, *, eps=1e-6):
    hk = torch.gather(h, 1, pos.long()[..., None].expand(-1, -1, h.shape[2]))
    hn = _layernorm_f32(hk, scale, shift, eps).to(h.dtype).float()
    return hn @ head_w[:, :head_b.shape[0]].float() + head_b


def esm2_embed(ids: torch.Tensor, table: torch.Tensor, *, pad_idx: int = 1,
               mask_idx: int = 32, token_dropout: bool = True) -> torch.Tensor:
    """ids (B, L) int32, table (V, E) → (B, L, E) ESM2 layer-0 input:
    table[id] × (1 − is_mask) × 0.88 / (1 − n_mask / max(1, n_tok)) ×
    (1 − is_pad), with the counts per row (without ``token_dropout``:
    table[id] × (1 − is_pad)).  The kernel trusts ids to lie in [0, V)."""
    _check("ids", ids, dtypes=(torch.int32,), ndim=2)
    _check("table", table, dtypes=_compute_dtypes(table), ndim=2, device=ids.device,
           vectors=True)
    B, L = ids.shape
    d = table.shape[1]
    if not ids.is_cuda:
        return esm2_embed_plain(ids, table, pad_idx=pad_idx, mask_idx=mask_idx,
                                token_dropout=token_dropout)
    if d % 8:
        raise ValueError(f"esm2_embed kernel needs E % 8 == 0, got {d}")
    out = torch.empty((B, L, d), dtype=table.dtype, device=ids.device)
    _build.launch("b3_esm2_embed", _ptr(ids), _ptr(table), _ptr(out), B, L, d, pad_idx,
                  mask_idx, int(token_dropout), _stream(ids))
    esm2_embed.launches += 1
    return out


def esm2_embed_plain(ids, table, *, pad_idx=1, mask_idx=32, token_dropout=True):
    x = table[ids.long()].float()
    is_pad, is_mask = ids == pad_idx, ids == mask_idx
    if token_dropout:
        n_tok = (~is_pad).sum(-1).clamp(min=1).float()
        x = x.masked_fill(is_mask[..., None], 0.0)
        x = x * (0.88 / (1.0 - is_mask.sum(-1).float() / n_tok))[:, None, None]
    return x.masked_fill(is_pad[..., None], 0.0).to(table.dtype)


# --------------------------------------------------------------------------
# training backward: layernorm_bwd, col_sum (csrc/rowwise.cu),
# stage3_attention_bwd (csrc/stage3_attn_bwd.cu), esm2_attention_bwd
# (csrc/esm2_attn_bwd.cu)
# --------------------------------------------------------------------------

LNB_REGISTER_COLS = 1280        # layernorm_bwd holds rows up to this wide in registers
LNB_STAGED_BYTES = 227 << 10    # and stages a wider row of x, dy and the residual in one
                                # block's shared memory (sm_90's most a block)


@functools.lru_cache(maxsize=256)
def _layernorm_bwd_blocks(rows: int, d: int, x_f32: bool, res_bytes: int, wide: bool,
                          device: int) -> int:
    """layernorm_bwd's grid (its partial rows): the blocks the SMs hold at
    the route's occupancy, at most one per two rows a warp
    (``csrc/rowwise.cu``); 0 if the route does not take the row."""
    with torch.cuda.device(device):
        return _build.library().b3_layernorm_bwd_grid(rows, d, int(x_f32), res_bytes, int(wide))


def layernorm_bwd(x: torch.Tensor, dy: torch.Tensor, scale: torch.Tensor, *,
                  residual: torch.Tensor | None = None, eps: float = 1e-6,
                  out_dtype: torch.dtype, want_cd: bool = False):
    """Backward of ``layernorm`` over the last dim of x (rows, d), from its
    input (x̂ and rstd are recomputed) and the output gradient dy (rows, d)
    f32 → (dx + residual in ``out_dtype``, dscale, dshift) with dscale and
    dshift (d,) f32 summed over the rows in a fixed order (the same bits
    every call).  With ``want_cd`` the first item is (dx, dx in x's compute
    dtype)."""
    cd = _compute_dtypes(x)
    _check("x", x, dtypes=(torch.float32,) + cd, ndim=2, vectors=True)
    rows, d = x.shape
    _check("dy", dy, dtypes=(torch.float32,), shape=(rows, d), device=x.device, vectors=True)
    _check("scale", scale, dtypes=(torch.float32,), shape=(d,), device=x.device, vectors=True)
    if residual is not None:
        _check("residual", residual, dtypes=(torch.float32,) + cd, shape=(rows, d),
               device=x.device, vectors=True)
    if out_dtype not in (torch.float32,) + cd:
        raise TypeError(f"out_dtype {out_dtype} not in {(torch.float32,) + cd}")
    if not x.is_cuda:
        return layernorm_bwd_plain(x, dy, scale, residual=residual, eps=eps,
                                   out_dtype=out_dtype, want_cd=want_cd)
    res_bytes = 0 if residual is None else residual.element_size()
    if d % 8 or d * (x.element_size() + 4 + res_bytes) > LNB_STAGED_BYTES:
        raise ValueError(f"layernorm_bwd kernel needs d % 8 == 0 and a row of x, dy and the "
                         f"residual of at most {LNB_STAGED_BYTES} bytes, got d={d} in {x.dtype}")
    dx = torch.empty((rows, d), dtype=out_dtype, device=x.device)
    dx16 = torch.empty((rows, d), dtype=cd[0], device=x.device) if want_cd else None
    wide = d > LNB_REGISTER_COLS
    blocks = _layernorm_bwd_blocks(rows, d, x.dtype == torch.float32, res_bytes, wide,
                                   x.device.index)
    if not blocks:
        raise ValueError(f"layernorm_bwd kernel: a row of d={d} in {x.dtype} does not fit a "
                         f"block's shared memory")
    # [dγ | dβ] apart from the blocks' partial rows: the gradients outlive the call
    dgb = torch.empty(2 * d, dtype=torch.float32, device=x.device)
    partial = torch.empty((blocks, 2 * d), dtype=torch.float32, device=x.device)
    _build.launch("b3_layernorm_bwd", _ptr(x), int(x.dtype == torch.float32), _ptr(dy),
                  _ptr(scale), _ptr(residual),
                  int(residual is not None and residual.dtype == torch.float32), _ptr(dx),
                  int(out_dtype == torch.float32), _ptr(dx16), _ptr(dgb), _ptr(partial), rows, d,
                  blocks, int(wide), eps, _stream(x))
    layernorm_bwd.launches += 1
    return ((dx, dx16) if want_cd else dx), dgb[:d], dgb[d:]


def layernorm_bwd_plain(x, dy, scale, *, residual=None, eps=1e-6, out_dtype, want_cd=False):
    """``_ln_bwd`` (layer_block_tpu.py:58-68) in f32."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    rstd = torch.rsqrt((xf - mean).square().mean(-1, keepdim=True) + eps)
    xhat = (xf - mean) * rstd
    dyf = dy.float()
    dxh = dyf * scale.float()
    dx = rstd * (dxh - dxh.mean(-1, keepdim=True) - xhat * (dxh * xhat).mean(-1, keepdim=True))
    if residual is not None:
        dx = dx + residual.float()
    out = dx.to(out_dtype)
    if want_cd:
        out = (out, dx.to(_compute_dtypes(x)[0]))
    return out, (dyf * xhat).sum(0), dyf.sum(0)


COL_SUM_TILE = 64         # columns a col_sum block sums (8 a thread, 8 threads a row)
COL_SUM_MIN_ROWS = 64     # least rows a slab sums
COL_SUM_MAX_TILES = 4096  # tiles that may take more than one slab (the kernel's tickets)


def col_sum_plan(rows: int, n: int, capacity: int) -> tuple[int, int]:
    """col_sum's grid → (slabs, rows a slab): ceil(n / 64) column tiles
    times as many row slabs as ``capacity`` resident blocks hold (the SMs
    at the kernel's occupancy: one wave), each slab of at least
    ``COL_SUM_MIN_ROWS`` rows; every row lies in exactly one slab, and none
    is empty."""
    tiles = -(-n // COL_SUM_TILE)
    slabs = max(1, min(capacity // tiles, rows // COL_SUM_MIN_ROWS))
    if tiles > COL_SUM_MAX_TILES:
        slabs = 1
    per = max(1, -(-rows // slabs))
    return max(1, -(-rows // per)), per


@functools.cache
def _col_sum_capacity(x_f32: bool, device: int) -> int:
    with torch.cuda.device(device):
        return _build.library().b3_col_sum_capacity(int(x_f32))


def col_sum(x: torch.Tensor) -> torch.Tensor:
    """Column sums of x (rows, n) in f32 → (n,) f32 (the bias gradients),
    in a fixed order: the same inputs give the same bits."""
    cd = _compute_dtypes(x)
    _check("x", x, dtypes=(torch.float32,) + cd, ndim=2, vectors=True)
    rows, n = x.shape
    if not x.is_cuda:
        return col_sum_plain(x)
    if n % 8:
        raise ValueError(f"col_sum kernel needs n % 8 == 0, got {n}")
    f32 = x.dtype == torch.float32
    slabs, per = col_sum_plan(rows, n, _col_sum_capacity(f32, x.device.index))
    buf = torch.empty(n * (1 + slabs * (slabs > 1)), dtype=torch.float32, device=x.device)
    _build.launch("b3_col_sum", _ptr(x), int(f32), rows, n, _ptr(buf), _ptr(buf) + 4 * n, slabs,
                  per, _stream(x))
    col_sum.launches += 1
    return buf[:n]


def col_sum_plain(x):
    return x.float().sum(0)


LIN_BWD_MIN_ROWS = 128      # stage3_attention_bwd: least sequence rows a linear-heads chunk
LIN_BWD_BLOCKS_PER_SM = 4   # ... and about this many (chunk, pair) blocks an SM


def stage3_linear_bwd_plan(L: int, pairs: int, sms: int, max_pairs: int) -> int:
    """Rows a chunk of the linear heads' backward (``csrc/stage3_attn_bwd.cu``
    ``lin_bwd1..3``): the fewest rows, ``LIN_BWD_MIN_ROWS`` · 2^k, whose
    (chunk, pair) blocks stay within ``LIN_BWD_BLOCKS_PER_SM`` an SM; the
    whole sequence past ``max_pairs`` pairs (the kernel's tickets,
    ``lin_bwd_max_pairs``).  At L=1024 and 8 linear heads: B=2 and B=4 in
    chunks of 128 rows, B=32 of 512 (at B=4 and 32 the fastest of 64 to
    1024 rows on an H100, ``cli/measure_attention.py --lin-chunk-sweep``).
    Every row lies in exactly one chunk, and none is empty."""
    pairs = max(pairs, 1)
    if pairs > max_pairs:
        return L
    rows = LIN_BWD_MIN_ROWS
    while rows < L and pairs * -(-L // rows) > LIN_BWD_BLOCKS_PER_SM * sms:
        rows *= 2
    return min(rows, L)


@functools.cache
def lin_bwd_max_pairs() -> int:
    """(batch row, linear head) pairs whose backward may take more than one
    chunk: the kernel's ticket count."""
    return _build.library().b3_stage3_bwd_lin_max_pairs()


def stage3_attention_bwd(qkv: torch.Tensor, dattn: torch.Tensor, *, heads: int,
                         local_heads: int, window: int) -> torch.Tensor:
    """Gradient of ``stage3_attention_core`` with respect to its input: qkv
    (B, L, 3d) [q | k | v] and the output gradient dattn (B, L, d) →
    dqkv (B, L, 3d) in qkv's dtype; every softmax is recomputed."""
    cd = _compute_dtypes(qkv)
    _check("qkv", qkv, dtypes=cd, ndim=3, vectors=True)
    B, L, d3 = qkv.shape
    if d3 % 3 or (d3 // 3) % heads:
        raise ValueError(f"qkv last dim {d3} is not 3·d with d divisible by heads={heads}")
    d = d3 // 3
    _check("dattn", dattn, dtypes=(qkv.dtype,), shape=(B, L, d), device=qkv.device, vectors=True)
    if not 0 <= local_heads <= heads:
        raise ValueError(f"local_heads {local_heads} outside [0, {heads}]")
    if local_heads and L % window:
        raise ValueError(f"L={L} not divisible by window={window}")
    if not qkv.is_cuda:
        return stage3_attention_bwd_plain(qkv, dattn, heads=heads, local_heads=local_heads,
                                          window=window)
    dh = d // heads
    if dh not in (32, 64):   # the band passes check each row's band: any window L divides
        raise ValueError(f"stage3_attention_bwd kernel needs head dim 32 or 64, got {dh}")
    dev, f32 = qkv.device, torch.float32
    ng = heads - local_heads
    chunk = stage3_linear_bwd_plan(L, B * ng, _sm_count(dev.index), lin_bwd_max_pairs())
    dqkv = torch.empty_like(qkv)
    # the band heads' (m, 1/l, D, 0) a query row, pass 1 to pass 2
    stats = torch.empty((B, local_heads, L, 4), dtype=f32, device=dev) if local_heads else None
    ws = None
    if ng:
        # f32 scratch a pair, of the size csrc/stage3_attn_bwd.cu's LinWs lays out
        floats = _build.library().b3_stage3_bwd_ws_floats(-(-L // chunk), dh)
        ws = torch.empty(B * ng * floats, dtype=f32, device=dev)
    _build.launch("b3_stage3_attention_bwd", _ptr(qkv), _ptr(dattn), _ptr(dqkv), _ptr(stats),
                  _ptr(ws), B, L, d, heads, local_heads, window, chunk, _stream(qkv))
    stage3_attention_bwd.launches += 1
    return dqkv


def _unfold_windows(x: torch.Tensor) -> torch.Tensor:
    """(..., nw, 3W, D) look-around slots → (..., nw, W, D): window w takes
    slot 1 of its own row, slot 0 of row w+1 and slot 2 of row w-1."""
    W = x.shape[-2] // 3
    out = x[..., W:2 * W, :].clone()
    out[..., :-1, :, :] += x[..., 1:, :W, :]
    out[..., 1:, :, :] += x[..., :-1, 2 * W:, :]
    return out


def stage3_attention_bwd_plain(qkv, dattn, *, heads, local_heads, window):
    """The TPU kernel's backward (layer_block_tpu.py:268-354): f32 sums,
    p, dS, q', k', ctx and dctx rounded to qkv's dtype where it rounds them."""
    dt = qkv.dtype
    B, L, d3 = qkv.shape
    d = d3 // 3
    dh = d // heads
    scale = dh ** -0.5
    rnd = lambda z: z.to(dt).float()  # noqa: E731
    q, k, v = (z.reshape(B, L, heads, dh).transpose(1, 2).float() for z in qkv.split(d, dim=-1))
    da = dattn.reshape(B, L, heads, dh).transpose(1, 2).float()
    nl = local_heads
    dq, dk, dv = torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    if nl:
        nw = L // window
        bucket = lambda z: z[:, :nl].reshape(B, nl, nw, window, dh)  # noqa: E731
        qw, daw = bucket(q), bucket(da)
        kn, vn = _look_around(bucket(k)), _look_around(bucket(v))
        dots = (qw @ kn.transpose(-1, -2)) * scale
        dots = dots.masked_fill(_band_mask(nw, window, q.device)[:, None, :], -1e9)
        p = torch.softmax(dots, dim=-1)
        dvn = rnd(p).transpose(-1, -2) @ daw
        dp = daw @ vn.transpose(-1, -2)
        ds = rnd(p * (dp - (dp * p).sum(-1, keepdim=True)) * scale)
        dq[:, :nl] = (ds @ kn).reshape(B, nl, L, dh)
        dk[:, :nl] = _unfold_windows(ds.transpose(-1, -2) @ qw).reshape(B, nl, L, dh)
        dv[:, :nl] = _unfold_windows(dvn).reshape(B, nl, L, dh)
    if heads > nl:
        qg, kg, vg, dl = q[:, nl:], k[:, nl:], v[:, nl:], da[:, nl:]
        smq = torch.softmax(qg, dim=-1)
        smk = torch.softmax(kg, dim=-2)
        qf, kf = rnd(smq * scale), rnd(smk)
        ctx = rnd(kf.transpose(-1, -2) @ vg)            # (i, j) = Σ_n k'[n, i] v[n, j]
        dctx = rnd(qf.transpose(-1, -2) @ dl)           # (i, j) = Σ_n q'[n, i] dA[n, j]
        dqf = dl @ ctx.transpose(-1, -2)
        dkf = vg @ dctx.transpose(-1, -2)
        dv[:, nl:] = kf @ dctx
        dsq = dqf * scale
        dq[:, nl:] = smq * (dsq - (dsq * smq).sum(-1, keepdim=True))
        dk[:, nl:] = smk * (dkf - (dkf * smk).sum(-2, keepdim=True))
    merge = lambda z: z.transpose(1, 2).reshape(B, L, d)  # noqa: E731
    return torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1).to(dt)


def esm2_attention_bwd(qkv: torch.Tensor, dattn: torch.Tensor, padding_mask: torch.Tensor,
                       cos: torch.Tensor, sin: torch.Tensor, *, heads: int) -> torch.Tensor:
    """Gradient of ``esm2_attention`` with respect to its input: qkv (B, L,
    3E) [q | k | v], the output gradient dattn (B, L, E), padding_mask (B,
    L) int32 and the rotary tables (L, Dh) → dqkv (B, L, 3E) in qkv's
    dtype, dq and dk in pre-rotation coordinates; every softmax is
    recomputed."""
    cd = _compute_dtypes(qkv)
    _check("qkv", qkv, dtypes=cd, ndim=3, vectors=True)
    B, L, e3 = qkv.shape
    if e3 % 3 or (e3 // 3) % heads:
        raise ValueError(f"qkv last dim {e3} is not 3·E with E divisible by heads={heads}")
    E = e3 // 3
    dh = E // heads
    _check("dattn", dattn, dtypes=(qkv.dtype,), shape=(B, L, E), device=qkv.device, vectors=True)
    _check("padding_mask", padding_mask, dtypes=(torch.int32,), shape=(B, L),
           device=qkv.device)
    _check("cos", cos, dtypes=(qkv.dtype,), shape=(L, dh), device=qkv.device, vectors=True)
    _check("sin", sin, dtypes=(qkv.dtype,), shape=(L, dh), device=qkv.device, vectors=True)
    if not qkv.is_cuda:
        return esm2_attention_bwd_plain(qkv, dattn, padding_mask, cos, sin, heads=heads)
    if dh not in (32, 64):
        raise ValueError(f"esm2_attention_bwd kernel needs head dim 32 or 64, got {dh}")
    dqkv = torch.empty_like(qkv)
    # scratch: per-row softmax statistics, and the rotated q, k, v and dattn
    # with each head's rows contiguous (the kernel's TMA operands)
    stats = torch.empty((B, heads, L, 4), dtype=torch.float32, device=qkv.device)
    ops = torch.empty((4, B, heads, L, dh), dtype=qkv.dtype, device=qkv.device)
    _build.launch("b3_esm2_attention_bwd", _ptr(qkv), _ptr(dattn), _ptr(padding_mask), _ptr(cos),
                  _ptr(sin), _ptr(dqkv), _ptr(stats), _ptr(ops), B, L, E, heads, _stream(qkv))
    esm2_attention_bwd.launches += 1
    return dqkv


def _unrotate(d, cos, sin, rnd):
    """Adjoint of ``apply_rotary``: d·cos + rotate_halfᵀ(rnd(d·sin)), with
    rotate_halfᵀ(w) = [w2, -w1] (the TPU kernel's ``unrot``,
    esm2_block_tpu.py:202-208)."""
    w1, w2 = rnd(d * sin.float()).chunk(2, dim=-1)
    return d * cos.float() + torch.cat([w2, -w1], dim=-1)


def esm2_attention_bwd_plain(qkv, dattn, padding_mask, cos, sin, *, heads):
    """The TPU kernel's backward (esm2_block_tpu.py:210-258): f32 sums, p
    rounded to qkv's dtype for dV, dS before the dQ/dK products, and the
    rotation's adjoint rounded where ``unrot`` rounds."""
    dt = qkv.dtype
    B, L, e3 = qkv.shape
    E = e3 // 3
    rnd = lambda z: z.to(dt).float()  # noqa: E731
    q, k, v = _esm2_heads(qkv, cos, sin, heads)
    p = _esm2_probs(q, k, padding_mask)
    da = dattn.reshape(B, L, heads, E // heads).transpose(1, 2).float()
    dv = rnd(p).transpose(-1, -2) @ da
    dp = da @ v.float().transpose(-1, -2)
    ds = rnd(p * (dp - (dp * p).sum(-1, keepdim=True)) * q.shape[-1] ** -0.5)
    dq = _unrotate(ds @ k.float(), cos, sin, rnd)
    dk = _unrotate(ds.transpose(-1, -2) @ q.float(), cos, sin, rnd)
    merge = lambda z: z.transpose(1, 2).reshape(B, L, E)  # noqa: E731
    return torch.cat([merge(dq), merge(dk), merge(dv)], dim=-1).to(dt)


# --------------------------------------------------------------------------
# int8 serving recipe: quant_rows (csrc/rowwise.cu), gemm_i8 (csrc/gemm_i8.cu)
# --------------------------------------------------------------------------

QUANT_ROWS_MAX_D = 16384   # quant_rows holds a row in registers: 8 warps x 2048 columns


def quant_rows(x: torch.Tensor):
    """Dynamic per-row symmetric int8 of x (rows, d), f32 or the compute
    dtype → (codes (rows, d) int8, scales (rows,) f32): amax = max(max|x|,
    1e-6) in f32, codes rint(x · (127 / amax)) clipped to ±127, scale
    amax / 127 (``ops/quant.py::quant_rows``)."""
    _check("x", x, dtypes=(torch.float32,) + _compute_dtypes(x), ndim=2, vectors=True)
    rows, d = x.shape
    if not x.is_cuda:
        return quant_rows_plain(x)
    if d % 8 or d > QUANT_ROWS_MAX_D:
        raise ValueError(f"quant_rows kernel needs d % 8 == 0 and d <= {QUANT_ROWS_MAX_D}, "
                         f"got {d}")
    q = torch.empty((rows, d), dtype=torch.int8, device=x.device)
    a = torch.empty(rows, dtype=torch.float32, device=x.device)
    _build.launch("b3_quant_rows", _ptr(x), int(x.dtype == torch.float32), _ptr(q), _ptr(a),
                  rows, d, _stream(x))
    quant_rows.launches += 1
    return q, a


def quant_rows_plain(x):
    q, a = _quant_rows_f32(x)
    return q, a[:, 0]


def gemm_i8(a: torch.Tensor, a_scale: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
            bias: torch.Tensor | None = None, *, act: str = "none",
            residual: torch.Tensor | None = None, out_dtype: torch.dtype) -> torch.Tensor:
    """``act(f32(a · wᵀ) · a_scale[m] · w_scale[n] + bias) + residual`` →
    (M, N) in ``out_dtype``: a (M, K) int8 codes with per-row scales (M,),
    w (N, K) int8 codes with per-output-channel scales (N,), the product
    summed exactly in int32; bias (N,) f32; residual (M, N) f32 or the
    compute dtype."""
    cd = _compute_dtypes(a)
    _check("a", a, dtypes=(torch.int8,), ndim=2, vectors=True)
    M, K = a.shape
    _check("a_scale", a_scale, dtypes=(torch.float32,), shape=(M,), device=a.device)
    _check("w", w, dtypes=(torch.int8,), ndim=2, device=a.device, vectors=True)
    if w.shape[1] != K:
        raise ValueError(f"w: shape {tuple(w.shape)} does not contract with a {tuple(a.shape)}")
    N = w.shape[0]
    _check("w_scale", w_scale, dtypes=(torch.float32,), shape=(N,), device=a.device)
    if bias is not None:
        _check("bias", bias, dtypes=(torch.float32,), shape=(N,), device=a.device)
    if residual is not None:
        _check("residual", residual, dtypes=(torch.float32,) + cd, shape=(M, N),
               device=a.device, vectors=True)
    if act not in _ACT:
        raise ValueError(f"act must be one of {sorted(_ACT)}, got {act!r}")
    if out_dtype not in (torch.float32,) + cd:
        raise TypeError(f"out_dtype {out_dtype} not in {(torch.float32,) + cd}")
    if not a.is_cuda:
        return gemm_i8_plain(a, a_scale, w, w_scale, bias, act=act, residual=residual,
                             out_dtype=out_dtype)
    if K % 32 or N % 8:
        raise ValueError(f"gemm_i8 needs K % 32 == 0 and N % 8 == 0, got K={K} N={N}")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    _build.launch("b3_gemm_i8", _ptr(a), _ptr(a_scale), _ptr(w), _ptr(w_scale), _ptr(bias),
                  _ptr(residual), _ptr(out), M, N, K, _ACT[act],
                  int(residual is not None and residual.dtype == torch.bfloat16),
                  int(out_dtype == torch.float32), _stream(a))
    gemm_i8.launches += 1
    return out


def gemm_i8_plain(a, a_scale, w, w_scale, bias=None, *, act="none", residual=None,
                  out_dtype=torch.float32):
    """The int32 sum exact in f64 (|Σ| < 2^53), rounded once to f32, as the
    kernel converts its int32 accumulator."""
    acc = (a.double() @ w.double().t()).float()
    y = acc * a_scale[:, None] * w_scale[None, :]
    if bias is not None:
        y = y + bias
    if act != "none":
        y = gelu(y, act)
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype)


def linear_i8(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
              bias: torch.Tensor | None = None, *, act: str = "none",
              residual: torch.Tensor | None = None, out_dtype: torch.dtype) -> torch.Tensor:
    """x (M, K) → ``quant_rows`` → ``gemm_i8``: the int8 recipe's dynamic
    activation quant followed by its dequantising product."""
    q, a = quant_rows(x)
    return gemm_i8(q, a, w, w_scale, bias, act=act, residual=residual, out_dtype=out_dtype)


# --------------------------------------------------------------------------
# local_window_attention  (csrc/local_attn.cu)
# --------------------------------------------------------------------------

LOCAL_TILE = {32: 128, 64: 64}   # f32: query rows per block by head dim


def local_window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                           window: int) -> torch.Tensor:
    """q, k, v (B, H, L, D), L % window == 0 → (B, H, L, D) in v's dtype:
    band attention over windows w-1..w+1 (``local_window_attention_plain``
    keeps the TPU kernel's rounding points).  Forward only.  On the card
    bf16 runs on the tensor cores (any window), f32 on CUDA cores at the
    TPU kernel's f32 points (a window that tiles by ``LOCAL_TILE[D]`` query
    rows); the dtype alone chooses."""
    _check("q", q, dtypes=(torch.float32, torch.bfloat16), ndim=4, vectors=True)
    _check("k", k, dtypes=(q.dtype,), shape=q.shape, device=q.device, vectors=True)
    _check("v", v, dtypes=(q.dtype,), shape=q.shape, device=q.device, vectors=True)
    B, H, L, D = q.shape
    if L % window:
        raise ValueError(f"L={L} not divisible by window={window}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("local_window_attention is forward only (as its TPU kernel); "
                           "train with attn_impl 'plain', 'block' or 'layer-block'")
    if not q.is_cuda:
        return local_window_attention_plain(q, k, v, window=window)
    if D not in LOCAL_TILE:
        raise ValueError(f"local_window_attention kernel needs head dim 32 or 64, got D={D}")
    is_f32 = q.dtype == torch.float32
    tq = min(window, LOCAL_TILE[D]) if is_f32 else 0
    if is_f32 and window % tq:
        raise ValueError(f"local_window_attention's f32 kernel needs a window that tiles by "
                         f"{tq} query rows; got D={D} window={window}")
    out = torch.empty_like(v)
    _build.launch("b3_local_window_attention", _ptr(q), _ptr(k), _ptr(v), _ptr(out), B * H, L,
                  D, window, tq, float(D ** -0.5), int(is_f32), _stream(q))
    local_window_attention.launches += 1
    return out


def local_window_attention_plain(q, k, v, *, window):
    """``local_window_attention_pallas``'s rounding points
    (local_attention_tpu.py:34-68): q scaled in f32 before the dot;
    e = exp(s − m) rounded to v's dtype unnormalised before the AV product;
    the f32 sum divided by the f32 denominator after it."""
    *lead, L, D = q.shape
    nw = L // window

    def bucket(x):
        return x.reshape(*lead, nw, window, D).float()

    bq = bucket(q) * D ** -0.5
    dots = bq @ _look_around(bucket(k)).transpose(-1, -2)
    dots = dots.masked_fill(_band_mask(nw, window, q.device)[:, None, :], NEG_INF)
    e = torch.exp(dots - dots.amax(-1, keepdim=True))
    out = (e.to(v.dtype).float() @ _look_around(bucket(v))) / e.sum(-1, keepdim=True)
    return out.reshape(*lead, L, D).to(v.dtype)


KERNELS = (gemm_bias_act, stage3_attention_core, stage3_attention_core_i8, dense_attention,
           bias_layernorm,
           layernorm, embed_tokens, gather_head, esm2_embed, esm2_attention, flash_attention,
           gemm_dx, gemm_dw, layernorm_bwd, col_sum, stage3_attention_bwd, esm2_attention_bwd,
           gemm_i8, quant_rows, local_window_attention)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launches()

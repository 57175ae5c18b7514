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

import torch
import torch.nn.functional as F

from biom3_tpu_torch.ops import _build
from biom3_tpu_torch.ops.linear_attention import linear_attention
from biom3_tpu_torch.ops.local_attention import local_window_attention
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
                  out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """``act(a @ w + bias) + residual`` → (M, N) in ``out_dtype`` (default
    a's dtype).  a (M, K), w (K, N); bias (N,) f32; residual (M, N) f32 or
    a's dtype."""
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
        return gemm_bias_act_plain(a, w, bias, act=act, residual=residual, out_dtype=out_dtype)
    if K % 8 or N % 8:
        raise ValueError(f"gemm_bias_act needs K % 8 == 0 and N % 8 == 0, got K={K} N={N}")
    out = torch.empty((M, N), dtype=out_dtype, device=a.device)
    _build.launch("b3_gemm_bias_act", _ptr(a), _ptr(w), _ptr(bias), _ptr(residual),
                  _ptr(out), M, N, K, _ACT[act],
                  int(residual is not None and residual.dtype == torch.bfloat16),
                  int(out_dtype == torch.float32), _stream(a))
    gemm_bias_act.launches += 1
    return out


def gemm_bias_act_plain(a, w, bias=None, *, act="none", residual=None, out_dtype=None):
    y = a.float() @ w.float()
    if bias is not None:
        y = y + bias.float()
    if act != "none":
        y = gelu(y, act)
    if residual is not None:
        y = y + residual.float()
    return y.to(out_dtype or a.dtype)


# --------------------------------------------------------------------------
# stage3_attention_core  (csrc/stage3_attn.cu)
# --------------------------------------------------------------------------

def stage3_attention_core(qkv: torch.Tensor, *, heads: int, local_heads: int,
                          window: int) -> torch.Tensor:
    """(B, L, 3d) fused [q | k | v] → (B, L, d) head outputs, local heads
    first: band-local heads (±1 window, joint softmax) then linear heads."""
    _check("qkv", qkv, dtypes=_compute_dtypes(qkv), ndim=3, vectors=True)
    B, L, d3 = qkv.shape
    if d3 % 3 or (d3 // 3) % heads:
        raise ValueError(f"qkv last dim {d3} is not 3·d with d divisible by heads={heads}")
    d = d3 // 3
    if not 0 <= local_heads <= heads:
        raise ValueError(f"local_heads {local_heads} outside [0, {heads}]")
    if local_heads and L % window:
        raise ValueError(f"L={L} not divisible by window={window}")
    if not qkv.is_cuda:
        return stage3_attention_core_plain(qkv, heads=heads, local_heads=local_heads,
                                           window=window)
    dh = d // heads
    tile = min(window, 128 if dh == 32 else 64)
    if dh not in (32, 64) or (local_heads and (window % tile or tile % 8)):
        raise ValueError(f"stage3_attention_core kernel needs head dim 32 or 64 and a "
                         f"window that tiles by {tile}; got Dh={dh} window={window}")
    out = torch.empty((B, L, d), dtype=qkv.dtype, device=qkv.device)
    _build.launch("b3_stage3_attention_core", _ptr(qkv), _ptr(out), B, L, d, heads,
                  local_heads, window, _stream(qkv))
    stage3_attention_core.launches += 1
    return out


def stage3_attention_core_plain(qkv, *, heads, local_heads, window):
    B, L, d3 = qkv.shape
    d = d3 // 3
    q, k, v = (t.reshape(B, L, heads, d // heads).transpose(1, 2)
               for t in qkv.split(d, dim=-1))
    outs = []
    if local_heads:
        outs.append(local_window_attention(q[:, :local_heads], k[:, :local_heads],
                                           v[:, :local_heads], window=window))
    if heads > local_heads:
        outs.append(linear_attention(q[:, local_heads:], k[:, local_heads:],
                                     v[:, local_heads:]))
    return torch.cat(outs, dim=1).transpose(1, 2).reshape(B, L, d)


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
    _build.launch("b3_esm2_attention", _ptr(qkv), _ptr(padding_mask), _ptr(cos), _ptr(sin),
                  _ptr(out), B, L, E, heads, _stream(qkv))
    esm2_attention.launches += 1
    return out


def esm2_attention_plain(qkv, padding_mask, cos, sin, *, heads):
    B, L, e3 = qkv.shape
    E = e3 // 3
    q, k, v = (t.reshape(B, L, heads, E // heads).transpose(1, 2)
               for t in qkv.split(E, dim=-1))
    q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
    return flash_attention_plain(q, k, v, padding_mask).transpose(1, 2).reshape(B, L, E)


# --------------------------------------------------------------------------
# row-wise kernels  (csrc/rowwise.cu)
# --------------------------------------------------------------------------

def bias_layernorm(h: torch.Tensor, bias: torch.Tensor, scale: torch.Tensor,
                   shift: torch.Tensor, *, eps: float = 1e-6):
    """h (B, L, d) + bias (B, d) → (xb f32, LayerNorm(xb) in h's dtype)."""
    _check("h", h, dtypes=_compute_dtypes(h), ndim=3, vectors=True)
    B, L, d = h.shape
    _check("bias", bias, dtypes=(h.dtype,), shape=(B, d), device=h.device, vectors=True)
    _check("scale", scale, dtypes=(torch.float32,), shape=(d,), device=h.device)
    _check("shift", shift, dtypes=(torch.float32,), shape=(d,), device=h.device)
    if not h.is_cuda:
        return bias_layernorm_plain(h, bias, scale, shift, eps=eps)
    if d % 8:
        raise ValueError(f"bias_layernorm kernel needs d % 8 == 0, got {d}")
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
    Returns y in ``out_dtype``, or (y, y in f32) with ``want_f32``."""
    cd = _compute_dtypes(x)
    _check("x", x, dtypes=(torch.float32,) + cd, vectors=True)
    d = x.shape[-1]
    _check("scale", scale, dtypes=(torch.float32,), shape=(d,), device=x.device)
    _check("shift", shift, dtypes=(torch.float32,), shape=(d,), device=x.device)
    if out_dtype not in cd:
        raise TypeError(f"out_dtype {out_dtype} not in {cd}")
    if not x.is_cuda:
        return layernorm_plain(x, scale, shift, eps=eps, out_dtype=out_dtype,
                               want_f32=want_f32)
    if d % 8:
        raise ValueError(f"layernorm kernel needs d % 8 == 0, got {d}")
    y = torch.empty(x.shape, dtype=out_dtype, device=x.device)
    y32 = torch.empty(x.shape, dtype=torch.float32, device=x.device) if want_f32 else None
    _build.launch("b3_layernorm", _ptr(x), int(x.dtype == torch.float32), _ptr(scale),
                  _ptr(shift), _ptr(y), _ptr(y32), x.numel() // d, d, eps, _stream(x))
    layernorm.launches += 1
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


def gather_head(h: torch.Tensor, pos: torch.Tensor, scale: torch.Tensor, shift: torch.Tensor,
                head_w: torch.Tensor, head_b: torch.Tensor, *, eps: float = 1e-6) -> torch.Tensor:
    """Final LayerNorm + (d, C) head at the k positions ``pos`` (B, k) int32
    of h (B, L, d) → (B, k, C) f32.  The kernel trusts pos to lie in
    [0, L): checking would synchronise."""
    _check("h", h, dtypes=_compute_dtypes(h), ndim=3)
    B, L, d = h.shape
    _check("pos", pos, dtypes=(torch.int32,), ndim=2, device=h.device)
    if pos.shape[0] != B:
        raise ValueError(f"pos: batch {pos.shape[0]} != {B}")
    _check("scale", scale, dtypes=(torch.float32,), shape=(d,), device=h.device)
    _check("shift", shift, dtypes=(torch.float32,), shape=(d,), device=h.device)
    _check("head_w", head_w, dtypes=(h.dtype,), ndim=2, device=h.device)
    if head_w.shape[0] != d:
        raise ValueError(f"head_w: shape {tuple(head_w.shape)} does not take d={d}")
    C = head_w.shape[1]
    _check("head_b", head_b, dtypes=(torch.float32,), shape=(C,), device=h.device)
    if not h.is_cuda:
        return gather_head_plain(h, pos, scale, shift, head_w, head_b, eps=eps)
    k = pos.shape[1]
    out = torch.empty((B, k, C), dtype=torch.float32, device=h.device)
    _build.launch("b3_gather_head", _ptr(h), _ptr(pos), _ptr(scale), _ptr(shift),
                  _ptr(head_w), _ptr(head_b), _ptr(out), B, L, k, d, C, eps, _stream(h))
    gather_head.launches += 1
    return out


def gather_head_plain(h, pos, scale, shift, head_w, head_b, *, eps=1e-6):
    hk = torch.gather(h, 1, pos.long()[..., None].expand(-1, -1, h.shape[2]))
    hn = _layernorm_f32(hk, scale, shift, eps).to(h.dtype).float()
    return hn @ head_w.float() + head_b


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


KERNELS = (gemm_bias_act, stage3_attention_core, dense_attention, bias_layernorm,
           layernorm, embed_tokens, gather_head, esm2_embed, esm2_attention, flash_attention)


def reset_launches() -> None:
    for fn in KERNELS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {fn.__name__: fn.launches for fn in KERNELS}


reset_launches()

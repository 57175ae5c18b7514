"""Stage-3 ProteoScribe as a plain PyTorch module (f32 reference path).

Port of ``biom3_tpu/models/proteoscribe.py:39-403``: token embedding plus
axial positions, a sinusoidal time embedding through an MLP into one
additive bias per layer (plus the same for the condition z_c), ``depth``
pre-norm layers of split-head attention (local-window heads first, then
linear heads) and GELU FF, final LayerNorm and head → (B, L, C) logits.

Parameter names are the reference DiffTransformer state-dict keys that
``biom3_tpu/io/export.py::proteoscribe_params_to_torch`` emits
(``transformer.x_emb_NN.weight``, ``transformer.transformer_blocks.{b}.{l}
.layers.layers.0.0.fn.to_q.weight``, …), so a reference ``.bin`` loads with
``load_state_dict``.  LayerNorm eps is 1e-6, as in the JAX package.

This module is the CPU path's reference and the plain version of the whole
stack that ``models/fused_forward.py`` runs on the kernels.  For training it
takes the JAX module's switches (``proteoscribe.py:142-162``, ``:205-236``,
``:387-391``):

* ``attn_impl``: ``"plain"`` (torch ops), ``"block"`` (the attention
  sub-block on ``ops/attn_block.py``'s kernels, LayerNorms and FF in torch),
  ``"layer-block"`` (the whole layer on ``ops/layer_block.py``'s
  kernels; no dropout path, as the TPU kernel) or ``"kernel"`` (torch ops
  with the band-local heads on the forward-only ``local_window_attention``
  kernel: the JAX module's ``attn_impl="pallas"``);
* ``dtype``: the compute dtype of the projections, attention and FF; the
  parameters, LayerNorms, embeddings, conditioning MLPs, final norm and
  head stay f32 (Flax ``dtype=`` semantics);
* ``remat``: each layer rematerialised in the backward
  (``torch.utils.checkpoint``), in train mode;
* dropout at the reference's two places, active in train mode: after the
  attention's out-projection (``attn_layer_dropout``) and between the FF's
  GELU and its second product (``ff_dropout``).
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from biom3_tpu_torch.config import ProteoScribeConfig
from biom3_tpu_torch.ops.attn_block import split_attention_block
from biom3_tpu_torch.ops.layer_block import transformer_layer_block
from biom3_tpu_torch.ops.linear_attention import linear_attention
from biom3_tpu_torch.ops.local_attention import local_window_attention
from biom3_tpu_torch.parallel.tensor import copy_to_tp, reduce_from_tp, scatter_to_tp

LN_EPS = 1e-6
ATTN_IMPLS = ("plain", "block", "layer-block", "kernel")


def _dense(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """nn.Dense(dtype=...): input, weight and bias cast to ``dtype``."""
    bias = None if layer.bias is None else layer.bias.to(dtype)
    return F.linear(x.to(dtype), layer.weight.to(dtype), bias)


def sinusoidal_time_embedding(t: torch.Tensor, dim: int, num_steps: float,
                              rescale_steps: float = 4000.0) -> torch.Tensor:
    """ref SinusoidalPosEmb (cond_diff_transformer_layer.py:10-42); note the
    ``half - 1`` divisor."""
    t = t.float() / num_steps * rescale_steps
    half = dim // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                     * -(math.log(10000.0) / (half - 1)))
    ang = t[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


class ConditioningMLP(nn.Sequential):
    """in → 4·dim → softplus → dim·n_layers; called, it returns the flat
    (…, dim·n_blocks·depth) biases (ref y_mlp / time mlp,
    cond_diff_transformer_layer.py:93-105)."""

    def __init__(self, in_dim: int, cfg: ProteoScribeConfig):
        super().__init__(nn.Linear(in_dim, cfg.dim * 4), nn.Softplus(),
                         nn.Linear(cfg.dim * 4, cfg.dim * cfg.n_blocks * cfg.depth))


class SplitHeadAttention(nn.Module):
    """First ``local_heads`` heads band-local, the rest linear attention;
    q/k/v without bias, output projection with bias."""

    def __init__(self, cfg: ProteoScribeConfig, attn_impl: str = "plain",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.attn_impl, self.dtype = cfg, attn_impl, dtype
        self.tp = None   # parallel/tensor.TensorParallel: the weights are this rank's shards
        d = cfg.dim
        self.to_q = nn.Linear(d, d, bias=False)
        self.to_k = nn.Linear(d, d, bias=False)
        self.to_v = nn.Linear(d, d, bias=False)
        self.to_out = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg, dt = self.cfg, self.dtype
        if self.attn_impl == "block":
            return F.dropout(self._block(x), cfg.attn_layer_dropout, self.training)
        B, L, _ = x.shape
        split = lambda z: z.reshape(B, L, cfg.heads, cfg.head_dim).transpose(1, 2)  # noqa: E731
        q, k, v = (split(_dense(lin, x, dt)) for lin in (self.to_q, self.to_k, self.to_v))
        nl = cfg.local_heads
        outs = []
        if nl > 0:
            outs.append(local_window_attention(
                q[:, :nl], k[:, :nl], v[:, :nl], window=cfg.local_window,
                impl="kernel" if self.attn_impl == "kernel" else "plain"))
        if cfg.global_heads > 0:
            outs.append(linear_attention(q[:, nl:], k[:, nl:], v[:, nl:]))
        out = torch.cat(outs, dim=1).transpose(1, 2).reshape(B, L, cfg.dim)
        return F.dropout(_dense(self.to_out, out, dt), cfg.attn_layer_dropout, self.training)

    def _block(self, x: torch.Tensor) -> torch.Tensor:
        """The sub-block on the kernels; under tp on the rank's heads, its
        partial out-projection summed over tp in f32, then + bo."""
        cfg, dt, tp = self.cfg, self.dtype, self.tp
        w = [lin.weight.t() for lin in (self.to_q, self.to_k, self.to_v, self.to_out)]
        if tp is None:
            return split_attention_block(x.to(dt), *w, self.to_out.bias,
                                         local_heads=cfg.local_heads, heads=cfg.heads,
                                         window=cfg.local_window)
        heads, local = tp.heads(cfg.heads, cfg.local_heads)
        out = split_attention_block(copy_to_tp(x.float(), tp).to(dt), *w, None,
                                    local_heads=local, heads=heads, window=cfg.local_window,
                                    out_dtype=torch.float32)
        return (reduce_from_tp(out, tp) + self.to_out.bias.float()).to(dt)


class FeedForward(nn.Module):
    def __init__(self, cfg: ProteoScribeConfig, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.dtype = cfg, dtype
        self.tp = None   # as SplitHeadAttention's: W1 column-, W2 row-parallel
        self.w1 = nn.Linear(cfg.dim, cfg.dim * cfg.ff_mult)
        self.w2 = nn.Linear(cfg.dim * cfg.ff_mult, cfg.dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt, tp = self.dtype, self.tp
        if tp is None:
            h = F.gelu(_dense(self.w1, x, dt))
            h = F.dropout(h, self.cfg.ff_dropout, self.training)
            return _dense(self.w2, h, dt)
        b1 = scatter_to_tp(self.w1.bias, tp)
        h = F.gelu(F.linear(copy_to_tp(x.float(), tp).to(dt), self.w1.weight.to(dt), b1.to(dt)))
        h = F.dropout(h, self.cfg.ff_dropout, self.training)
        out = reduce_from_tp(F.linear(h, self.w2.weight.to(dt)).float(), tp)
        return (out + self.w2.bias.float()).to(dt)


class _PreNorm(nn.Module):
    def __init__(self, dim: int, fn: nn.Module):
        super().__init__()
        self.norm = nn.LayerNorm(dim, eps=LN_EPS)
        self.fn = fn


class _Chunk(nn.Module):
    """lucidrains ``Chunk`` (one chunk): only here for the ``fn.fn`` names."""

    def __init__(self, fn: nn.Module):
        super().__init__()
        self.fn = fn


class _SequentialSequence(nn.Module):
    def __init__(self, attn: _PreNorm, ff: _PreNorm):
        super().__init__()
        self.layers = nn.ModuleList([nn.ModuleList([attn, ff])])


class TransformerLayer(nn.Module):
    """Pre-norm attention + pre-norm FF, residuals outside the norms
    (linear_attention_transformer SequentialSequence semantics)."""

    def __init__(self, cfg: ProteoScribeConfig, attn_impl: str = "plain",
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.cfg, self.attn_impl, self.dtype = cfg, attn_impl, dtype
        self.heads = cfg.heads
        self.tp = None   # parallel/tensor.TensorParallel in layer-block and block mode
        self.layers = _SequentialSequence(
            _PreNorm(cfg.dim, SplitHeadAttention(cfg, attn_impl, dtype)),
            _PreNorm(cfg.dim, _Chunk(FeedForward(cfg, dtype))))

    @property
    def attn_norm(self) -> nn.LayerNorm:
        return self.layers.layers[0][0].norm

    @property
    def attn(self) -> SplitHeadAttention:
        return self.layers.layers[0][0].fn

    @property
    def ff_norm(self) -> nn.LayerNorm:
        return self.layers.layers[0][1].norm

    @property
    def ff(self) -> FeedForward:
        return self.layers.layers[0][1].fn.fn

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        if self.attn_impl == "layer-block":
            if self.training and (cfg.attn_layer_dropout > 0 or cfg.ff_dropout > 0):
                raise ValueError("layer-block kernel has no dropout path; use "
                                 "attn_impl='plain' or 'block' for nonzero-dropout training")
            a, n1, n2, ff = self.attn, self.attn_norm, self.ff_norm, self.ff
            return transformer_layer_block(
                x.to(self.dtype), a.to_q.weight.t(), a.to_k.weight.t(), a.to_v.weight.t(),
                a.to_out.weight.t(), a.to_out.bias, n1.weight, n1.bias, n2.weight, n2.bias,
                ff.w1.weight.t(), ff.w1.bias, ff.w2.weight.t(), ff.w2.bias,
                local_heads=cfg.local_heads, heads=cfg.heads, window=cfg.local_window,
                tp=self.tp)
        x = x + self.attn(self.attn_norm(x.float()))
        return x + self.ff(self.ff_norm(x))


class _AxialPositionalEmbedding(nn.Module):
    """Two summed tables, (L/W, dim) and (W, dim), in the reference's
    ``weights_0``/``weights_1`` shapes."""

    def __init__(self, cfg: ProteoScribeConfig):
        super().__init__()
        n_rows = cfg.max_seq_len // cfg.local_window
        self.weights_0 = nn.Parameter(torch.zeros(1, n_rows, 1, cfg.dim))
        self.weights_1 = nn.Parameter(torch.zeros(1, 1, cfg.local_window, cfg.dim))

    def table(self) -> torch.Tensor:
        """(max_seq_len, dim) pre-summed positional table."""
        return (self.weights_0 + self.weights_1).reshape(-1, self.weights_0.shape[-1])


class _DiffTransformer(nn.Module):
    def __init__(self, cfg: ProteoScribeConfig, conditional: bool, attn_impl: str,
                 dtype: torch.dtype):
        super().__init__()
        self.x_emb_NN = nn.Embedding(cfg.num_classes, cfg.dim)
        self.axial_pos_emb = _AxialPositionalEmbedding(cfg)
        self.mlp = ConditioningMLP(cfg.dim, cfg)
        if conditional:
            self.y_mlp = ConditioningMLP(cfg.cond_dim, cfg)
        self.transformer_blocks = nn.ModuleList([
            nn.ModuleList([TransformerLayer(cfg, attn_impl, dtype) for _ in range(cfg.depth)])
            for _ in range(cfg.n_blocks)
        ])
        self.norm = nn.LayerNorm(cfg.dim, eps=LN_EPS)
        self.out = nn.Linear(cfg.dim, cfg.num_classes)


class ProteoScribe(nn.Module):
    """forward(x (B, L) int, t (B,) int, z_c (B, cond_dim)) → (B, L, C) f32.

    ``conditional=False`` is the reference's unconditional variant (no
    ``y_mlp``; call with ``z_c=None``).  ``attn_impl``, ``dtype`` and
    ``remat`` select the training graph (module docstring)."""

    def __init__(self, cfg: ProteoScribeConfig, *, conditional: bool = True,
                 attn_impl: str = "plain", dtype: torch.dtype = torch.float32,
                 remat: bool = False):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
        self.config = cfg
        self.conditional = conditional
        self.attn_impl, self.dtype, self.remat = attn_impl, dtype, remat
        self.transformer = _DiffTransformer(cfg, conditional, attn_impl, dtype)

    def layer_biases(self, t: torch.Tensor, z_c: torch.Tensor | None) -> torch.Tensor:
        """(B, dim, n_blocks, depth) time (+ condition) biases."""
        cfg, core = self.config, self.transformer
        t_emb = sinusoidal_time_embedding(t, cfg.dim, float(cfg.num_timesteps),
                                          cfg.rescale_steps)
        bias = core.mlp(t_emb)
        if self.conditional:
            if z_c is None:
                raise ValueError("conditional model requires z_c")
            bias = bias + core.y_mlp(z_c)
        return bias.reshape(t.shape[0], cfg.dim, cfg.n_blocks, cfg.depth)

    def forward(self, x: torch.Tensor, t: torch.Tensor, z_c: torch.Tensor | None = None,
                positions: torch.Tensor | None = None) -> torch.Tensor:
        """With ``positions`` (B, k) int, the final LayerNorm and head run at
        those positions only → (B, k, C) (the sampler's gathered head)."""
        cfg, core = self.config, self.transformer
        L = x.shape[1]
        x_embed = core.x_emb_NN(x.long()) + core.axial_pos_emb.table()[None, :L]
        bias = self.layer_biases(t, z_c)
        remat = self.remat and self.training and torch.is_grad_enabled()
        h = torch.zeros_like(x_embed)
        for bi, block in enumerate(core.transformer_blocks):
            h = h + x_embed
            for li, layer in enumerate(block):
                h_in = h + bias[..., bi, li][:, None, :]
                h = (torch.utils.checkpoint.checkpoint(layer, h_in, use_reentrant=False)
                     if remat else layer(h_in))
        if positions is not None:
            h = torch.gather(h, 1, positions.long()[..., None].expand(-1, -1, h.shape[-1]))
        return core.out(core.norm(h.float()))

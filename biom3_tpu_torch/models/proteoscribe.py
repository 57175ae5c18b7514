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
stack that ``models/fused_forward.py`` runs on the kernels.
"""

from __future__ import annotations

import math

import torch
import torch.nn as nn
import torch.nn.functional as F

from biom3_tpu_torch.config import ProteoScribeConfig
from biom3_tpu_torch.ops.linear_attention import linear_attention
from biom3_tpu_torch.ops.local_attention import local_window_attention

LN_EPS = 1e-6


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

    def __init__(self, cfg: ProteoScribeConfig):
        super().__init__()
        self.cfg = cfg
        d = cfg.dim
        self.to_q = nn.Linear(d, d, bias=False)
        self.to_k = nn.Linear(d, d, bias=False)
        self.to_v = nn.Linear(d, d, bias=False)
        self.to_out = nn.Linear(d, d)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        B, L, _ = x.shape
        split = lambda z: z.reshape(B, L, cfg.heads, cfg.head_dim).transpose(1, 2)
        q, k, v = split(self.to_q(x)), split(self.to_k(x)), split(self.to_v(x))
        nl = cfg.local_heads
        outs = []
        if nl > 0:
            outs.append(local_window_attention(q[:, :nl], k[:, :nl], v[:, :nl],
                                               window=cfg.local_window))
        if cfg.global_heads > 0:
            outs.append(linear_attention(q[:, nl:], k[:, nl:], v[:, nl:]))
        out = torch.cat(outs, dim=1).transpose(1, 2).reshape(B, L, cfg.dim)
        return self.to_out(out)


class FeedForward(nn.Module):
    def __init__(self, cfg: ProteoScribeConfig):
        super().__init__()
        self.w1 = nn.Linear(cfg.dim, cfg.dim * cfg.ff_mult)
        self.w2 = nn.Linear(cfg.dim * cfg.ff_mult, cfg.dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.w2(F.gelu(self.w1(x)))


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

    def __init__(self, cfg: ProteoScribeConfig):
        super().__init__()
        self.layers = _SequentialSequence(_PreNorm(cfg.dim, SplitHeadAttention(cfg)),
                                          _PreNorm(cfg.dim, _Chunk(FeedForward(cfg))))

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
        x = x + self.attn(self.attn_norm(x))
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
    def __init__(self, cfg: ProteoScribeConfig, conditional: bool):
        super().__init__()
        self.x_emb_NN = nn.Embedding(cfg.num_classes, cfg.dim)
        self.axial_pos_emb = _AxialPositionalEmbedding(cfg)
        self.mlp = ConditioningMLP(cfg.dim, cfg)
        if conditional:
            self.y_mlp = ConditioningMLP(cfg.cond_dim, cfg)
        self.transformer_blocks = nn.ModuleList([
            nn.ModuleList([TransformerLayer(cfg) for _ in range(cfg.depth)])
            for _ in range(cfg.n_blocks)
        ])
        self.norm = nn.LayerNorm(cfg.dim, eps=LN_EPS)
        self.out = nn.Linear(cfg.dim, cfg.num_classes)


class ProteoScribe(nn.Module):
    """forward(x (B, L) int, t (B,) int, z_c (B, cond_dim)) → (B, L, C).

    ``conditional=False`` is the reference's unconditional variant (no
    ``y_mlp``; call with ``z_c=None``)."""

    def __init__(self, cfg: ProteoScribeConfig, *, conditional: bool = True):
        super().__init__()
        self.config = cfg
        self.conditional = conditional
        self.transformer = _DiffTransformer(cfg, conditional)

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

    def forward(self, x: torch.Tensor, t: torch.Tensor,
                z_c: torch.Tensor | None = None) -> torch.Tensor:
        cfg, core = self.config, self.transformer
        L = x.shape[1]
        x_embed = core.x_emb_NN(x.long()) + core.axial_pos_emb.table()[None, :L]
        bias = self.layer_biases(t, z_c)
        h = torch.zeros_like(x_embed)
        for bi, block in enumerate(core.transformer_blocks):
            h = h + x_embed
            for li, layer in enumerate(block):
                h = layer(h + bias[..., bi, li][:, None, :])
        return core.out(core.norm(h))

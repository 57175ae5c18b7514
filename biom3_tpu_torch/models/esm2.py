"""ESM2 protein tower (Stage-1 PenCL) as a plain PyTorch module.

Port of ``biom3_tpu/models/esm2.py:83-242`` for inference (no LM head):
the PAD mask from ``tokens == pad_idx``, fair-esm's token-dropout rescale
and PAD zeroing of the embedding, pre-LN layers (eps 1e-5) with GPT-NeoX
rotary attention over the full head dim, ``erf`` or ``tanh`` GELU, and the
final ``emb_layer_norm_after``.  Parameter names are fair-esm's
(``embed_tokens``, ``layers.{i}.self_attn.{q,k,v,out}_proj``, ...), so the
``protein_encoder.model.*`` subtree of a published PenCL ``.bin`` loads
with ``strict=True`` once ``esm2_state_dict`` has dropped, by name, what
inference does not hold.
"""

from __future__ import annotations

import re

import torch
import torch.nn as nn

from biom3_tpu_torch.config import ESM2Config
from biom3_tpu_torch.ops.attention import full_attention
from biom3_tpu_torch.ops.kernels import gelu
from biom3_tpu_torch.ops.rotary import apply_rotary, rotary_cos_sin

# keys of a fair-esm ESM2 state dict that the inference tower does not
# hold: the LM head (its weight tied to embed_tokens), the contact head,
# and the rotary inv_freq buffers (recomputed by ops/rotary.py)
_NOT_HELD = re.compile(r"lm_head\.|contact_head\.|layers\.\d+\.self_attn\.rot_emb\.inv_freq$")


def esm2_state_dict(sd: dict) -> dict:
    """Keep only the keys of ``ESM2`` from a fair-esm state dict."""
    return {k: v for k, v in sd.items() if not _NOT_HELD.match(k)}


class ESM2SelfAttention(nn.Module):
    def __init__(self, cfg: ESM2Config, attn_impl: str):
        super().__init__()
        E = cfg.embed_dim
        self.heads = cfg.attention_heads
        self.attn_impl = attn_impl
        self.q_proj, self.k_proj = nn.Linear(E, E), nn.Linear(E, E)
        self.v_proj, self.out_proj = nn.Linear(E, E), nn.Linear(E, E)

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        B, L, E = x.shape
        dh = E // self.heads
        split = lambda z: z.reshape(B, L, self.heads, dh).transpose(1, 2)
        q, k, v = split(self.q_proj(x)), split(self.k_proj(x)), split(self.v_proj(x))
        cos, sin = rotary_cos_sin(L, dh, dtype=q.dtype, device=q.device)
        q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
        out = full_attention(q, k, v, padding_mask, impl=self.attn_impl)
        return self.out_proj(out.transpose(1, 2).reshape(B, L, E))


class ESM2Layer(nn.Module):
    def __init__(self, cfg: ESM2Config, attn_impl: str, gelu_impl: str):
        super().__init__()
        E = cfg.embed_dim
        self.gelu = gelu_impl
        self.self_attn = ESM2SelfAttention(cfg, attn_impl)
        self.self_attn_layer_norm = nn.LayerNorm(E, eps=1e-5)
        self.fc1 = nn.Linear(E, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, E)
        self.final_layer_norm = nn.LayerNorm(E, eps=1e-5)

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        x = x + self.self_attn(self.self_attn_layer_norm(x), padding_mask)
        return x + self.fc2(gelu(self.fc1(self.final_layer_norm(x)), self.gelu))


class ESM2(nn.Module):
    """forward(tokens (B, L)) → {"hidden": (B, L, E)}, the post-final-norm
    representation (fair-esm repr layer = num_layers)."""

    def __init__(self, cfg: ESM2Config, *, attn_impl: str = "plain", gelu: str = "erf"):
        super().__init__()
        self.config = cfg
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        self.layers = nn.ModuleList([ESM2Layer(cfg, attn_impl, gelu)
                                     for _ in range(cfg.num_layers)])
        self.emb_layer_norm_after = nn.LayerNorm(cfg.embed_dim, eps=1e-5)

    def forward(self, tokens: torch.Tensor) -> dict:
        cfg = self.config
        tokens = tokens.long()
        padding_mask = tokens == cfg.pad_idx
        x = self.embed_tokens(tokens)
        if cfg.token_dropout:
            # fair-esm: zero <mask> embeddings, rescale by
            # (1 - 0.15 * 0.8) / (1 - observed <mask> ratio)
            is_mask = tokens == cfg.mask_idx
            x = x.masked_fill(is_mask[..., None], 0.0)
            ratio = is_mask.sum(-1) / (~padding_mask).sum(-1).clamp(min=1)
            x = x * ((1.0 - 0.15 * 0.8) / (1.0 - ratio))[:, None, None].to(x.dtype)
        x = x.masked_fill(padding_mask[..., None], 0.0)
        for layer in self.layers:
            x = layer(x, padding_mask)
        return {"hidden": self.emb_layer_norm_after(x)}

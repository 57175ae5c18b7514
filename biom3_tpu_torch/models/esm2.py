"""ESM2 protein tower (Stage-1 PenCL) as a plain PyTorch module.

Port of ``biom3_tpu/models/esm2.py:83-242``: the PAD mask from ``tokens ==
pad_idx``, fair-esm's token-dropout rescale and PAD zeroing of the
embedding, pre-LN layers (eps 1e-5) with GPT-NeoX rotary attention over the
full head dim, ``erf`` or ``tanh`` GELU, the final ``emb_layer_norm_after``
and, with ``lm_head=True``, fair-esm's LM head for the MLM loss (dense →
exact GELU → LayerNorm → f32 logits against the tied ``embed_tokens``
weight, plus ``lm_head.bias``).  Parameter names are fair-esm's
(``embed_tokens``, ``layers.{i}.self_attn.{q,k,v,out}_proj``, ``lm_head.*``,
...), so the ``protein_encoder.model.*`` subtree of a published PenCL
``.bin`` loads with ``strict=True`` once ``esm2_state_dict`` (inference) or
``esm2_train_state_dict`` (training, with the LM head) has dropped, by
name, what the module does not hold.

Training switches, as the JAX module's (``models/esm2.py:117-237``):

* ``attn_impl``: ``"plain"`` (torch ops; the JAX ``"xla"``), ``"kernel"``
  (the ``flash_attention`` kernel), ``"ring"`` (``ops/ring_attention.py``,
  the sequence over the ``tp`` axis of ``mesh``; JAX esm2.py:86-87,120-121)
  or ``"layer-block"`` (the whole layer on ``ops/esm2_block.py``'s
  kernels, forward and backward);
* ``dtype``: the compute dtype of the projections, attention and FF, with
  f32 parameters, LayerNorms, embedding and logits (Flax ``dtype=``
  semantics, ``models/layers.py``); ``None`` runs in the parameters' dtype;
* ``remat``: each layer rematerialised in the backward
  (``torch.utils.checkpoint``).

The embedding and its token-dropout rescale stay on torch ops in training:
they need a gradient and the ``esm2_embed`` kernel is forward only.
"""

from __future__ import annotations

import re

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from biom3_tpu_torch.config import ESM2Config
from biom3_tpu_torch.models.layers import dense, layer_norm
from biom3_tpu_torch.ops.attention import full_attention
from biom3_tpu_torch.ops.esm2_block import esm2_layer_block
from biom3_tpu_torch.ops.kernels import gelu
from biom3_tpu_torch.ops.rotary import apply_rotary, rotary_cos_sin

ATTN_IMPLS = ("plain", "kernel", "ring", "layer-block")
# keys of a fair-esm ESM2 state dict that no module holds: the contact head,
# the rotary inv_freq buffers (recomputed by ops/rotary.py) and the LM
# head's weight, tied to embed_tokens
_NEVER_HELD = r"contact_head\.|layers\.\d+\.self_attn\.rot_emb\.inv_freq$|lm_head\.weight$"
_NOT_HELD = re.compile(_NEVER_HELD + r"|lm_head\.")


def esm2_state_dict(sd: dict) -> dict:
    """Keep only the keys of ``ESM2`` (no LM head) from a fair-esm state dict."""
    return {k: v for k, v in sd.items() if not _NOT_HELD.match(k)}


def esm2_train_state_dict(sd: dict) -> dict:
    """Keep only the keys of ``ESM2(lm_head=True)`` from a fair-esm state dict."""
    return {k: v for k, v in sd.items() if not re.match(_NEVER_HELD, k)}


class ESM2SelfAttention(nn.Module):
    def __init__(self, cfg: ESM2Config, attn_impl: str, dtype: torch.dtype | None = None,
                 mesh=None):
        super().__init__()
        E = cfg.embed_dim
        self.heads = cfg.attention_heads
        self.attn_impl, self.dtype, self.mesh = attn_impl, dtype, mesh
        self.q_proj, self.k_proj = nn.Linear(E, E), nn.Linear(E, E)
        self.v_proj, self.out_proj = nn.Linear(E, E), nn.Linear(E, E)

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        B, L, E = x.shape
        dh = E // self.heads
        split = lambda z: z.reshape(B, L, self.heads, dh).transpose(1, 2)  # noqa: E731
        q, k, v = (split(dense(lin, x, self.dtype)) for lin in (self.q_proj, self.k_proj,
                                                                  self.v_proj))
        cos, sin = rotary_cos_sin(L, dh, dtype=q.dtype, device=q.device)
        q, k = apply_rotary(q, cos, sin), apply_rotary(k, cos, sin)
        out = full_attention(q, k, v, padding_mask, impl=self.attn_impl, mesh=self.mesh)
        return dense(self.out_proj, out.transpose(1, 2).reshape(B, L, E), self.dtype)


class ESM2Layer(nn.Module):
    def __init__(self, cfg: ESM2Config, attn_impl: str, gelu_impl: str,
                 dtype: torch.dtype | None = None, mesh=None):
        super().__init__()
        E = cfg.embed_dim
        self.heads, self.gelu, self.attn_impl, self.dtype = (cfg.attention_heads, gelu_impl,
                                                             attn_impl, dtype)
        self.tp = None   # parallel/tensor.TensorParallel in layer-block mode: rank's shards
        self.self_attn = ESM2SelfAttention(cfg, attn_impl, dtype, mesh)
        self.self_attn_layer_norm = nn.LayerNorm(E, eps=1e-5)
        self.fc1 = nn.Linear(E, cfg.ffn_dim)
        self.fc2 = nn.Linear(cfg.ffn_dim, E)
        self.final_layer_norm = nn.LayerNorm(E, eps=1e-5)

    def forward(self, x: torch.Tensor, padding_mask: torch.Tensor) -> torch.Tensor:
        dt = self.dtype
        if self.attn_impl == "layer-block":
            a, n1, n2 = self.self_attn, self.self_attn_layer_norm, self.final_layer_norm
            w3 = torch.stack([a.q_proj.weight.t(), a.k_proj.weight.t(), a.v_proj.weight.t()])
            b3 = torch.stack([a.q_proj.bias, a.k_proj.bias, a.v_proj.bias])
            return esm2_layer_block(
                x if dt is None else x.to(dt), padding_mask, w3, b3, a.out_proj.weight.t(),
                a.out_proj.bias, n1.weight, n1.bias, n2.weight, n2.bias, self.fc1.weight.t(),
                self.fc1.bias, self.fc2.weight.t(), self.fc2.bias, heads=self.heads,
                gelu=self.gelu, tp=self.tp)
        x = x + self.self_attn(layer_norm(self.self_attn_layer_norm, x, dt), padding_mask)
        h = gelu(dense(self.fc1, layer_norm(self.final_layer_norm, x, dt), dt), self.gelu)
        return x + dense(self.fc2, h, dt)


class ESM2LMHead(nn.Module):
    """fair-esm ``RobertaLMHead``: dense → exact GELU → LayerNorm → logits
    against the embedding table (tied, passed in) + ``bias``."""

    def __init__(self, cfg: ESM2Config):
        super().__init__()
        E = cfg.embed_dim
        self.dense = nn.Linear(E, E)
        self.layer_norm = nn.LayerNorm(E, eps=1e-5)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))

    def forward(self, x: torch.Tensor, embedding: torch.Tensor,
                dtype: torch.dtype | None) -> torch.Tensor:
        h = layer_norm(self.layer_norm, F.gelu(dense(self.dense, x, dtype)), dtype)
        return h.float() @ embedding.float().t() + self.bias.float()


class ESM2(nn.Module):
    """forward(tokens (B, L)) → {"hidden": (B, L, E)}, the post-final-norm
    representation (fair-esm repr layer = num_layers), and "logits" (B, L,
    V) f32 with ``compute_logits`` (needs ``lm_head=True``).  ``mesh``:
    the device mesh of ``attn_impl="ring"``."""

    def __init__(self, cfg: ESM2Config, *, attn_impl: str = "plain", gelu: str = "erf",
                 dtype: torch.dtype | None = None, remat: bool = False, lm_head: bool = False,
                 mesh=None):
        super().__init__()
        if attn_impl not in ATTN_IMPLS:
            raise ValueError(f"attn_impl must be one of {ATTN_IMPLS}, got {attn_impl!r}")
        if attn_impl == "ring" and mesh is None:
            raise ValueError("impl='ring' needs a mesh")
        self.config = cfg
        self.dtype, self.remat = dtype, remat
        self.embed_tokens = nn.Embedding(cfg.vocab_size, cfg.embed_dim)
        self.layers = nn.ModuleList([ESM2Layer(cfg, attn_impl, gelu, dtype, mesh)
                                     for _ in range(cfg.num_layers)])
        self.emb_layer_norm_after = nn.LayerNorm(cfg.embed_dim, eps=1e-5)
        if lm_head:
            self.lm_head = ESM2LMHead(cfg)

    def forward(self, tokens: torch.Tensor, *, compute_logits: bool = False) -> dict:
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
        if self.dtype is not None:
            x = x.to(self.dtype)
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            x = (torch.utils.checkpoint.checkpoint(layer, x, padding_mask, use_reentrant=False)
                 if remat else layer(x, padding_mask))
        out = {"hidden": layer_norm(self.emb_layer_norm_after, x, self.dtype)}
        if compute_logits:
            out["logits"] = self.lm_head(out["hidden"], self.embed_tokens.weight, self.dtype)
        return out

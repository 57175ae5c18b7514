"""BERT text tower (Stage-1 PenCL) as a plain PyTorch module.

Port of ``biom3_tpu/models/bert.py:28-160`` without the MLM head: learned
absolute positions, token-type-0 embeddings, post-LN layers (eps 1e-12),
exact GELU, and **no attention mask** — the reference calls the tower
without one, so PAD tokens attend (bert.py:136-137).  ``attn_impl`` routes
the heads through ``ops/attention.full_attention`` ("plain", or "kernel":
the flash_attention kernel), as bert.py:67 does.  Parameter names are
HF ``BertForMaskedLM``'s (``bert.embeddings.*``, ``bert.encoder.layer.{i}.*``),
the keys ``biom3_tpu/io/export.py::bert_params_to_torch`` emits.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from biom3_tpu_torch.config import BertConfig
from biom3_tpu_torch.ops.attention import full_attention


class _Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        L = ids.shape[1]
        x = (self.word_embeddings(ids) + self.position_embeddings.weight[None, :L]
             + self.token_type_embeddings.weight[0])
        return self.LayerNorm(x)


class _SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, attn_impl: str):
        super().__init__()
        E = cfg.hidden_size
        self.heads = cfg.num_heads
        self.attn_impl = attn_impl
        self.query, self.key, self.value = nn.Linear(E, E), nn.Linear(E, E), nn.Linear(E, E)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, E = x.shape
        split = lambda z: z.reshape(B, L, self.heads, E // self.heads).transpose(1, 2)
        q, k, v = split(self.query(x)), split(self.key(x)), split(self.value(x))
        out = full_attention(q, k, v, impl=self.attn_impl)
        return out.transpose(1, 2).reshape(B, L, E)


class _DenseNorm(nn.Module):
    """HF BertSelfOutput / BertOutput: Dense → residual → LayerNorm."""

    def __init__(self, d_in: int, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(d_in, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)

    def forward(self, h: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return self.LayerNorm(residual + self.dense(h))


class _Attention(nn.Module):
    def __init__(self, cfg: BertConfig, attn_impl: str):
        super().__init__()
        self.self = _SelfAttention(cfg, attn_impl)
        self.output = _DenseNorm(cfg.hidden_size, cfg)


class _Intermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, attn_impl: str):
        super().__init__()
        self.attention = _Attention(cfg, attn_impl)
        self.intermediate = _Intermediate(cfg)
        self.output = _DenseNorm(cfg.intermediate_size, cfg)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.attention.output(self.attention.self(x), x)
        return self.output(F.gelu(self.intermediate.dense(x)), x)


class _Encoder(nn.Module):
    def __init__(self, cfg: BertConfig, attn_impl: str):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(cfg, attn_impl) for _ in range(cfg.num_layers)])


class _Bert(nn.Module):
    def __init__(self, cfg: BertConfig, attn_impl: str):
        super().__init__()
        self.embeddings = _Embeddings(cfg)
        self.encoder = _Encoder(cfg, attn_impl)


class BertEncoder(nn.Module):
    """forward(input_ids (B, L)) → {"hidden": (B, L, E) last layer}."""

    def __init__(self, cfg: BertConfig, *, attn_impl: str = "plain"):
        super().__init__()
        self.config = cfg
        self.bert = _Bert(cfg, attn_impl)

    def forward(self, input_ids: torch.Tensor) -> dict:
        x = self.bert.embeddings(input_ids.long())
        for layer in self.bert.encoder.layer:
            x = layer(x)
        return {"hidden": x}

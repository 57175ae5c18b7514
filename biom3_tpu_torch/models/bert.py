"""BERT text tower (Stage-1 PenCL) as a plain PyTorch module.

Port of ``biom3_tpu/models/bert.py:28-160``: learned absolute positions,
token-type-0 embeddings, post-LN layers (eps 1e-12), exact GELU, and **no
attention mask** — the reference calls the tower without one, so PAD tokens
attend (bert.py:136-137).  ``attn_impl`` routes the heads through
``ops/attention.full_attention`` ("plain", or "kernel": the flash_attention
kernel), as bert.py:67 does.  Parameter names are HF ``BertForMaskedLM``'s
(``bert.embeddings.*``, ``bert.encoder.layer.{i}.*``, and with
``mlm_head=True`` ``cls.predictions.*``), the keys
``biom3_tpu/io/export.py::bert_params_to_torch`` emits.

For training, as the JAX module (bert.py:48-61, :85-95, :133-134,
:147-157):

* dropout at HF's four places, active in train mode only: after the
  embeddings' LayerNorm and after each of the two output projections
  (``hidden_dropout``), and on the softmax probabilities
  (``attn_probs_dropout``; the heads then run inline in torch, as the JAX
  module inlines them);
* the MLM head: ``cls.predictions.transform`` (dense → exact GELU →
  LayerNorm) → f32 logits against the tied word embeddings +
  ``cls.predictions.bias``;
* ``dtype`` (Flax ``dtype=`` semantics, ``models/layers.py``) and
  ``remat`` (``torch.utils.checkpoint`` per layer).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F
import torch.utils.checkpoint

from biom3_tpu_torch.config import BertConfig
from biom3_tpu_torch.models.layers import dense, layer_norm
from biom3_tpu_torch.ops.attention import full_attention


class _Embeddings(nn.Module):
    def __init__(self, cfg: BertConfig, dtype: torch.dtype | None):
        super().__init__()
        self.dtype = dtype
        self.word_embeddings = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, cfg.hidden_size)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        L = ids.shape[1]
        x = (self.word_embeddings(ids) + self.position_embeddings.weight[None, :L]
             + self.token_type_embeddings.weight[0])
        x = layer_norm(self.LayerNorm, x, self.dtype)
        return self.dropout(x if self.dtype is None else x.to(self.dtype))


class _SelfAttention(nn.Module):
    def __init__(self, cfg: BertConfig, attn_impl: str, dtype: torch.dtype | None):
        super().__init__()
        E = cfg.hidden_size
        self.heads = cfg.num_heads
        self.attn_impl, self.dtype = attn_impl, dtype
        self.query, self.key, self.value = nn.Linear(E, E), nn.Linear(E, E), nn.Linear(E, E)
        self.dropout = nn.Dropout(cfg.attn_probs_dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, L, E = x.shape
        split = lambda z: z.reshape(B, L, self.heads, E // self.heads).transpose(1, 2)  # noqa: E731
        q, k, v = (split(dense(lin, x, self.dtype)) for lin in (self.query, self.key, self.value))
        if self.training and self.dropout.p > 0:
            logits = (q.float() @ k.float().transpose(-1, -2)) * (E // self.heads) ** -0.5
            probs = self.dropout(torch.softmax(logits, dim=-1))
            out = probs.to(v.dtype) @ v
        else:
            out = full_attention(q, k, v, impl=self.attn_impl)
        return out.transpose(1, 2).reshape(B, L, E)


class _DenseNorm(nn.Module):
    """HF BertSelfOutput / BertOutput: Dense → Dropout → residual → LayerNorm."""

    def __init__(self, d_in: int, cfg: BertConfig, dtype: torch.dtype | None):
        super().__init__()
        self.dtype = dtype
        self.dense = nn.Linear(d_in, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)
        self.dropout = nn.Dropout(cfg.hidden_dropout)

    def forward(self, h: torch.Tensor, residual: torch.Tensor) -> torch.Tensor:
        return layer_norm(self.LayerNorm,
                          residual + self.dropout(dense(self.dense, h, self.dtype)), self.dtype)


class _Attention(nn.Module):
    def __init__(self, cfg: BertConfig, attn_impl: str, dtype: torch.dtype | None):
        super().__init__()
        self.self = _SelfAttention(cfg, attn_impl, dtype)
        self.output = _DenseNorm(cfg.hidden_size, cfg, dtype)


class _Intermediate(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.intermediate_size)


class BertLayer(nn.Module):
    def __init__(self, cfg: BertConfig, attn_impl: str, dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.attention = _Attention(cfg, attn_impl, dtype)
        self.intermediate = _Intermediate(cfg)
        self.output = _DenseNorm(cfg.intermediate_size, cfg, dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.attention.output(self.attention.self(x), x)
        return self.output(F.gelu(dense(self.intermediate.dense, x, self.dtype)), x)


class _Encoder(nn.Module):
    def __init__(self, cfg: BertConfig, attn_impl: str, dtype: torch.dtype | None):
        super().__init__()
        self.layer = nn.ModuleList([BertLayer(cfg, attn_impl, dtype)
                                    for _ in range(cfg.num_layers)])


class _Bert(nn.Module):
    def __init__(self, cfg: BertConfig, attn_impl: str, dtype: torch.dtype | None):
        super().__init__()
        self.embeddings = _Embeddings(cfg, dtype)
        self.encoder = _Encoder(cfg, attn_impl, dtype)


class _Transform(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.dense = nn.Linear(cfg.hidden_size, cfg.hidden_size)
        self.LayerNorm = nn.LayerNorm(cfg.hidden_size, eps=cfg.layer_norm_eps)


class _Predictions(nn.Module):
    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.transform = _Transform(cfg)
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))


class _MLMHead(nn.Module):
    """HF ``BertOnlyMLMHead``; the decoder is the word-embedding table."""

    def __init__(self, cfg: BertConfig):
        super().__init__()
        self.predictions = _Predictions(cfg)

    def forward(self, x: torch.Tensor, embedding: torch.Tensor,
                dtype: torch.dtype | None) -> torch.Tensor:
        p = self.predictions
        h = layer_norm(p.transform.LayerNorm, F.gelu(dense(p.transform.dense, x, dtype)), dtype)
        return h.float() @ embedding.float().t() + p.bias.float()


class BertEncoder(nn.Module):
    """forward(input_ids (B, L)) → {"hidden": (B, L, E) last layer}, and
    "logits" (B, L, V) f32 with ``compute_logits`` (needs ``mlm_head=True``)."""

    def __init__(self, cfg: BertConfig, *, attn_impl: str = "plain",
                 dtype: torch.dtype | None = None, remat: bool = False, mlm_head: bool = False):
        super().__init__()
        self.config = cfg
        self.dtype, self.remat = dtype, remat
        self.bert = _Bert(cfg, attn_impl, dtype)
        if mlm_head:
            self.cls = _MLMHead(cfg)

    def forward(self, input_ids: torch.Tensor, *, compute_logits: bool = False) -> dict:
        x = self.bert.embeddings(input_ids.long())
        remat = self.remat and torch.is_grad_enabled()
        for layer in self.bert.encoder.layer:
            x = (torch.utils.checkpoint.checkpoint(layer, x, use_reentrant=False)
                 if remat else layer(x))
        out = {"hidden": x}
        if compute_logits:
            out["logits"] = self.cls(x, self.bert.embeddings.word_embeddings.weight, self.dtype)
        return out

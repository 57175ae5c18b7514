"""Whole BERT text tower on the port's kernels, emitting the CLS rows.

Counterpart of ``biom3_tpu/ops/pallas/bert_stack_tpu.py``: ``fused_bert_cls``
(:198-340) with the same stacked inputs, ``bert_stack_arrays`` (:341-401)
and ``bert_embed`` (:402).  The embedding gather and its LayerNorm stay
plain torch: they sit outside the TPU kernel too.

Each post-LN layer (eps 1e-12, no attention mask — PAD tokens attend) is:
q/k/v ``gemm_bias_act`` (one E x 3E product with bias) → ``dense_attention``
→ out-projection ``gemm_bias_act`` with +bo and the residual (f32) →
``layernorm`` → W1 ``gemm_bias_act`` with +b1 and GELU → W2
``gemm_bias_act`` with +b2 and the residual → ``layernorm``.  The
residual rounds to bf16 between layers and stays f32 inside one, as in the
TPU kernel (bert_stack_tpu.py:70-180).
"""

from __future__ import annotations

import torch

from biom3_tpu_torch.ops.kernels import dense_attention, gemm_bias_act, layernorm


def fused_bert_cls(x0, ln1_scale, ln1_bias, wq, wk, wv, bq, bk, bv, wo, bo, ln2_scale,
                   ln2_bias, w1, b1, w2, b2, *, heads: int, gelu: str = "erf",
                   eps: float = 1e-12) -> torch.Tensor:
    """x0 (B, L, E) post-embedding-LN activations; weights (depth, d_in,
    d_out), biases and LayerNorm parameters f32 → (B, E) f32 CLS of the
    last hidden state."""
    B, L, E = x0.shape
    cdtype = x0.dtype
    wqkv = torch.cat([wq, wk, wv], dim=2).contiguous()
    bqkv = torch.cat([bq, bk, bv], dim=1).contiguous()
    h = x0.reshape(B * L, E)
    for l in range(wqkv.shape[0]):
        qkv = gemm_bias_act(h, wqkv[l], bqkv[l]).view(B, L, 3 * E)
        att = dense_attention(qkv, heads=heads).view(B * L, E)
        y1 = gemm_bias_act(att, wo[l], bo[l], residual=h, out_dtype=torch.float32)
        x1, x1f = layernorm(y1, ln1_scale[l], ln1_bias[l], eps=eps, out_dtype=cdtype,
                            want_f32=True)
        mid = gemm_bias_act(x1, w1[l], b1[l], act=gelu)
        y2 = gemm_bias_act(mid, w2[l], b2[l], residual=x1f, out_dtype=torch.float32)
        h = layernorm(y2, ln2_scale[l], ln2_bias[l], eps=eps, out_dtype=cdtype)
    return h.view(B, L, E)[:, 0].float()


def bert_stack_arrays(bert, dtype: torch.dtype) -> dict:
    """``models.bert.BertEncoder`` → the stacked inputs of ``fused_bert_cls``:
    matrices transposed to (d_in, d_out) in ``dtype``, vectors f32."""
    layers = bert.bert.encoder.layer

    def stack(get, mat: bool):
        ts = [get(layer).detach() for layer in layers]
        if mat:
            return torch.stack([t.t() for t in ts]).to(dtype).contiguous()
        return torch.stack(ts).float().contiguous()

    return dict(
        ln1_scale=stack(lambda m: m.attention.output.LayerNorm.weight, False),
        ln1_bias=stack(lambda m: m.attention.output.LayerNorm.bias, False),
        wq=stack(lambda m: m.attention.self.query.weight, True),
        wk=stack(lambda m: m.attention.self.key.weight, True),
        wv=stack(lambda m: m.attention.self.value.weight, True),
        bq=stack(lambda m: m.attention.self.query.bias, False),
        bk=stack(lambda m: m.attention.self.key.bias, False),
        bv=stack(lambda m: m.attention.self.value.bias, False),
        wo=stack(lambda m: m.attention.output.dense.weight, True),
        bo=stack(lambda m: m.attention.output.dense.bias, False),
        ln2_scale=stack(lambda m: m.output.LayerNorm.weight, False),
        ln2_bias=stack(lambda m: m.output.LayerNorm.bias, False),
        w1=stack(lambda m: m.intermediate.dense.weight, True),
        b1=stack(lambda m: m.intermediate.dense.bias, False),
        w2=stack(lambda m: m.output.dense.weight, True),
        b2=stack(lambda m: m.output.dense.bias, False),
    )


@torch.no_grad()
def bert_embed(bert, input_ids: torch.Tensor, *, eps: float = 1e-12,
               dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """word + position + token-type-0 embeddings → LayerNorm, in ``dtype``
    (ref models/bert.py:121-132)."""
    emb = bert.bert.embeddings
    ids = input_ids.long()
    L = ids.shape[1]
    x = (emb.word_embeddings.weight[ids] + emb.position_embeddings.weight[None, :L]
         + emb.token_type_embeddings.weight[0])
    return torch.nn.functional.layer_norm(
        x.float(), (x.shape[-1],), emb.LayerNorm.weight.float(), emb.LayerNorm.bias.float(),
        eps,
    ).to(dtype)

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

The TPU kernel's int8 options are the weights' type here: int8 wq/wk/wv/wo
(projections) or w1/w2 (FF), each (depth, d_out, d_in) — ``gemm_i8``'s
layout — with (depth, d_out) f32 scales ``sq, sk, sv, so`` or ``s1, s2``
(``bert_stack_arrays(…, proj_quant=, ff_quant=)``).  Each product is then
``quant_rows`` → ``gemm_i8`` at the TPU kernel's rounding points
(bert_stack_tpu.py:71-91, :146-158): the post-LN tower's projections
quantize the raw residual in the compute dtype, the FF the f32 LayerNorm
output and the f32 GELU output; biases add after the dequant.
"""

from __future__ import annotations

import torch

from biom3_tpu_torch.ops.kernels import dense_attention, gemm_bias_act, layernorm, linear_i8
from biom3_tpu_torch.ops.quant import quantize_weight_int8


def fused_bert_cls(x0, ln1_scale, ln1_bias, wq, wk, wv, bq, bk, bv, wo, bo, ln2_scale,
                   ln2_bias, w1, b1, w2, b2, s1=None, s2=None, sq=None, sk=None, sv=None,
                   so=None, *, heads: int, gelu: str = "erf", eps: float = 1e-12) -> torch.Tensor:
    """x0 (B, L, E) post-embedding-LN activations; weights (depth, d_in,
    d_out) in the compute dtype or int8 (depth, d_out, d_in) with scales,
    biases and LayerNorm parameters f32 → (B, E) f32 CLS of the last hidden
    state."""
    B, L, E = x0.shape
    cdtype = x0.dtype
    proj8, ff8 = sq is not None, s1 is not None
    wqkv = torch.cat([wq, wk, wv], dim=1 if proj8 else 2).contiguous()
    bqkv = torch.cat([bq, bk, bv], dim=1).contiguous()
    sqkv = torch.cat([sq, sk, sv], dim=1).contiguous() if proj8 else None
    h = x0.reshape(B * L, E)
    for l in range(wqkv.shape[0]):
        if proj8:
            qkv = linear_i8(h, wqkv[l], sqkv[l], bqkv[l], out_dtype=cdtype)
        else:
            qkv = gemm_bias_act(h, wqkv[l], bqkv[l])
        att = dense_attention(qkv.view(B, L, 3 * E), heads=heads).view(B * L, E)
        if proj8:
            y1 = linear_i8(att, wo[l], so[l], bo[l], residual=h, out_dtype=torch.float32)
        else:
            y1 = gemm_bias_act(att, wo[l], bo[l], residual=h, out_dtype=torch.float32)
        if ff8:
            x1f = layernorm(y1, ln1_scale[l], ln1_bias[l], eps=eps, out_dtype=torch.float32)
            mid = linear_i8(x1f, w1[l], s1[l], b1[l], act=gelu, out_dtype=torch.float32)
            y2 = linear_i8(mid, w2[l], s2[l], b2[l], residual=x1f, out_dtype=torch.float32)
        else:
            x1, x1f = layernorm(y1, ln1_scale[l], ln1_bias[l], eps=eps, out_dtype=cdtype,
                                want_f32=True)
            mid = gemm_bias_act(x1, w1[l], b1[l], act=gelu)
            y2 = gemm_bias_act(mid, w2[l], b2[l], residual=x1f, out_dtype=torch.float32)
        h = layernorm(y2, ln2_scale[l], ln2_bias[l], eps=eps, out_dtype=cdtype)
    return h.view(B, L, E)[:, 0].float()


def bert_stack_arrays(bert, dtype: torch.dtype, *, ff_quant: str = "none",
                      proj_quant: str = "none") -> dict:
    """``models.bert.BertEncoder`` → the stacked inputs of ``fused_bert_cls``:
    matrices transposed to (d_in, d_out) in ``dtype``, vectors f32.
    ``ff_quant``/``proj_quant="int8"``: w1/w2 or wq/wk/wv/wo as int8
    (depth, d_out, d_in) codes of the f32 weights with their scales s1/s2 or
    sq/sk/sv/so (bert_stack_tpu.py:341-400)."""
    layers = bert.bert.encoder.layer

    def stack(get, mat: bool):
        ts = [get(layer).detach() for layer in layers]
        if mat:
            return torch.stack([t.t() for t in ts]).to(dtype).contiguous()
        return torch.stack(ts).float().contiguous()

    def matrix(name: str, get, quant: str) -> dict:
        if quant == "none":
            return {f"w{name}": stack(get, True)}
        q, s = quantize_weight_int8(torch.stack([get(m).detach().t() for m in layers]))
        return {f"w{name}": q.transpose(1, 2).contiguous(), f"s{name}": s.contiguous()}

    return dict(
        ln1_scale=stack(lambda m: m.attention.output.LayerNorm.weight, False),
        ln1_bias=stack(lambda m: m.attention.output.LayerNorm.bias, False),
        **matrix("q", lambda m: m.attention.self.query.weight, proj_quant),
        **matrix("k", lambda m: m.attention.self.key.weight, proj_quant),
        **matrix("v", lambda m: m.attention.self.value.weight, proj_quant),
        bq=stack(lambda m: m.attention.self.query.bias, False),
        bk=stack(lambda m: m.attention.self.key.bias, False),
        bv=stack(lambda m: m.attention.self.value.bias, False),
        **matrix("o", lambda m: m.attention.output.dense.weight, proj_quant),
        bo=stack(lambda m: m.attention.output.dense.bias, False),
        ln2_scale=stack(lambda m: m.output.LayerNorm.weight, False),
        ln2_bias=stack(lambda m: m.output.LayerNorm.bias, False),
        **matrix("1", lambda m: m.intermediate.dense.weight, ff_quant),
        b1=stack(lambda m: m.intermediate.dense.bias, False),
        **matrix("2", lambda m: m.output.dense.weight, ff_quant),
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

"""Whole ESM2 protein tower on the port's kernels, emitting the CLS rows.

Counterpart of ``biom3_tpu/ops/pallas/esm2_stack_tpu.py``: ``fused_esm2_cls``
(:294-474) and ``esm2_stack_arrays`` (:477-538), with its int8 options
(not the TPU tuning knobs).

``esm2_embed`` makes the layer-0 input (token-dropout rescale, <mask> and
PAD rows zeroed).  Each pre-LN layer (eps 1e-5) is: ``layernorm`` → the
q/k/v ``gemm_bias_act`` (one E x 3E product with bias) →
``esm2_attention`` (rotary on q and k, PAD keys masked) → the
out-projection ``gemm_bias_act`` with +bo and the residual (f32) →
``layernorm`` → W1 ``gemm_bias_act`` with +b1 and GELU → W2
``gemm_bias_act`` with +b2 and the f32 residual.  The residual rounds to
bf16 between layers and stays f32 inside one; LN outputs, q/k/v, the
rotated q/k, head outputs and the GELU output are bf16 — the TPU kernel's
rounding points (esm2_stack_tpu.py:118-276).  The last hidden state's CLS
rows alone go through ``emb_layer_norm_after`` (:278-282).

int8 (``esm2_stack_arrays(…, proj_quant=, ff_quant=)``): wqkv/wo or w1/w2
are (depth, d_out, d_in) int8 codes — ``gemm_i8``'s layout — with (depth,
d_out) f32 scales ``sqkv, so`` or ``s1, s2``, and each product is
``quant_rows`` → ``gemm_i8`` at the TPU kernel's rounding points
(esm2_stack_tpu.py:126-147, :239-257): the projections quantize the LN1
output after its rounding to the compute dtype (the qkv bias adds after
the dequant, rotary runs after that) and the bf16 head outputs; the FF the
f32 LN2 output and the f32 GELU output.
"""

from __future__ import annotations

import torch

from biom3_tpu_torch.ops.kernels import (
    esm2_attention,
    esm2_embed,
    gemm_bias_act,
    layernorm,
    linear_i8,
)
from biom3_tpu_torch.ops.quant import quantize_weight_int8
from biom3_tpu_torch.ops.rotary import rotary_cos_sin

EPS = 1e-5  # every LayerNorm of the tower


def fused_esm2_cls(ids, tok_table, ln1_scale, ln1_bias, wqkv, bqkv, wo, bo, ln2_scale,
                   ln2_bias, w1, b1, w2, b2, fn_scale, fn_bias, sqkv=None, so=None, s1=None,
                   s2=None, *, heads: int, gelu: str = "erf", pad_idx: int = 1,
                   mask_idx: int = 32, token_dropout: bool = True) -> torch.Tensor:
    """ids (B, L) int32 fair-esm tokens; table and weights (depth, d_in,
    d_out) in the compute dtype or int8 (depth, d_out, d_in) with scales,
    biases and LayerNorm parameters f32 → (B, E) f32 post-final-norm CLS."""
    B, L = ids.shape
    E = tok_table.shape[1]
    cdtype = tok_table.dtype
    h = esm2_embed(ids, tok_table, pad_idx=pad_idx, mask_idx=mask_idx,
                   token_dropout=token_dropout).view(B * L, E)
    pad = (ids == pad_idx).int()
    cos, sin = rotary_cos_sin(L, E // heads, dtype=cdtype, device=ids.device)
    for l in range(wqkv.shape[0]):
        xn = layernorm(h, ln1_scale[l], ln1_bias[l], eps=EPS, out_dtype=cdtype)
        if sqkv is None:
            qkv = gemm_bias_act(xn, wqkv[l], bqkv[l])
        else:
            qkv = linear_i8(xn, wqkv[l], sqkv[l], bqkv[l], out_dtype=cdtype)
        att = esm2_attention(qkv.view(B, L, 3 * E), pad, cos, sin, heads=heads).view(B * L, E)
        if so is None:
            y1 = gemm_bias_act(att, wo[l], bo[l], residual=h, out_dtype=torch.float32)
        else:
            y1 = linear_i8(att, wo[l], so[l], bo[l], residual=h, out_dtype=torch.float32)
        if s1 is None:
            xn = layernorm(y1, ln2_scale[l], ln2_bias[l], eps=EPS, out_dtype=cdtype)
            mid = gemm_bias_act(xn, w1[l], b1[l], act=gelu)
            h = gemm_bias_act(mid, w2[l], b2[l], residual=y1)
        else:
            xn = layernorm(y1, ln2_scale[l], ln2_bias[l], eps=EPS, out_dtype=torch.float32)
            mid = linear_i8(xn, w1[l], s1[l], b1[l], act=gelu, out_dtype=torch.float32)
            h = linear_i8(mid, w2[l], s2[l], b2[l], residual=y1, out_dtype=cdtype)
    cls = h.view(B, L, E)[:, 0].contiguous()
    return layernorm(cls, fn_scale, fn_bias, eps=EPS, out_dtype=cdtype, want_f32=True)[1]


def esm2_stack_arrays(esm, dtype: torch.dtype, device: torch.device | str | None = None, *,
                      ff_quant: str = "none", proj_quant: str = "none") -> dict:
    """``models.esm2.ESM2`` → the inputs of ``fused_esm2_cls`` on ``device``
    (default: the module's): matrices transposed to (depth, d_in, d_out) in
    ``dtype`` with q/k/v concatenated into one (E, 3E) weight and bias,
    vectors f32.  ``proj_quant``/``ff_quant="int8"``: wqkv/wo or w1/w2 as
    int8 (depth, d_out, d_in) codes of the f32 weights with their scales
    (esm2_stack_tpu.py:477-538).  Converted layer by layer, so no stacked f32
    copy of the tower is made."""
    device = esm.embed_tokens.weight.device if device is None else device
    layers = esm.layers

    def stack(get, mat: bool):
        if mat:
            return torch.stack([get(m).detach().t().to(device=device, dtype=dtype)
                                for m in layers]).contiguous()
        return torch.stack([get(m).detach().to(device=device, dtype=torch.float32)
                            for m in layers]).contiguous()

    def matrix(name: str, scale: str, get, quant: str) -> dict:
        if quant == "none":
            return {name: stack(get, True)}
        pairs = [quantize_weight_int8(get(m).detach().to(device).t()) for m in layers]
        return {name: torch.stack([q.t() for q, _ in pairs]).contiguous(),
                scale: torch.stack([s for _, s in pairs]).contiguous()}

    def qkv(m, part: str):
        a = m.self_attn
        return torch.cat([getattr(a.q_proj, part), getattr(a.k_proj, part),
                          getattr(a.v_proj, part)], dim=0)

    return dict(
        tok_table=esm.embed_tokens.weight.detach().to(device=device, dtype=dtype).contiguous(),
        ln1_scale=stack(lambda m: m.self_attn_layer_norm.weight, False),
        ln1_bias=stack(lambda m: m.self_attn_layer_norm.bias, False),
        **matrix("wqkv", "sqkv", lambda m: qkv(m, "weight"), proj_quant),
        bqkv=stack(lambda m: qkv(m, "bias"), False),
        **matrix("wo", "so", lambda m: m.self_attn.out_proj.weight, proj_quant),
        bo=stack(lambda m: m.self_attn.out_proj.bias, False),
        ln2_scale=stack(lambda m: m.final_layer_norm.weight, False),
        ln2_bias=stack(lambda m: m.final_layer_norm.bias, False),
        **matrix("w1", "s1", lambda m: m.fc1.weight, ff_quant),
        b1=stack(lambda m: m.fc1.bias, False),
        **matrix("w2", "s2", lambda m: m.fc2.weight, ff_quant),
        b2=stack(lambda m: m.fc2.bias, False),
        fn_scale=esm.emb_layer_norm_after.weight.detach().to(device=device,
                                                             dtype=torch.float32),
        fn_bias=esm.emb_layer_norm_after.bias.detach().to(device=device, dtype=torch.float32),
    )

"""PenCL (BioM3 Stage 1) and the Facilitator (Stage 2) written out in plain
float32 PyTorch.

* ESM2 (fair-esm, ``esm2_t33_650M_UR50D``): token embedding, token-dropout
  rescale by (1 - 0.15·0.8) / (1 - observed <mask> share), PAD rows zeroed;
  pre-LN layers (eps 1e-5): q scaled by dh^-0.5, rotary (GPT-NeoX half split
  over the whole head, inv_freq 10000^(-2i/dh)) on q and k, PAD keys masked,
  softmax, out-projection; erf-GELU FF of width 4E; the final LayerNorm; the
  <cls> row.
* BERT (HF ``BertModel``, PubMedBERT-base): word + position + token-type-0
  embeddings, LayerNorm (eps 1e-12); post-LN layers with no attention mask (the
  reference calls the tower without one, so PAD tokens attend); the [CLS] row.
* The projection heads (``Stage1_source/model.py``): Linear → GELU → Linear,
  plus the first Linear's output, LayerNorm (eps 1e-5).
* The Facilitator: weight-normalised Linear (one gain over the whole matrix)
  → GELU → weight-normalised Linear.

The parameters are the published state-dict keys (``layout``).  Imports nothing
of the program.
"""

from __future__ import annotations

import torch

from reference.common import FP32, Precision, gelu, layer_norm

ESM = "protein_encoder.model."
BERT = "text_encoder.model.bert."
ESM_PAD, ESM_MASK = 1, 32


def dims(cfg: dict) -> dict:
    """The sizes of a Stage-1 config section (published JSON keys)."""
    e, t = int(cfg["protein_encoder_embedding"]), int(cfg["text_encoder_embedding"])
    return {"E": e, "esm_layers": int(cfg["esm_num_layers"]),
            "esm_heads": int(cfg["esm_attention_heads"]), "esm_vocab": 33,
            "T": t, "bert_layers": int(cfg["bert_num_layers"]),
            "bert_heads": int(cfg["bert_num_heads"]),
            "bert_ff": int(cfg["bert_intermediate_size"]),
            "bert_vocab": int(cfg["bert_vocab_size"]),
            "bert_pos": int(cfg["bert_max_position_embeddings"]),
            "proj": int(cfg["proj_embedding_dim"])}


def _head_layout(name: str, d_in: int, proj: int) -> dict:
    return {f"{name}.projection.weight": (proj, d_in), f"{name}.projection.bias": (proj,),
            f"{name}.fc.weight": (proj, proj), f"{name}.fc.bias": (proj,),
            f"{name}.layer_norm.weight": (proj,), f"{name}.layer_norm.bias": (proj,)}


def text_layout(cfg: dict) -> dict[str, tuple]:
    """The BERT tower and text projection head: key → shape."""
    s = dims(cfg)
    T, ff = s["T"], s["bert_ff"]
    out = {BERT + "embeddings.word_embeddings.weight": (s["bert_vocab"], T),
           BERT + "embeddings.position_embeddings.weight": (s["bert_pos"], T),
           BERT + "embeddings.token_type_embeddings.weight": (2, T),
           BERT + "embeddings.LayerNorm.weight": (T,), BERT + "embeddings.LayerNorm.bias": (T,)}
    for i in range(s["bert_layers"]):
        p = f"{BERT}encoder.layer.{i}."
        for n in ("query", "key", "value"):
            out[p + f"attention.self.{n}.weight"] = (T, T)
            out[p + f"attention.self.{n}.bias"] = (T,)
        out.update({p + "attention.output.dense.weight": (T, T),
                    p + "attention.output.dense.bias": (T,),
                    p + "attention.output.LayerNorm.weight": (T,),
                    p + "attention.output.LayerNorm.bias": (T,),
                    p + "intermediate.dense.weight": (ff, T), p + "intermediate.dense.bias": (ff,),
                    p + "output.dense.weight": (T, ff), p + "output.dense.bias": (T,),
                    p + "output.LayerNorm.weight": (T,), p + "output.LayerNorm.bias": (T,)})
    out.update(_head_layout("text_projection", T, s["proj"]))
    return out


def layout(cfg: dict) -> dict[str, tuple]:
    """Both towers and both projection heads: key → shape."""
    s = dims(cfg)
    E = s["E"]
    out = text_layout(cfg)
    out[ESM + "embed_tokens.weight"] = (s["esm_vocab"], E)
    for i in range(s["esm_layers"]):
        p = f"{ESM}layers.{i}."
        for n in ("q", "k", "v", "out"):
            out[p + f"self_attn.{n}_proj.weight"] = (E, E)
            out[p + f"self_attn.{n}_proj.bias"] = (E,)
        out.update({p + "self_attn_layer_norm.weight": (E,), p + "self_attn_layer_norm.bias": (E,),
                    p + "fc1.weight": (4 * E, E), p + "fc1.bias": (4 * E,),
                    p + "fc2.weight": (E, 4 * E), p + "fc2.bias": (E,),
                    p + "final_layer_norm.weight": (E,), p + "final_layer_norm.bias": (E,)})
    out.update({ESM + "emb_layer_norm_after.weight": (E,),
                ESM + "emb_layer_norm_after.bias": (E,)})
    out.update(_head_layout("protein_projection", E, s["proj"]))
    return out


def facilitator_layout(cfg: dict) -> dict[str, tuple]:
    """The Facilitator (a Stage-2 config section): key → shape."""
    e, h = int(cfg["emb_dim"]), int(cfg["hid_dim"])
    return {"main.0.weight_g": (), "main.0.weight_v": (h, e), "main.0.bias": (h,),
            "main.3.weight_g": (), "main.3.weight_v": (e, h), "main.3.bias": (e,)}


def _projection_head(p, name, z, prec):
    projected = prec.linear(z, p[f"{name}.projection.weight"], p[f"{name}.projection.bias"],
                            "head")
    h = prec.linear(gelu(projected), p[f"{name}.fc.weight"], p[f"{name}.fc.bias"], "head")
    return layer_norm(h + projected, p[f"{name}.layer_norm.weight"],
                      p[f"{name}.layer_norm.bias"], 1e-5)


def _rotate(x, cos, sin):
    x1, x2 = x.chunk(2, dim=-1)
    return x * cos + torch.cat([-x2, x1], dim=-1) * sin


@torch.no_grad()
def esm2_cls(p: dict, cfg: dict, tokens, prec: Precision = FP32):
    """tokens (1, n) ESM ids of one protein, no padding → its <cls> row (E,)
    after the final LayerNorm."""
    s = dims(cfg)
    E, H = s["E"], s["esm_heads"]
    dh = E // H
    tokens = tokens.long()
    B, n = tokens.shape
    pad = tokens == ESM_PAD
    x = p[ESM + "embed_tokens.weight"].float()[tokens]
    is_mask = tokens == ESM_MASK
    x = x.masked_fill(is_mask[..., None], 0.0)
    ratio = is_mask.sum(-1) / (~pad).sum(-1).clamp(min=1)
    x = x * ((1.0 - 0.15 * 0.8) / (1.0 - ratio))[:, None, None]
    x = x.masked_fill(pad[..., None], 0.0)
    inv_freq = 1.0 / (10000 ** (torch.arange(0, dh, 2, dtype=torch.float32,
                                             device=x.device) / dh))
    ang = torch.outer(torch.arange(n, dtype=torch.float32, device=x.device), inv_freq)
    ang = torch.cat([ang, ang], dim=-1)
    cos, sin = ang.cos(), ang.sin()
    key_mask = pad[:, None, None, :]
    for i in range(s["esm_layers"]):
        pre = f"{ESM}layers.{i}."
        a = layer_norm(x, p[pre + "self_attn_layer_norm.weight"],
                       p[pre + "self_attn_layer_norm.bias"], 1e-5)
        split = lambda z: z.reshape(B, n, H, dh).transpose(1, 2)  # noqa: E731
        q, k, v = (split(prec.linear(a, p[pre + f"self_attn.{c}_proj.weight"],
                                     p[pre + f"self_attn.{c}_proj.bias"], "proj"))
                   for c in "qkv")
        q, k = _rotate(q * dh ** -0.5, cos, sin), _rotate(k, cos, sin)
        sc = prec.matmul(q, k.transpose(-1, -2)).masked_fill(key_mask, float("-inf"))
        ctx = prec.matmul(torch.softmax(sc, dim=-1), v).transpose(1, 2).reshape(B, n, E)
        x = x + prec.linear(ctx, p[pre + "self_attn.out_proj.weight"],
                            p[pre + "self_attn.out_proj.bias"], "proj")
        f = layer_norm(x, p[pre + "final_layer_norm.weight"], p[pre + "final_layer_norm.bias"],
                       1e-5)
        f = gelu(prec.linear(f, p[pre + "fc1.weight"], p[pre + "fc1.bias"], "ff"))
        x = x + prec.linear(f, p[pre + "fc2.weight"], p[pre + "fc2.bias"], "ff")
    x = layer_norm(x, p[ESM + "emb_layer_norm_after.weight"], p[ESM + "emb_layer_norm_after.bias"],
                   1e-5)
    return x[:, 0]


@torch.no_grad()
def bert_cls(p: dict, cfg: dict, ids, prec: Precision = FP32):
    """ids (B, Lt) wordpiece ids, PAD included → the [CLS] rows (B, T)."""
    s = dims(cfg)
    T, H = s["T"], s["bert_heads"]
    dh = T // H
    ids = ids.long()
    B, L = ids.shape
    x = (p[BERT + "embeddings.word_embeddings.weight"].float()[ids]
         + p[BERT + "embeddings.position_embeddings.weight"].float()[None, :L]
         + p[BERT + "embeddings.token_type_embeddings.weight"].float()[0])
    x = layer_norm(x, p[BERT + "embeddings.LayerNorm.weight"], p[BERT + "embeddings.LayerNorm.bias"],
                   1e-12)
    for i in range(s["bert_layers"]):
        pre = f"{BERT}encoder.layer.{i}."
        split = lambda z: z.reshape(B, L, H, dh).transpose(1, 2)  # noqa: E731
        q, k, v = (split(prec.linear(x, p[pre + f"attention.self.{c}.weight"],
                                     p[pre + f"attention.self.{c}.bias"], "proj"))
                   for c in ("query", "key", "value"))
        sc = prec.matmul(q, k.transpose(-1, -2)) * dh ** -0.5
        ctx = prec.matmul(torch.softmax(sc, dim=-1), v).transpose(1, 2).reshape(B, L, T)
        a = prec.linear(ctx, p[pre + "attention.output.dense.weight"],
                        p[pre + "attention.output.dense.bias"], "proj")
        x = layer_norm(x + a, p[pre + "attention.output.LayerNorm.weight"],
                       p[pre + "attention.output.LayerNorm.bias"], 1e-12)
        f = gelu(prec.linear(x, p[pre + "intermediate.dense.weight"],
                             p[pre + "intermediate.dense.bias"], "ff"))
        f = prec.linear(f, p[pre + "output.dense.weight"], p[pre + "output.dense.bias"], "ff")
        x = layer_norm(x + f, p[pre + "output.LayerNorm.weight"], p[pre + "output.LayerNorm.bias"],
                       1e-12)
    return x[:, 0]


def z_t(p: dict, cfg: dict, ids, prec: Precision = FP32):
    """Caption ids (B, Lt) → z_t (B, proj)."""
    return _projection_head(p, "text_projection", bert_cls(p, cfg, ids, prec), prec)


def z_p(p: dict, cfg: dict, tokens, prec: Precision = FP32):
    """One protein's ESM ids (1, n), no padding → z_p (1, proj)."""
    return _projection_head(p, "protein_projection", esm2_cls(p, cfg, tokens, prec), prec)


@torch.no_grad()
def facilitator(p: dict, z, prec: Precision = FP32):
    """z_t (B, emb) → z_c (B, emb)."""
    def wn(i):
        v = p[f"main.{i}.weight_v"].float()
        return v * (p[f"main.{i}.weight_g"].float() / v.norm())

    h = gelu(prec.linear(z, wn(0), p["main.0.bias"], "head"))
    return prec.linear(h, wn(3), p["main.3.bias"], "head")

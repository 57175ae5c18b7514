"""JAX parameter trees → the port's modules.

Bridge for the tests that hold the port against ``biom3_tpu``: a Flax
parameter tree (numpy or JAX leaves; a tree of gradients has the same
shape) maps to the reference state-dict layout, which the port's modules
load with ``load_state_dict(strict=True)``.  The mapping is the port's own
numpy copy of ``biom3_tpu/io/export.py:21-184`` (``*_params_to_torch``),
held equal to it by ``tests/test_torch_imports.py``.  Imports no JAX.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from biom3_tpu_torch import config

from biom3_tpu_torch.config import ESM2Config, FacilitatorConfig, PenCLConfig, ProteoScribeConfig
from biom3_tpu_torch.io.state_dict import to_tensors
from biom3_tpu_torch.models.esm2 import ESM2, esm2_state_dict
from biom3_tpu_torch.models.facilitator import Facilitator
from biom3_tpu_torch.models.pencl import (
    PenCL,
    PenCLText,
    pencl_state_dict,
    pencl_train_state_dict,
    text_state_dict,
)
from biom3_tpu_torch.models.proteoscribe import ProteoScribe

# --- Flax tree → reference state-dict keys ---------------------------------

def _t(x) -> np.ndarray:
    return np.ascontiguousarray(np.transpose(np.asarray(x)))


def facilitator_params_to_torch(params: dict, cfg) -> dict:
    """Flax Facilitator params → ``main.{0,3}.weight_{g,v}/bias`` state dict
    (torch weight_norm modules recompute ``weight`` from g·v, so only the
    reparameterized tensors are stored — matching the published .bin)."""
    p = params["params"]
    out = {}
    for flax_name, torch_idx in (("fc1", "0"), ("fc2", "3")):
        v = np.asarray(p[flax_name]["v"], np.float32)
        g = np.asarray(p[flax_name]["g"], np.float32).reshape(())
        out[f"main.{torch_idx}.weight_v"] = v
        out[f"main.{torch_idx}.weight_g"] = g
        out[f"main.{torch_idx}.bias"] = np.asarray(p[flax_name]["b"], np.float32)
    return out


def proteoscribe_params_to_torch(params: dict, cfg) -> dict:
    """Flax ProteoScribe params → reference DiffTransformer state dict."""
    p = params["params"]
    sd: dict = {}
    sd["transformer.x_emb_NN.weight"] = np.asarray(p["tok_emb"]["embedding"])
    sd["transformer.axial_pos_emb.weights_0"] = np.asarray(p["ax_row"]).reshape(
        1, cfg.max_seq_len // cfg.local_window, 1, cfg.dim
    )
    sd["transformer.axial_pos_emb.weights_1"] = np.asarray(p["ax_col"]).reshape(
        1, 1, cfg.local_window, cfg.dim
    )

    def dense(prefix: str, leaf: dict) -> None:
        sd[f"{prefix}.weight"] = _t(leaf["kernel"])
        if "bias" in leaf:
            sd[f"{prefix}.bias"] = np.asarray(leaf["bias"])

    if "y_mlp" in p:
        dense("transformer.y_mlp.0", p["y_mlp"]["fc1"])
        dense("transformer.y_mlp.2", p["y_mlp"]["fc2"])
    dense("transformer.mlp.0", p["time_mlp"]["fc1"])
    dense("transformer.mlp.2", p["time_mlp"]["fc2"])

    def ln(prefix: str, leaf: dict) -> None:
        sd[f"{prefix}.weight"] = np.asarray(leaf["scale"])
        sd[f"{prefix}.bias"] = np.asarray(leaf["bias"])

    for bi in range(cfg.n_blocks):
        for li in range(cfg.depth):
            layer = p[f"layer_{bi}_{li}"]
            base = f"transformer.transformer_blocks.{bi}.{li}.layers.layers.0"
            ln(f"{base}.0.norm", layer["attn_norm"])
            for name in ("to_q", "to_k", "to_v"):
                sd[f"{base}.0.fn.{name}.weight"] = _t(
                    layer["attn"][f"{name}_kernel"]
                )
            dense(f"{base}.0.fn.to_out", layer["attn"]["to_out"])
            ln(f"{base}.1.norm", layer["ff_norm"])
            dense(f"{base}.1.fn.fn.w1", layer["ff_w1"])
            dense(f"{base}.1.fn.fn.w2", layer["ff_w2"])

    ln("transformer.norm", p["final_norm"])
    dense("transformer.out", p["out_proj"])
    return sd


# --- Stage-1 exporters (inverses of io/convert_stage1.py) -------------------


def _dense_out(sd: dict, prefix: str, leaf: dict) -> None:
    sd[f"{prefix}.weight"] = _t(leaf["kernel"])
    if "bias" in leaf:
        sd[f"{prefix}.bias"] = np.asarray(leaf["bias"], np.float32)


def _ln_out(sd: dict, prefix: str, leaf: dict) -> None:
    sd[f"{prefix}.weight"] = np.asarray(leaf["scale"], np.float32)
    sd[f"{prefix}.bias"] = np.asarray(leaf["bias"], np.float32)


def esm2_params_to_torch(params: dict, cfg) -> dict:
    """Flax ESM2 tree → fair-esm ESM2 state-dict names (the layout inside the
    published ``BioM3_PenCL`` .bin's ``protein_encoder.model.*`` subtree,
    ref Stage1_source/model.py:51-57)."""
    p = params.get("params", params)
    sd: dict = {
        "embed_tokens.weight": np.asarray(
            p["embed_tokens"]["embedding"], np.float32
        )
    }
    for i in range(cfg.num_layers):
        layer = p[f"layers_{i}"]
        b = f"layers.{i}"
        for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
            _dense_out(sd, f"{b}.self_attn.{name}", layer["self_attn"][name])
        _ln_out(sd, f"{b}.self_attn_layer_norm", layer["self_attn_layer_norm"])
        _dense_out(sd, f"{b}.fc1", layer["fc1"])
        _dense_out(sd, f"{b}.fc2", layer["fc2"])
        _ln_out(sd, f"{b}.final_layer_norm", layer["final_layer_norm"])
    _ln_out(sd, "emb_layer_norm_after", p["emb_layer_norm_after"])
    if "lm_head_dense" in p:
        _dense_out(sd, "lm_head.dense", p["lm_head_dense"])
        _ln_out(sd, "lm_head.layer_norm", p["lm_head_layer_norm"])
        sd["lm_head.bias"] = np.asarray(p["lm_head_bias"], np.float32)
        # fair-esm ties lm_head.weight to embed_tokens
        sd["lm_head.weight"] = sd["embed_tokens.weight"]
    return sd


def bert_params_to_torch(params: dict, cfg) -> dict:
    """Flax BERT tree → HF BertForMaskedLM state-dict names
    (``text_encoder.model.*`` subtree of the published .bin,
    ref Stage1_source/model.py:91-99)."""
    p = params.get("params", params)
    emb = "bert.embeddings"
    sd: dict = {}
    for flax_name, hf_name in (
        ("word_embeddings", "word_embeddings"),
        ("position_embeddings", "position_embeddings"),
        ("token_type_embeddings", "token_type_embeddings"),
    ):
        sd[f"{emb}.{hf_name}.weight"] = np.asarray(
            p[flax_name]["embedding"], np.float32
        )
    _ln_out(sd, f"{emb}.LayerNorm", p["embeddings_norm"])
    for i in range(cfg.num_layers):
        layer = p[f"layer_{i}"]
        b = f"bert.encoder.layer.{i}"
        for name in ("query", "key", "value"):
            _dense_out(sd, f"{b}.attention.self.{name}", layer["attention"][name])
        _dense_out(sd, f"{b}.attention.output.dense", layer["attention_output"])
        _ln_out(sd, f"{b}.attention.output.LayerNorm", layer["attention_norm"])
        _dense_out(sd, f"{b}.intermediate.dense", layer["intermediate"])
        _dense_out(sd, f"{b}.output.dense", layer["output"])
        _ln_out(sd, f"{b}.output.LayerNorm", layer["output_norm"])
    if "mlm_dense" in p:
        _dense_out(sd, "cls.predictions.transform.dense", p["mlm_dense"])
        _ln_out(sd, "cls.predictions.transform.LayerNorm", p["mlm_norm"])
        sd["cls.predictions.bias"] = np.asarray(p["mlm_bias"], np.float32)
    return sd


def projection_head_params_to_torch(leaf: dict) -> dict:
    sd: dict = {}
    _dense_out(sd, "projection", leaf["projection"])
    _dense_out(sd, "fc", leaf["fc"])
    _ln_out(sd, "layer_norm", leaf["layer_norm"])
    return sd


def pencl_params_to_torch(params: dict, cfg) -> dict:
    """Flax PenCL params → the published pfam_PEN_CL .bin layout
    (ref Stage1_source/model.py:178-207); inverse of
    ``io.convert_stage1.pencl_params_from_torch``."""
    p = params["params"]
    sd: dict = {}
    for k, v in esm2_params_to_torch(p["protein_encoder"], cfg.esm).items():
        sd[f"protein_encoder.model.{k}"] = v
    for k, v in bert_params_to_torch(p["text_encoder"], cfg.bert).items():
        sd[f"text_encoder.model.{k}"] = v
    for tower in ("protein", "text"):
        head = projection_head_params_to_torch(p[f"{tower}_projection"])
        for k, v in head.items():
            sd[f"{tower}_projection.{k}"] = v
    return sd


# --- the port's modules from a Flax tree ----------------------------------

def port_config(cfg):
    """The port's config with the class name and field values of a JAX
    package config dataclass (nested configs converted too)."""
    kw = {f.name: port_config(v) if dataclasses.is_dataclass(v := getattr(cfg, f.name)) else v
          for f in dataclasses.fields(cfg)}
    return getattr(config, type(cfg).__name__)(**kw)


def proteoscribe_from_jax(params: dict, cfg: ProteoScribeConfig) -> ProteoScribe:
    sd = to_tensors(proteoscribe_params_to_torch(params, cfg))
    model = ProteoScribe(cfg, conditional="transformer.y_mlp.0.weight" in sd)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def facilitator_from_jax(params: dict, cfg: FacilitatorConfig) -> Facilitator:
    model = Facilitator(cfg)
    model.load_state_dict(to_tensors(facilitator_params_to_torch(params, cfg)), strict=True)
    return model.eval()


def pencl_text_from_jax(params: dict, cfg: PenCLConfig) -> PenCLText:
    """Text tower + head of a PenCL tree; the protein tower, if the tree has
    one, and the MLM head are dropped explicitly (``text_state_dict``)."""
    p = params.get("params", params)
    sd = {f"text_encoder.model.{k}": v
          for k, v in bert_params_to_torch(p["text_encoder"], cfg.bert).items()}
    sd.update({f"text_projection.{k}": v
               for k, v in projection_head_params_to_torch(p["text_projection"]).items()})
    model = PenCLText(cfg)
    model.load_state_dict(text_state_dict(to_tensors(sd)), strict=True)
    return model.eval()


def esm2_from_jax(params: dict, cfg: ESM2Config, **kw) -> ESM2:
    """A Flax ESM2 tree → ``ESM2(cfg, **kw)``; an LM head in the tree is
    dropped explicitly (``esm2_state_dict``)."""
    model = ESM2(cfg, **kw)
    model.load_state_dict(esm2_state_dict(to_tensors(esm2_params_to_torch(params, cfg))),
                          strict=True)
    return model.eval()


def pencl_from_jax(params: dict, cfg: PenCLConfig, **kw) -> PenCL:
    """A full Flax PenCL tree → ``PenCL(cfg, **kw)``; the MLM heads are
    dropped explicitly (``pencl_state_dict``)."""
    model = PenCL(cfg, **kw)
    model.load_state_dict(pencl_state_dict(to_tensors(pencl_params_to_torch(params, cfg))),
                          strict=True)
    return model.eval()


def pencl_train_from_jax(params: dict, cfg: PenCLConfig, **kw) -> PenCL:
    """A full Flax PenCL tree (``PenCL.init_all_params``) → the training
    module ``PenCL(cfg, mlm_heads=True, **kw)``, both MLM heads carried
    over (``lm_head_dense``, ``lm_head_layer_norm``, ``lm_head_bias``,
    ``mlm_dense``, ``mlm_norm``, ``mlm_bias``)."""
    model = PenCL(cfg, mlm_heads=True, **kw)
    model.load_state_dict(pencl_train_state_dict(to_tensors(pencl_params_to_torch(params, cfg))),
                          strict=True)
    return model.eval()

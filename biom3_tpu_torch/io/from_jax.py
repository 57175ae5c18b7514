"""JAX parameter trees → the port's modules.

Bridge for the tests that hold the port against ``biom3_tpu``: a Flax
parameter tree (numpy or JAX leaves) goes through the JAX package's own
exporters (``biom3_tpu/io/export.py``) to the reference state-dict layout,
which the port's modules load with ``load_state_dict(strict=True)``.
Imports no JAX itself.
"""

from __future__ import annotations

from biom3_tpu.io.export import (
    bert_params_to_torch,
    esm2_params_to_torch,
    facilitator_params_to_torch,
    pencl_params_to_torch,
    projection_head_params_to_torch,
    proteoscribe_params_to_torch,
)
from biom3_tpu_torch.config import ESM2Config, FacilitatorConfig, PenCLConfig, ProteoScribeConfig
from biom3_tpu_torch.io.state_dict import to_tensors
from biom3_tpu_torch.models.esm2 import ESM2, esm2_state_dict
from biom3_tpu_torch.models.facilitator import Facilitator
from biom3_tpu_torch.models.pencl import PenCL, PenCLText, pencl_state_dict, text_state_dict
from biom3_tpu_torch.models.proteoscribe import ProteoScribe


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

"""Stage-1 PenCL: the BERT and ESM2 towers and their projection heads.

Port of ``biom3_tpu/models/pencl.py:22-106`` for inference: ``PenCL``
(both towers, both heads; ``forward`` → both latents, ``encode_text``,
``encode_protein``) and ``PenCLText``, the text side alone that the
text→protein path loads.  The contrastive and MLM losses belong to
training (ROADMAP queue 1, item 11).  Parameter names follow the published
pfam_PEN_CL ``.bin`` (``protein_encoder.model.*`` fair-esm names,
``text_encoder.model.bert.*`` HF names, ``{protein,text}_projection.*``);
``pencl_state_dict`` and ``text_state_dict`` name every key of such a file
that the module does not hold, so it loads with ``strict=True``.
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from biom3_tpu_torch.config import PenCLConfig
from biom3_tpu_torch.models.bert import BertEncoder
from biom3_tpu_torch.models.esm2 import ESM2, esm2_state_dict

_PROTEIN = "protein_encoder.model."
# keys of a full PenCL state dict that no inference path holds: the BERT
# MLM head and HF's non-parameter buffers (fair-esm's are named by
# esm2_state_dict)
_BERT_MLM = "text_encoder.model.cls."
_BUFFERS = ("text_encoder.model.bert.embeddings.position_ids",
            "text_encoder.model.bert.embeddings.token_type_ids")


def pencl_state_dict(sd: dict) -> dict:
    """Keep only the keys of ``PenCL`` from a full PenCL state dict: drop
    BERT's MLM head and buffers, and under ``protein_encoder.model.`` what
    ``esm2_state_dict`` drops (fair-esm's LM and contact heads and rotary
    buffers)."""
    esm = esm2_state_dict({k[len(_PROTEIN):]: v for k, v in sd.items()
                           if k.startswith(_PROTEIN)})
    out = {k: v for k, v in sd.items()
           if not k.startswith((_PROTEIN, _BERT_MLM)) and k not in _BUFFERS}
    out.update({_PROTEIN + k: v for k, v in esm.items()})
    return out


def text_state_dict(sd: dict) -> dict:
    """Keep only the keys of ``PenCLText`` from a full PenCL state dict."""
    return {k: v for k, v in pencl_state_dict(sd).items()
            if not k.startswith(("protein_encoder.", "protein_projection."))}


class ProjectionHead(nn.Module):
    """Linear → GELU → Linear → +residual → LayerNorm (eps 1e-5)
    (ref Stage1_source/model.py:136-167)."""

    def __init__(self, in_dim: int, proj_dim: int):
        super().__init__()
        self.projection = nn.Linear(in_dim, proj_dim)
        self.fc = nn.Linear(proj_dim, proj_dim)
        self.layer_norm = nn.LayerNorm(proj_dim, eps=1e-5)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        projected = self.projection(z)
        return self.layer_norm(self.fc(F.gelu(projected)) + projected)


class _Wrapped(nn.Module):
    """The reference wraps each tower as ``<tower>.model``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model


class PenCLText(nn.Module):
    """Text tower + text projection head: caption ids → z_t."""

    def __init__(self, cfg: PenCLConfig, *, attn_impl: str = "plain"):
        super().__init__()
        self.config = cfg
        self.text_encoder = _Wrapped(BertEncoder(cfg.bert, attn_impl=attn_impl))
        self.text_projection = ProjectionHead(cfg.text_embedding, cfg.proj_dim)

    @property
    def bert(self) -> BertEncoder:
        return self.text_encoder.model

    def encode_text(self, x_t: torch.Tensor) -> torch.Tensor:
        """caption tokens (B, L) → projected z_t (B, proj_dim)."""
        return self.text_projection(self.bert(x_t)["hidden"][:, 0, :])


class PenCL(PenCLText):
    """forward(x_t (B, Lt), x_p (B, Lp)) → {"text_joint_latent",
    "seq_joint_latent"}.  ``attn_impl`` ("plain" or "kernel") goes to both
    towers, ``gelu`` ("erf" or "tanh") to the ESM2 FF."""

    def __init__(self, cfg: PenCLConfig, *, attn_impl: str = "plain", gelu: str = "erf"):
        super().__init__(cfg, attn_impl=attn_impl)
        self.protein_encoder = _Wrapped(ESM2(cfg.esm, attn_impl=attn_impl, gelu=gelu))
        self.protein_projection = ProjectionHead(cfg.protein_embedding, cfg.proj_dim)

    @property
    def esm(self) -> ESM2:
        return self.protein_encoder.model

    def encode_protein(self, x_p: torch.Tensor) -> torch.Tensor:
        """protein tokens (B, L) → projected z_p (B, proj_dim)."""
        return self.protein_projection(self.esm(x_p)["hidden"][:, 0, :])

    def forward(self, x_t: torch.Tensor, x_p: torch.Tensor) -> dict:
        return {"text_joint_latent": self.encode_text(x_t),
                "seq_joint_latent": self.encode_protein(x_p)}

"""Stage-1 PenCL text side: the BERT tower and its projection head.

Port of ``biom3_tpu/models/pencl.py:22-120`` for the text→protein path:
``ProjectionHead`` and ``encode_text``.  The protein tower is not ported
yet.  Parameter names follow the published pfam_PEN_CL ``.bin``
(``text_encoder.model.bert.*``, ``text_projection.*``).
"""

from __future__ import annotations

import torch
import torch.nn as nn
import torch.nn.functional as F

from biom3_tpu_torch.config import PenCLConfig
from biom3_tpu_torch.models.bert import BertEncoder

# keys of a full PenCL state dict that the text path does not hold: the
# protein tower and head, the BERT MLM head, and HF's non-parameter buffers
_NOT_TEXT_PATH = ("protein_encoder.", "protein_projection.", "text_encoder.model.cls.")
_BUFFERS = ("text_encoder.model.bert.embeddings.position_ids",
            "text_encoder.model.bert.embeddings.token_type_ids")


def text_state_dict(sd: dict) -> dict:
    """Keep only the keys of ``PenCLText`` from a full PenCL state dict."""
    return {k: v for k, v in sd.items()
            if not k.startswith(_NOT_TEXT_PATH) and k not in _BUFFERS}


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

    def __init__(self, cfg: PenCLConfig):
        super().__init__()
        self.config = cfg
        self.text_encoder = _Wrapped(BertEncoder(cfg.bert))
        self.text_projection = ProjectionHead(cfg.text_embedding, cfg.proj_dim)

    @property
    def bert(self) -> BertEncoder:
        return self.text_encoder.model

    def encode_text(self, x_t: torch.Tensor) -> torch.Tensor:
        """caption tokens (B, L) → projected z_t (B, proj_dim)."""
        return self.text_projection(self.bert(x_t)["hidden"][:, 0, :])

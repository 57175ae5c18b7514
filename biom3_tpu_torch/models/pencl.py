"""Stage-1 PenCL: the BERT and ESM2 towers, their projection heads and losses.

Port of ``biom3_tpu/models/pencl.py``: ``PenCL`` (both towers, both heads;
``forward`` → both latents or, with ``compute_masked_logits``, both towers'
MLM logits; ``encode_text``, ``encode_protein``), ``PenCLText``, the text
side alone that the text→protein path loads, and the losses
``compute_inter_loss``, ``compute_intra_loss`` and
``compute_masked_lang_loss`` (:116-192).  Parameter names follow the
published pfam_PEN_CL ``.bin`` (``protein_encoder.model.*`` fair-esm names,
``text_encoder.model.bert.*`` HF names, ``{protein,text}_projection.*``).
``mlm_heads=True`` gives the training module: it holds every trained key
of that file under its published name, both MLM heads included
(``protein_encoder.model.lm_head.*``, ``text_encoder.model.cls.*``).
``pencl_state_dict``, ``text_state_dict`` and ``pencl_train_state_dict``
name every key of such a file that the module does not hold, so it loads
with ``strict=True``.

Training switches (``models/esm2.py``, ``models/bert.py``): ``attn_impl``
goes to both towers, except that under ``"layer-block"`` (the ESM2 layer
kernels) the BERT tower runs on torch ops, as the JAX PenCL does
(pencl.py:59-63); ``dtype``, ``remat``; dropout after the projection
heads' ``fc`` (``dropout``, active in train mode, pencl.py:22-37).
"""

from __future__ import annotations

import re

import torch
import torch.nn as nn
import torch.nn.functional as F

from biom3_tpu_torch.config import PenCLConfig
from biom3_tpu_torch.models.bert import BertEncoder
from biom3_tpu_torch.models.esm2 import ESM2, esm2_state_dict, esm2_train_state_dict
from biom3_tpu_torch.models.layers import dense, layer_norm

_PROTEIN = "protein_encoder.model."
# keys of a full PenCL state dict that no inference path holds: the BERT
# MLM head and HF's non-parameter buffers (fair-esm's are named by
# esm2_state_dict)
_BERT_MLM = "text_encoder.model.cls."
_BUFFERS = ("text_encoder.model.bert.embeddings.position_ids",
            "text_encoder.model.bert.embeddings.token_type_ids")
# the BERT MLM decoder of HF's layout, tied to the word embeddings and to
# cls.predictions.bias: no module holds it
_BERT_DECODER = re.compile(r"text_encoder\.model\.cls\.predictions\.decoder\.")


def _split_esm(sd: dict, keep_esm) -> dict:
    esm = keep_esm({k[len(_PROTEIN):]: v for k, v in sd.items() if k.startswith(_PROTEIN)})
    out = {k: v for k, v in sd.items() if not k.startswith(_PROTEIN) and k not in _BUFFERS}
    out.update({_PROTEIN + k: v for k, v in esm.items()})
    return out


def pencl_state_dict(sd: dict) -> dict:
    """Keep only the keys of ``PenCL`` from a full PenCL state dict: drop
    BERT's MLM head and buffers, and under ``protein_encoder.model.`` what
    ``esm2_state_dict`` drops (fair-esm's LM and contact heads and rotary
    buffers)."""
    return {k: v for k, v in _split_esm(sd, esm2_state_dict).items()
            if not k.startswith(_BERT_MLM)}


def pencl_train_state_dict(sd: dict) -> dict:
    """Keep only the keys of ``PenCL(mlm_heads=True)``: as
    ``pencl_state_dict``, but both MLM heads stay (not their tied decoder
    weights)."""
    return {k: v for k, v in _split_esm(sd, esm2_train_state_dict).items()
            if not _BERT_DECODER.match(k)}


def text_state_dict(sd: dict) -> dict:
    """Keep only the keys of ``PenCLText`` from a full PenCL state dict."""
    return {k: v for k, v in pencl_state_dict(sd).items()
            if not k.startswith(("protein_encoder.", "protein_projection."))}


def published_state_dict(model: "PenCL") -> dict:
    """The training module's parameters as a published pfam_PEN_CL ``.bin``
    (f32, CPU), with fair-esm's tied ``lm_head.weight`` written out as
    ``biom3_tpu/io/export.py::esm2_params_to_torch`` writes it."""
    sd = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    sd[_PROTEIN + "lm_head.weight"] = sd[_PROTEIN + "embed_tokens.weight"]
    return sd


class ProjectionHead(nn.Module):
    """Linear → GELU → Linear → Dropout → +residual → LayerNorm (eps 1e-5)
    (ref Stage1_source/model.py:136-167)."""

    def __init__(self, in_dim: int, proj_dim: int, dropout: float = 0.0,
                 dtype: torch.dtype | None = None):
        super().__init__()
        self.dtype = dtype
        self.projection = nn.Linear(in_dim, proj_dim)
        self.fc = nn.Linear(proj_dim, proj_dim)
        self.dropout = nn.Dropout(dropout)
        self.layer_norm = nn.LayerNorm(proj_dim, eps=1e-5)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        projected = dense(self.projection, z, self.dtype)
        h = self.dropout(dense(self.fc, F.gelu(projected), self.dtype))
        return layer_norm(self.layer_norm, h + projected, self.dtype)


class _Wrapped(nn.Module):
    """The reference wraps each tower as ``<tower>.model``."""

    def __init__(self, model: nn.Module):
        super().__init__()
        self.model = model


class PenCLText(nn.Module):
    """Text tower + text projection head: caption ids → z_t."""

    def __init__(self, cfg: PenCLConfig, *, attn_impl: str = "plain",
                 dtype: torch.dtype | None = None, remat: bool = False, mlm_heads: bool = False):
        super().__init__()
        self.config = cfg
        bert_impl = "plain" if attn_impl == "layer-block" else attn_impl
        self.text_encoder = _Wrapped(BertEncoder(cfg.bert, attn_impl=bert_impl, dtype=dtype,
                                                 remat=remat, mlm_head=mlm_heads))
        self.text_projection = ProjectionHead(cfg.text_embedding, cfg.proj_dim, cfg.dropout,
                                              dtype)

    @property
    def bert(self) -> BertEncoder:
        return self.text_encoder.model

    def encode_text(self, x_t: torch.Tensor) -> torch.Tensor:
        """caption tokens (B, L) → projected z_t (B, proj_dim)."""
        return self.text_projection(self.bert(x_t)["hidden"][:, 0, :])


class PenCL(PenCLText):
    """forward(x_t (B, Lt), x_p (B, Lp)) → {"text_joint_latent",
    "seq_joint_latent"}, or with ``compute_masked_logits`` →
    {"text_masked_logits", "protein_masked_logits"} (needs
    ``mlm_heads=True``).  ``attn_impl`` ("plain", "kernel" or
    "layer-block"), ``dtype`` and ``remat`` go to the towers, ``gelu``
    ("erf" or "tanh") to the ESM2 FF."""

    def __init__(self, cfg: PenCLConfig, *, attn_impl: str = "plain", gelu: str = "erf",
                 dtype: torch.dtype | None = None, remat: bool = False, mlm_heads: bool = False):
        super().__init__(cfg, attn_impl=attn_impl, dtype=dtype, remat=remat, mlm_heads=mlm_heads)
        self.protein_encoder = _Wrapped(ESM2(cfg.esm, attn_impl=attn_impl, gelu=gelu, dtype=dtype,
                                             remat=remat, lm_head=mlm_heads))
        self.protein_projection = ProjectionHead(cfg.protein_embedding, cfg.proj_dim,
                                                 cfg.dropout, dtype)

    @property
    def esm(self) -> ESM2:
        return self.protein_encoder.model

    def encode_protein(self, x_p: torch.Tensor) -> torch.Tensor:
        """protein tokens (B, L) → projected z_p (B, proj_dim)."""
        return self.protein_projection(self.esm(x_p)["hidden"][:, 0, :])

    def forward(self, x_t: torch.Tensor, x_p: torch.Tensor, *,
                compute_masked_logits: bool = False) -> dict:
        if compute_masked_logits:
            return {"text_masked_logits": self.bert(x_t, compute_logits=True)["logits"],
                    "protein_masked_logits": self.esm(x_p, compute_logits=True)["logits"]}
        return {"text_joint_latent": self.encode_text(x_t),
                "seq_joint_latent": self.encode_protein(x_p)}


# --- losses (ref Stage1_source/model.py:241-465) ------------------------------

NEG_FILL_F32 = -9e15  # ref set_inf for fp32 (model.py:365-381)
NEG_FILL_F16 = -1e4


def _set_inf(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    return x.masked_fill(mask, NEG_FILL_F32 if x.dtype == torch.float32 else NEG_FILL_F16)


def _soft_cross_entropy(preds: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """(-targets · log_softmax(preds)).sum(-1)."""
    return (-targets * torch.log_softmax(preds, dim=-1)).sum(-1)


def compute_inter_loss(protein_embeddings: torch.Tensor, text_embeddings: torch.Tensor,
                       batch_size: int, temperature: float):
    """Inter-modal InfoNCE over the 2B (SwissProt + Pfam) global batch; rows
    i and i ± B are the same pair and are masked out of each other's
    negatives.  Returns (loss, masked logits)."""
    n = protein_embeddings.shape[0]
    eye = torch.eye(batch_size, dtype=torch.bool, device=protein_embeddings.device)
    mask = torch.zeros((n, n), dtype=torch.bool, device=protein_embeddings.device)
    mask[batch_size:, :batch_size] = eye
    mask[:batch_size, batch_size:] = eye
    logits = (text_embeddings @ protein_embeddings.T) / temperature
    m_protein = _set_inf(protein_embeddings @ protein_embeddings.T, mask)
    m_text = _set_inf(text_embeddings @ text_embeddings.T, mask)
    m_logits = _set_inf(logits, mask)
    targets = torch.softmax((m_protein + m_text) / (2 * temperature), dim=-1)
    text_loss = _soft_cross_entropy(m_logits, targets)
    protein_loss = _soft_cross_entropy(m_logits.T, targets.T)
    return ((protein_loss + text_loss) / 2.0).mean(), m_logits


def compute_intra_loss(protein_embeddings: torch.Tensor, temperature: float):
    """Intra-modal InfoNCE; row r's positive sits half the global batch away,
    at column (r - n/2) mod n.  Returns (loss, similarity)."""
    n = protein_embeddings.shape[0]
    sim = (protein_embeddings @ protein_embeddings.T) / temperature
    sim = _set_inf(sim, torch.eye(n, dtype=torch.bool, device=sim.device))
    pos_cols = (torch.arange(n, device=sim.device) - n // 2) % n
    positives = sim.gather(1, pos_cols[:, None])[:, 0]
    return (torch.logsumexp(sim, dim=-1) - positives).mean(), sim


def masked_lang_loss_sums(logits_masked: torch.Tensor, targets: torch.Tensor,
                          targets_masked: torch.Tensor,
                          mask_token_id: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``compute_masked_lang_loss``'s numerator (the per-sample mean
    cross-entropies, summed over the samples with a mask) and denominator
    (that count, int64): a batch split over ranks sums both over them."""
    logp = torch.log_softmax(logits_masked.float(), dim=-1)
    tgt = targets.reshape(targets.shape[0], -1).long()
    ce = -logp.gather(-1, tgt[..., None])[..., 0]
    is_masked = targets_masked.reshape(tgt.shape) == mask_token_id
    per_sample = (ce * is_masked).sum(-1) / is_masked.sum(-1).clamp(min=1)
    has_mask = is_masked.any(-1)
    return (per_sample * has_mask).sum(), has_mask.sum()


def compute_masked_lang_loss(logits_masked: torch.Tensor, targets: torch.Tensor,
                             targets_masked: torch.Tensor, mask_token_id: int) -> torch.Tensor:
    """Mean cross-entropy over the positions holding ``mask_token_id`` in
    the corrupted input, per sample, then over the samples with at least
    one such position."""
    total, count = masked_lang_loss_sums(logits_masked, targets, targets_masked, mask_token_id)
    return total / count.clamp(min=1)

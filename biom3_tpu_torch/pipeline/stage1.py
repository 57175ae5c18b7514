"""Stage-1 inference engine: PenCL embeddings and similarity scores.

Port of ``biom3_tpu/pipeline/stage1.py``: ``compute_scores``,
``PenCLEngine`` with ``tokenize``, ``embed_tokens``, ``embed`` and the
text-only ``embed_text`` that the text→protein path calls.  Two tower
paths, as in the JAX engine:

* ``tower_impl="fused-stack"`` (default): the towers' CLS rows through
  ``ops/bert_stack.fused_bert_cls`` and ``ops/esm2_stack.fused_esm2_cls``,
  the counterparts of the TPU kernels; the projection heads run f32 in
  plain torch.  The f32 ESM2 module stays on the host: only its stacked
  arrays go to the device.
* ``tower_impl="graph"``: the ``PenCL`` module in the engine's dtype with
  ``attn_impl="kernel"`` (the ``flash_attention`` kernel in both towers),
  the counterpart of the JAX engine's ``tower_impl="flax"`` with
  ``attn_impl="pallas:…"``.

On ``cuda`` the towers run bf16 with tanh GELU (the JAX engine's
perf-mode choice, stage1.py:114); on ``cpu`` they run f32 with exact GELU
on the kernels' plain versions.  The int8 modes are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from biom3_tpu_torch.config import Config, PenCLConfig
from biom3_tpu_torch.io.state_dict import load_reference_state_dict, seeded_init_
from biom3_tpu_torch.models.pencl import PenCL, PenCLText, pencl_state_dict, text_state_dict
from biom3_tpu_torch.ops.bert_stack import bert_embed, bert_stack_arrays, fused_bert_cls
from biom3_tpu_torch.ops.esm2_stack import esm2_stack_arrays, fused_esm2_cls
from biom3_tpu_torch.tokenizers import TextTokenizer, esm_batch_encode

TOWER_IMPLS = ("fused-stack", "graph")


@torch.no_grad()
def compute_scores(z_p, z_t) -> dict:
    """The reference CLI's printed score set (run_PenCL_inference.py:132-144),
    f32 tensors."""
    z_p = torch.as_tensor(z_p, dtype=torch.float32)
    z_t = torch.as_tensor(z_t, dtype=torch.float32, device=z_p.device)
    dot = z_p @ z_t.T
    z_p_n = z_p / z_p.norm(dim=1, keepdim=True)
    return {
        "dot_product_scores": dot,
        "protein_given_text_probs": torch.softmax(dot, dim=0),
        "text_given_protein_probs": torch.softmax(dot, dim=1),
        "z_p_magnitude": z_p.norm(dim=1),
        "z_t_magnitude": z_t.norm(dim=1),
        "homology_matrix": z_p_n @ z_p_n.T,
    }


class PenCLEngine:
    def __init__(self, stage_config: Config, model_path: str | None = None, *,
                 device: str | torch.device = "cpu", text_tokenizer=None,
                 text_only: bool = False, tower_impl: str = "fused-stack"):
        if tower_impl not in TOWER_IMPLS:
            raise ValueError(f"tower_impl must be one of {TOWER_IMPLS}, got {tower_impl!r}")
        self.stage_config = stage_config
        self.config = PenCLConfig.from_stage_config(stage_config)
        self.device = torch.device(device)
        self.text_only, self.tower_impl = text_only, tower_impl
        on_cuda = self.device.type == "cuda"
        self.dtype = torch.bfloat16 if on_cuda else torch.float32
        self.gelu = "tanh" if on_cuda else "erf"
        if text_only:
            model, keep = PenCLText(self.config, attn_impl="kernel"), text_state_dict
        else:
            model = PenCL(self.config, attn_impl="kernel", gelu=self.gelu)
            keep = pencl_state_dict
        if model_path is not None:
            model.load_state_dict(keep(load_reference_state_dict(model_path)), strict=True)
        else:
            seeded_init_(model, seed=0)
        model.eval()
        self._text_tokenizer = text_tokenizer
        if tower_impl == "graph":
            self.model = model.to(device=self.device, dtype=self.dtype)
            return
        for name, child in model.named_children():
            if name != "protein_encoder":
                child.to(self.device)
        self.model = model
        self._bert_arrays = bert_stack_arrays(model.bert, self.dtype)
        if not text_only:
            self._esm_arrays = esm2_stack_arrays(model.esm, self.dtype, self.device)

    @property
    def text_tokenizer(self):
        if self._text_tokenizer is None:
            self._text_tokenizer = TextTokenizer(self.stage_config.text_model_path,
                                                 max_length=self.config.text_max_length)
        return self._text_tokenizer

    def tokenize(self, captions: list[str], sequences: list[str]) -> tuple:
        """Caption wordpiece ids (B, Lt) and ESM ids padded to
        ``seq_max_length`` (B, 1024), int32 numpy."""
        x_t = self.text_tokenizer.batch_encode(captions)["input_ids"]
        x_p = esm_batch_encode(sequences, pad_to=self.config.seq_max_length)
        return x_t, x_p

    def _ids(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.int32), device=self.device)

    def embed_text(self, captions: list[str], batch_size: int = 32) -> np.ndarray:
        """Text-only z_t (B, proj_dim), f32."""
        outs = []
        for i in range(0, len(captions), batch_size):
            ids = self._ids(self.text_tokenizer.batch_encode(captions[i:i + batch_size])
                            ["input_ids"])
            outs.append(self._encode_text(ids).float().cpu().numpy())
        return np.concatenate(outs)

    @torch.no_grad()
    def _encode_text(self, ids: torch.Tensor) -> torch.Tensor:
        if self.tower_impl == "graph":
            return self.model.encode_text(ids)
        bert_cfg = self.config.bert
        x0 = bert_embed(self.model.bert, ids, eps=bert_cfg.layer_norm_eps, dtype=self.dtype)
        cls = fused_bert_cls(x0.contiguous(), **self._bert_arrays, heads=bert_cfg.num_heads,
                             gelu=self.gelu, eps=bert_cfg.layer_norm_eps)
        return self.model.text_projection(cls)

    @torch.no_grad()
    def embed_tokens(self, x_t, x_p) -> tuple[torch.Tensor, torch.Tensor]:
        """Token ids of paired captions and proteins → (z_t, z_p), f32 on
        the engine's device."""
        if self.text_only:
            raise ValueError("a text_only engine holds no protein tower")
        x_t, x_p = self._ids(x_t), self._ids(x_p)
        if self.tower_impl == "graph":
            out = self.model(x_t, x_p)
            return out["text_joint_latent"].float(), out["seq_joint_latent"].float()
        esm = self.config.esm
        cls = fused_esm2_cls(x_p, **self._esm_arrays, heads=esm.attention_heads,
                             gelu=self.gelu, pad_idx=esm.pad_idx, mask_idx=esm.mask_idx,
                             token_dropout=esm.token_dropout)
        return self._encode_text(x_t), self.model.protein_projection(cls)

    def embed(self, captions: list[str], sequences: list[str],
              batch_size: int = 16) -> tuple[np.ndarray, np.ndarray]:
        """Batched z_t, z_p (f32 numpy) for paired caption/sequence lists."""
        z_t_all, z_p_all = [], []
        for i in range(0, len(captions), batch_size):
            x_t, x_p = self.tokenize(captions[i:i + batch_size], sequences[i:i + batch_size])
            z_t, z_p = self.embed_tokens(x_t, x_p)
            z_t_all.append(z_t.cpu().numpy())
            z_p_all.append(z_p.cpu().numpy())
        return np.concatenate(z_t_all), np.concatenate(z_p_all)

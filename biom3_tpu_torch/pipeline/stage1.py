"""Stage-1 inference engine, text side: captions → z_t.

Port of ``biom3_tpu/pipeline/stage1.py:38-231`` with ``text_only=True``:
wordpiece tokenisation, the BERT tower's CLS row through
``ops/bert_stack.fused_bert_cls`` (the counterpart of the TPU kernel), and
the text projection head.  On ``cuda`` the tower runs bf16 on the kernels
with tanh GELU (the JAX engine's perf-mode choice, stage1.py:114); on
``cpu`` it runs f32 with exact GELU on the kernels' plain versions.  The
projection head runs f32 in plain torch.  The protein tower is not ported
yet.
"""

from __future__ import annotations

import numpy as np
import torch

from biom3_tpu_torch.config import Config, PenCLConfig
from biom3_tpu_torch.io.state_dict import load_reference_state_dict, seeded_init_
from biom3_tpu_torch.models.pencl import PenCLText, text_state_dict
from biom3_tpu_torch.ops.bert_stack import bert_embed, bert_stack_arrays, fused_bert_cls
from biom3_tpu_torch.tokenizers import TextTokenizer


class PenCLEngine:
    def __init__(self, stage_config: Config, model_path: str | None = None, *,
                 device: str | torch.device = "cpu", text_tokenizer=None,
                 text_only: bool = True):
        if not text_only:
            raise NotImplementedError(
                "the protein tower is not ported yet (ROADMAP queue 1, item 8); "
                "use text_only=True")
        self.stage_config = stage_config
        self.config = PenCLConfig.from_stage_config(stage_config)
        self.device = torch.device(device)
        model = PenCLText(self.config)
        if model_path is not None:
            model.load_state_dict(text_state_dict(load_reference_state_dict(model_path)),
                                  strict=True)
        else:
            seeded_init_(model, seed=0)
        self.model = model.to(self.device).eval()
        on_cuda = self.device.type == "cuda"
        self.dtype = torch.bfloat16 if on_cuda else torch.float32
        self.gelu = "tanh" if on_cuda else "erf"
        self._stack_arrays = bert_stack_arrays(self.model.bert, self.dtype)
        self._text_tokenizer = text_tokenizer

    @property
    def text_tokenizer(self):
        if self._text_tokenizer is None:
            self._text_tokenizer = TextTokenizer(self.stage_config.text_model_path,
                                                 max_length=self.config.text_max_length)
        return self._text_tokenizer

    def embed_text(self, captions: list[str], batch_size: int = 32) -> np.ndarray:
        """Text-only z_t (B, proj_dim), f32."""
        outs = []
        for i in range(0, len(captions), batch_size):
            ids = self.text_tokenizer.batch_encode(captions[i:i + batch_size])["input_ids"]
            ids = torch.as_tensor(np.asarray(ids), device=self.device)
            outs.append(self._embed_text_fused(ids).cpu().numpy())
        return np.concatenate(outs)

    @torch.no_grad()
    def _embed_text_fused(self, ids: torch.Tensor) -> torch.Tensor:
        bert_cfg = self.config.bert
        x0 = bert_embed(self.model.bert, ids, eps=bert_cfg.layer_norm_eps, dtype=self.dtype)
        cls = fused_bert_cls(x0.contiguous(), **self._stack_arrays, heads=bert_cfg.num_heads,
                             gelu=self.gelu, eps=bert_cfg.layer_norm_eps)
        return self.model.text_projection(cls)

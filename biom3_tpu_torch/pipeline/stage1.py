"""Stage-1 inference engine: PenCL embeddings and similarity scores.

Port of ``biom3_tpu/pipeline/stage1.py``: ``compute_scores``,
``PenCLEngine`` with ``tokenize``, ``embed_tokens``, ``embed`` and the
text-only ``embed_text`` that the text→protein path calls.  Two tower
paths, as in the JAX engine:

* ``tower_impl="fused-stack"``: the towers' CLS rows through
  ``ops/bert_stack.fused_bert_cls`` and ``ops/esm2_stack.fused_esm2_cls``,
  the counterparts of the TPU kernels; the projection heads run f32 in
  plain torch.  The f32 ESM2 module stays on the host: only its stacked
  arrays go to the device.
* ``tower_impl="graph"``: the ``PenCL`` module in the engine's dtype, the
  counterpart of the JAX engine's ``tower_impl="flax"``, with
  ``attn_impl="kernel"`` (the ``flash_attention`` kernel in both towers,
  the JAX ``attn_impl="pallas:…"``) or ``"plain"`` (torch ops, ``"xla"``).

``dtype`` has the JAX engine's meaning (stage1.py:44,58-93): ``float32``
(the default) runs the graph path in f32 on the engine's device with erf
GELU, plain attention and no quantization; ``bfloat16`` on ``cuda`` (perf
mode) runs the fused-stack path with tanh GELU, and the JAX engine's four
int8 knobs (stage1.py:71-93) left at ``None`` (auto) mean ``"int8"``:
``ff_quant``/``proj_quant`` for the ESM2 tower,
``bert_ff_quant``/``bert_proj_quant`` for BERT; ``bfloat16`` on ``cpu``
runs the graph path in bf16.  ``tower_supported`` gates the fused-stack
path and the flash kernel by the towers' shapes: in perf mode a config it
refuses runs the graph path with plain attention, and the reason is logged
once.  ``use_stack=True`` forces the fused-stack path (on ``cpu`` the
kernels' plain versions in f32 with erf GELU and quant auto ``"none"``);
``tower_impl`` names a path outright.  The graph path never quantizes.
``gelu`` (``"erf"``/``"tanh"``) overrides the GELU the mode picks, for
both paths.  ``replica(device)`` gives a fused-stack engine's copy on
another card (the mesh's ``pipeline/sweep.Stage1SweepRunner``).
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from biom3_tpu_torch.config import Config, PenCLConfig
from biom3_tpu_torch.io.state_dict import load_reference_state_dict, seeded_init_
from biom3_tpu_torch.models.fused_forward import HEAD_DIMS, log_once
from biom3_tpu_torch.pipeline import require_device
from biom3_tpu_torch.models.pencl import PenCL, PenCLText, pencl_state_dict, text_state_dict
from biom3_tpu_torch.parallel.sharding import moved_to
from biom3_tpu_torch.ops.bert_stack import bert_embed, bert_stack_arrays, fused_bert_cls
from biom3_tpu_torch.ops.esm2_stack import esm2_stack_arrays, fused_esm2_cls
from biom3_tpu_torch.tokenizers import TextTokenizer, esm_batch_encode

TOWER_IMPLS = ("fused-stack", "graph")
QUANT_MODES = ("none", "int8")


def tower_supported(cfg: PenCLConfig, *, text_only: bool = False) -> tuple[bool, str]:
    """(True, "") when the towers' kernels take ``cfg`` (BERT, and ESM2
    unless ``text_only``), else (False, the first reason): widths divisible
    by the heads, head dims the attention kernels take, FF widths a
    multiple of 32 (``gemm_i8``'s K; the head dims make the widths one)."""
    towers = [("BERT", cfg.bert.hidden_size, cfg.bert.num_heads, cfg.bert.intermediate_size)]
    if not text_only:
        e = cfg.esm.embed_dim
        towers.append(("ESM2", e, cfg.esm.attention_heads, 4 * e))
    for name, width, heads, ff in towers:
        if width % heads:
            return False, f"{name} width {width} not divisible by {heads} heads"
        if width // heads not in HEAD_DIMS:
            return False, (f"{name} head dim {width // heads} (the attention kernels take "
                           f"{HEAD_DIMS})")
        if ff % 32:
            return False, f"{name} FF width {ff} not a multiple of 32"
    return True, ""


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
                 device: str | torch.device = "cuda", dtype: torch.dtype = torch.float32,
                 use_stack: bool | None = None, text_tokenizer=None, text_only: bool = False,
                 tower_impl: str | None = None, attn_impl: str | None = None,
                 ff_quant: str | None = None, proj_quant: str | None = None,
                 bert_ff_quant: str | None = None, bert_proj_quant: str | None = None,
                 gelu: str | None = None):
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        if tower_impl not in TOWER_IMPLS + (None,):
            raise ValueError(f"tower_impl must be one of {TOWER_IMPLS}, got {tower_impl!r}")
        if attn_impl not in ("kernel", "plain", None):
            raise ValueError(f"attn_impl must be 'kernel' or 'plain', got {attn_impl!r}")
        self.stage_config = stage_config
        self.config = PenCLConfig.from_stage_config(stage_config)
        self.device = torch.device(device)
        self.text_only = text_only
        on_cuda = self.device.type == "cuda"
        perf = on_cuda and dtype == torch.bfloat16
        supported, reason = tower_supported(self.config, text_only=text_only)
        self.gate_reason = reason
        if tower_impl is None:
            if use_stack is None:
                use_stack = perf and supported
                if perf and not supported:
                    log_once(f"PenCLEngine: running the PenCL module with plain attention: "
                             f"{reason}")
            tower_impl = "fused-stack" if use_stack else "graph"
        elif use_stack is not None and use_stack != (tower_impl == "fused-stack"):
            raise ValueError(f"use_stack={use_stack} contradicts tower_impl={tower_impl!r}")
        self.tower_impl = tower_impl
        self.use_fused_stack = tower_impl == "fused-stack"
        if self.use_fused_stack and on_cuda and dtype != torch.bfloat16:
            raise ValueError("the tower kernels run bf16 on cuda: pass dtype=torch.bfloat16 "
                             "or use the graph path")
        # the kernels' dtype on the fused-stack path (bf16 on the card, f32
        # plain versions on the CPU); the module's otherwise
        self.dtype = ((torch.bfloat16 if on_cuda else torch.float32) if self.use_fused_stack
                      else dtype)
        if gelu not in ("erf", "tanh", None):
            raise ValueError(f"gelu must be 'erf' or 'tanh', got {gelu!r}")
        self.gelu = gelu or ("tanh" if perf else "erf")
        if attn_impl is None:
            attn_impl = "kernel" if perf and supported else "plain"
        self.attn_impl = attn_impl
        auto = "int8" if perf and self.use_fused_stack else "none"
        self.ff_quant, self.proj_quant, self.bert_ff_quant, self.bert_proj_quant = (
            auto if q is None else q for q in (ff_quant, proj_quant, bert_ff_quant,
                                               bert_proj_quant))
        quant = (self.ff_quant, self.proj_quant, self.bert_ff_quant, self.bert_proj_quant)
        if any(q not in QUANT_MODES for q in quant):
            raise ValueError(f"quant modes must be in {QUANT_MODES}, got {quant}")
        if not self.use_fused_stack and "int8" in quant:
            raise ValueError("the graph tower path never quantizes; int8 needs "
                             "tower_impl='fused-stack'")
        require_device(self.device, "PenCLEngine")
        if text_only:
            model, keep = PenCLText(self.config, attn_impl=attn_impl), text_state_dict
        else:
            model = PenCL(self.config, attn_impl=attn_impl, gelu=self.gelu)
            keep = pencl_state_dict
        if model_path is not None:
            model.load_state_dict(keep(load_reference_state_dict(model_path)), strict=True)
        else:
            seeded_init_(model, seed=0)
        model.eval()
        self._text_tokenizer = text_tokenizer
        if not self.use_fused_stack:
            self.model = model.to(device=self.device, dtype=self.dtype)
            return
        for name, child in model.named_children():
            if name != "protein_encoder":
                child.to(self.device)
        self.model = model
        self._bert_arrays = bert_stack_arrays(model.bert, self.dtype, ff_quant=self.bert_ff_quant,
                                              proj_quant=self.bert_proj_quant)
        if not text_only:
            self._esm_arrays = esm2_stack_arrays(model.esm, self.dtype, self.device,
                                                 ff_quant=self.ff_quant,
                                                 proj_quant=self.proj_quant)

    def replica(self, device) -> "PenCLEngine":
        """This fused-stack engine serving ``device``: the towers' packed
        arrays and the modules ``embed_tokens`` reads copied there; the f32
        ESM2 module, which stays on the host, is shared."""
        if not self.use_fused_stack:
            raise ValueError("replica() copies a fused-stack engine; the graph path's module "
                             "moves with .to()")
        out = copy.copy(self)
        out.device = torch.device(device)
        out.model = copy.copy(self.model)
        out.model._modules = {name: child if name == "protein_encoder"
                              else copy.deepcopy(child).to(out.device)
                              for name, child in self.model._modules.items()}
        out._bert_arrays = moved_to(self._bert_arrays, out.device)
        if not self.text_only:
            out._esm_arrays = moved_to(self._esm_arrays, out.device)
        return out

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
        if not self.use_fused_stack:
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
        if not self.use_fused_stack:
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

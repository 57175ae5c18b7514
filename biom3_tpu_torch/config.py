"""Typed config system that reads the reference JSON configs verbatim.

The port's own copy of ``biom3_tpu/config.py`` (``Config``,
``load_json_config`` and the ``ESM2``, ``Bert``, ``PenCL``, ``Facilitator``
and ``ProteoScribe`` configs, with the same field names and
``from_stage_config`` rules); ``tests/test_torch_imports.py`` holds the two
equal.  The reference loads each stage's JSON into a recursive
``argparse.Namespace`` and relies on loosely typed quirks, which
``Config`` accepts:

  * numeric values stored as strings (``"weight_decay": "5e-7"``),
  * the literal string ``"None"`` used as a null sentinel,
  * keys freely added at runtime (``args.device``).
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Iterator, Mapping


_NONE_SENTINELS = ("None", "none", "null", "")


class Config:
    """Attribute-accessible view over a JSON config dict with typed coercers.

    Mirrors the reference's recursive-``Namespace`` behavior (nested dicts
    become nested ``Config``), with mutation allowed because the reference
    CLIs attach extra keys at runtime (e.g. ``config_args.device = ...``).
    """

    def __init__(self, data: Mapping[str, Any] | None = None, **kwargs: Any):
        object.__setattr__(self, "_data", {})
        merged = dict(data or {})
        merged.update(kwargs)
        for key, value in merged.items():
            self._data[key] = Config(value) if isinstance(value, dict) else value

    # --- attribute & mapping protocol -------------------------------------
    def __getattr__(self, name: str) -> Any:
        data = object.__getattribute__(self, "_data")
        if name in data:
            return data[name]
        raise AttributeError(f"config has no key {name!r}; available: {sorted(data)}")

    def __setattr__(self, name: str, value: Any) -> None:
        self._data[name] = Config(value) if isinstance(value, dict) else value

    def __contains__(self, name: str) -> bool:
        return name in self._data

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __repr__(self) -> str:
        return f"Config({self._data!r})"

    def get(self, name: str, default: Any = None) -> Any:
        return self._data.get(name, default)

    def to_dict(self) -> dict:
        out = {}
        for key, value in self._data.items():
            out[key] = value.to_dict() if isinstance(value, Config) else value
        return out

    # --- typed coercers ----------------------------------------------------
    def float(self, name: str, default: float | None = None) -> float | None:
        """Float-valued key; tolerates string-encoded numbers ("5e-7")."""
        value = self._data.get(name, default)
        if value is None or self.is_none_sentinel(value):
            return default
        return float(value)

    def int(self, name: str, default: int | None = None) -> int | None:
        value = self._data.get(name, default)
        if value is None or self.is_none_sentinel(value):
            return default
        return int(float(value))

    def str_or_none(self, name: str, default: str | None = None) -> str | None:
        """String-valued key where "None" means null (reference convention)."""
        value = self._data.get(name, default)
        if value is None or self.is_none_sentinel(value):
            return None
        return str(value)

    def bool(self, name: str, default: bool = False) -> bool:
        value = self._data.get(name, default)
        if isinstance(value, str):
            return value.lower() in ("true", "1", "yes")
        return bool(value)

    @staticmethod
    def is_none_sentinel(value: Any) -> bool:
        return isinstance(value, str) and value in _NONE_SENTINELS


def load_json_config(json_path: str) -> Config:
    """Load a reference-format JSON config (the reference CLIs' step 1+2)."""
    with open(json_path, "r") as f:
        return Config(json.load(f))


# ---------------------------------------------------------------------------
# Structured model configs.  These are the framework-native descriptions of
# each model graph; ``from_stage_config`` adapts a reference JSON to them.
# Defaults are the published checkpoints' hyperparameters (SURVEY.md §2.5).
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ESM2Config:
    """ESM2 encoder (reference tower: esm2_t33_650M_UR50D).

    Constants mirror fair-esm's ESM2 graph (ref: Stage1_source/model.py:51-57
    loads it via esm.pretrained).
    """

    num_layers: int = 33
    embed_dim: int = 1280
    attention_heads: int = 20
    vocab_size: int = 33
    token_dropout: bool = True
    pad_idx: int = 1
    mask_idx: int = 32
    cls_idx: int = 0
    eos_idx: int = 2
    max_len: int = 1024

    @property
    def ffn_dim(self) -> int:
        return 4 * self.embed_dim

    @property
    def head_dim(self) -> int:
        return self.embed_dim // self.attention_heads


@dataclasses.dataclass(frozen=True)
class BertConfig:
    """BERT encoder + MLM head (reference text tower: PubMedBERT-base).

    ref: Stage1_source/model.py:91-99 (BertForMaskedLM.from_pretrained).
    """

    num_layers: int = 12
    hidden_size: int = 768
    num_heads: int = 12
    intermediate_size: int = 3072
    vocab_size: int = 30522
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    pad_token_id: int = 0
    # HF BertConfig hidden_dropout_prob / attention_probs_dropout_prob
    # (PubMedBERT-base ships 0.1/0.1); active only in train mode
    # (``deterministic=False``) — the reference fine-tunes the tower through
    # Lightning train mode, so these fire there (Stage1_source/model.py:91-99)
    hidden_dropout: float = 0.1
    attn_probs_dropout: float = 0.1


@dataclasses.dataclass(frozen=True)
class PenCLConfig:
    """Stage-1 PenCL dual-tower model (ref: Stage1_source/model.py:178-239)."""

    esm: ESM2Config = dataclasses.field(default_factory=ESM2Config)
    bert: BertConfig = dataclasses.field(default_factory=BertConfig)
    protein_embedding: int = 1280   # protein_encoder_embedding
    text_embedding: int = 768       # text_encoder_embedding
    proj_dim: int = 512             # proj_embedding_dim
    dropout: float = 0.1
    temperature: float = 0.8
    rep_layer: int = 33
    text_max_length: int = 512
    seq_max_length: int = 1024

    @classmethod
    def from_stage_config(cls, cfg: Config) -> "PenCLConfig":
        protein_embedding = cfg.int("protein_encoder_embedding", 1280)
        text_embedding = cfg.int("text_encoder_embedding", 768)
        # tower architectures default to the published ESM2-650M/PubMedBERT;
        # optional esm_*/bert_* keys (framework extension) scale them.
        esm = ESM2Config(
            num_layers=cfg.int("esm_num_layers", 33),
            embed_dim=protein_embedding,
            attention_heads=cfg.int("esm_attention_heads", 20),
        )
        bert = BertConfig(
            num_layers=cfg.int("bert_num_layers", 12),
            hidden_size=text_embedding,
            num_heads=cfg.int("bert_num_heads", 12),
            intermediate_size=cfg.int("bert_intermediate_size", 4 * text_embedding),
            vocab_size=cfg.int("bert_vocab_size", 30522),
            max_position_embeddings=cfg.int("bert_max_position_embeddings", 512),
        )
        return cls(
            esm=esm,
            bert=bert,
            protein_embedding=protein_embedding,
            text_embedding=text_embedding,
            proj_dim=cfg.int("proj_embedding_dim", 512),
            dropout=cfg.float("dropout", 0.1),
            temperature=cfg.float("temperature", 0.8),
            rep_layer=cfg.int("rep_layer", 33),
            text_max_length=cfg.int("text_max_length", 512),
        )


@dataclasses.dataclass(frozen=True)
class FacilitatorConfig:
    """Stage-2 Facilitator MLP (ref: Stage1_source/model.py:473-493)."""

    in_dim: int = 512
    hid_dim: int = 1024
    out_dim: int = 512
    dropout: float = 0.0

    @classmethod
    def from_stage_config(cls, cfg: Config) -> "FacilitatorConfig":
        emb = cfg.int("emb_dim", 512)
        return cls(
            in_dim=emb,
            hid_dim=cfg.int("hid_dim", 1024),
            out_dim=emb,
            dropout=cfg.float("dropout", 0.0),
        )


@dataclasses.dataclass(frozen=True)
class ProteoScribeConfig:
    """Stage-3 conditional diffusion transformer.

    ref: Stage3_source/cond_diff_transformer_layer.py:47-176 (graph) and
    get_model:198-256 (hyperparameter wiring from the JSON config).
    """

    num_classes: int = 29          # vocab incl. absorbing state (input_dim/output_dim)
    dim: int = 512                 # transformer_dim
    depth: int = 16                # transformer_depth
    n_blocks: int = 1              # transformer_blocks
    heads: int = 16                # transformer_heads
    local_heads: int = 8           # transformer_local_heads
    local_window: int = 128        # transformer_local_size
    max_seq_len: int = 1024        # diffusion_steps == context window
    num_timesteps: int = 1024      # diffusion_steps
    cond_dim: int = 512            # text_emb_dim (z_c dimension)
    ff_mult: int = 4
    rescale_steps: float = 4000.0  # SinusoidalPosEmb rescale (ref :10-42)
    # Dropout knobs matching the reference's get_model wiring
    # (cond_diff_transformer_layer.py:234-237): attn_layer_dropout comes from
    # ``input_dp_rate`` (applied right after the attention output projection),
    # ff_dropout/attn_dropout are hardcoded 0 there.  NOTE the config key
    # ``transformer_dropout`` (stage3_config.json:57) is DEAD in the
    # reference — get_model never reads args.transformer_dropout (it only
    # appears as an argparse default, :193); we reproduce the real wiring.
    attn_layer_dropout: float = 0.0  # input_dp_rate (stage3_config.json:54)
    ff_dropout: float = 0.0          # hardcoded 0 at :235

    def __post_init__(self):
        """Shape guards (the reference only asserts window divisibility,
        cond_diff_transformer_layer.py:79; head divisibility fails deep
        inside a reshape there — fail loudly here instead)."""
        if self.dim % self.heads != 0:
            raise ValueError(
                f"dim {self.dim} not divisible by heads {self.heads}"
            )
        if not 0 <= self.local_heads <= self.heads:
            raise ValueError(
                f"local_heads {self.local_heads} outside [0, {self.heads}]"
            )
        if self.local_heads > 0 and self.max_seq_len % self.local_window != 0:
            raise ValueError(
                f"max_seq_len {self.max_seq_len} not divisible by "
                f"local_window {self.local_window}"
            )

    @property
    def head_dim(self) -> int:
        return self.dim // self.heads

    @property
    def global_heads(self) -> int:
        return self.heads - self.local_heads

    @classmethod
    def from_stage_config(cls, cfg: Config) -> "ProteoScribeConfig":
        steps = cfg.int("diffusion_steps", 1024)
        # Guard the lucidrains kwargs that would activate branches this
        # framework intentionally does not reproduce (PARITY.md "pinned
        # package settings").  ``get_model`` exposes exactly two of them to
        # the config: reversible nets (cond_diff_transformer_layer.py:245 ←
        # stage3_config.json:58; remat is the counterpart) — any
        # other lucidrains knob (ff_chunks/ff_glu/blindspot_size/
        # attend_axially/linformer) is hardcoded to its no-op default there.
        if cfg.get("transformer_reversible", False):
            raise ValueError(
                "transformer_reversible=true requests Reformer-style "
                "reversible layers; use ProteoScribe(remat=True) "
                "(activation checkpointing) instead"
            )
        return cls(
            num_classes=cfg.int("num_classes", 29),
            dim=cfg.int("transformer_dim", 512),
            depth=cfg.int("transformer_depth", 16),
            n_blocks=cfg.int("transformer_blocks", 1),
            heads=cfg.int("transformer_heads", 16),
            local_heads=cfg.int("transformer_local_heads", 8),
            local_window=cfg.int("transformer_local_size", 128),
            max_seq_len=steps,
            num_timesteps=steps,
            cond_dim=cfg.int("text_emb_dim", 512),
            attn_layer_dropout=cfg.float("input_dp_rate", 0.0),
        )

"""Stage-3 data pipeline: protein sequences + conditioning embeddings.

The port's copy of ``biom3_tpu/data/stage3_data.py:20-83``, itself a port of ``Stage3_source/preprocess.py:55-200`` (``pad_ends``,
``create_num_seqs``, ``prepare_protein_data``, ``protein_dataset``) and the
dict-merging logic of ``PFamDataModule`` (``Stage3_source/PL_wrapper.py:
337-433``), vectorized on the host: strip gaps, wrap with <START>/<END>,
filter by context length, pad with '-', encode with the 28-token training
vocab; conditioning vectors selected by the ``facilitator`` key
(MSE/MMD → 'text_to_protein_embedding', Default → 'text_embedding').
"""

from __future__ import annotations

import numpy as np

from biom3_tpu_torch.config import Config
from biom3_tpu_torch.tokenizers import stage3_batch_encode


def prepare_protein_data(args: Config, data_dict: dict) -> tuple[np.ndarray, np.ndarray]:
    """→ (tokens (N, L) int32 train-vocab ids, text_emb (N, D) f32)."""
    max_seq_len = args.int("diffusion_steps", 1024)
    pad_to = args.int("image_size", 32) ** 2

    raw = [s.replace("-", "") for s in data_dict[args.get("sequence_keyname", "sequence")]]
    valid = [i for i, s in enumerate(raw) if len(s) + 2 <= max_seq_len]

    facilitator = args.get("facilitator", "MMD")
    if facilitator in ("MSE", "MMD"):
        emb = data_dict["text_to_protein_embedding"]
    elif facilitator == "Default":
        emb = data_dict["text_embedding"]
    else:
        raise ValueError(f"Unexpected value for 'facilitator': {facilitator}")

    tokens = stage3_batch_encode([raw[i] for i in valid], pad_to)
    emb = np.stack([np.asarray(emb[i], np.float32) for i in valid])
    return tokens.astype(np.int32), emb


def merge_data_dicts(dict1: dict, dict2: dict) -> dict:
    """SwissProt + Pfam dict merge (ref PL_wrapper.py:399-417)."""
    merged = {}
    for key in set(dict1) | set(dict2):
        values = []
        for d in (dict1, dict2):
            if key in d:
                v = d[key]
                values.extend(v if isinstance(v, list) else [v])
        merged[key] = values
    return merged


class Stage3Dataset:
    """Indexable (tokens, z_c) pairs with train/val split."""

    def __init__(
        self,
        tokens: np.ndarray,
        text_emb: np.ndarray,
        *,
        valid_size: float = 0.1,
        seed: int = 42,
    ):
        if len(tokens) != len(text_emb):
            raise ValueError(f"{len(tokens)} token rows but {len(text_emb)} embeddings")
        rng = np.random.default_rng(seed)
        perm = rng.permutation(len(tokens))
        n_val = int(round(len(tokens) * valid_size))
        self.val_idx = perm[:n_val]
        self.train_idx = perm[n_val:]
        self.tokens = tokens
        self.text_emb = text_emb

    def split(self, which: str) -> tuple[np.ndarray, np.ndarray]:
        idx = self.train_idx if which == "train" else self.val_idx
        return self.tokens[idx], self.text_emb[idx]

    def __len__(self) -> int:
        return len(self.tokens)

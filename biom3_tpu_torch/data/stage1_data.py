"""Stage-1 data pipeline: paired text/protein tokenization + MLM masking.

The port's copy of ``biom3_tpu/data/stage1_data.py`` (``mask_tokens``,
``TextSeqPairingDataset``; ref ``Stage1_source/preprocess.py:25-108``):
BERT wordpiece ids padded to ``text_max_length``, ESM ids padded to 1024
with pad id 1, and the BERT-style MLM corruption of 15 % of the non-special
positions (80 % ``<mask>``, 10 % a random token, 10 % unchanged).  The
reference's loss scores only the positions that hold the mask token in the
corrupted input.

The CSV is read with Python's ``csv`` module into a table of columns
(``read_csv``), where the JAX package uses pandas; the dataset takes any
mapping of column name → sequence of values, a pandas frame included.
"""

from __future__ import annotations

import csv

import numpy as np

from biom3_tpu_torch.config import Config
from biom3_tpu_torch.tokenizers.esm_alphabet import ESMAlphabet

MAX_RESIDUES = 1022  # the ESM tower's 1024 positions less <cls> and <eos>


def mask_tokens(tokens: np.ndarray, mask_token_id: int, special_ids: tuple, *,
                mask_prob: float = 0.15, mask_frac: float = 0.8, random_frac: float = 0.1,
                random_ids: np.ndarray | None = None,
                rng: np.random.Generator | None = None) -> np.ndarray:
    """BERT-style corruption of ``mask_prob`` of the non-special positions:
    ``mask_frac`` of them become ``mask_token_id``, ``random_frac`` a
    uniform draw from ``random_ids``, the rest stay.  ``random_ids=None``
    disables the random bucket (those positions are masked instead)."""
    rng = rng or np.random.default_rng(0)
    special = np.isin(tokens, np.asarray(special_ids))
    selected = (rng.random(tokens.shape) < mask_prob) & ~special
    u = rng.random(tokens.shape)
    if random_ids is None:
        random_frac = 0.0
    to_mask = selected & (u < mask_frac)
    to_random = selected & (u >= mask_frac) & (u < mask_frac + random_frac)
    out = tokens.copy()
    out[to_mask] = mask_token_id
    if random_ids is not None:
        out[to_random] = rng.choice(np.asarray(random_ids), size=int(to_random.sum()))
    return out


def read_csv(path) -> dict[str, list[str]]:
    """A CSV with a header row → {column: [values]}."""
    with open(path, newline="") as f:
        reader = csv.DictReader(f)
        table: dict[str, list[str]] = {name: [] for name in reader.fieldnames or []}
        for row in reader:
            for name, values in table.items():
                values.append(row[name])
    return table


class TextSeqPairingDataset:
    """Batched host tokenization of (caption, sequence) pairs."""

    def __init__(self, args: Config, table, text_tokenizer=None):
        self.sequences = list(table[args.get("sequence_keyword", "protein_sequence")])
        self.captions = list(table["[final]text_caption"])
        self.accessions = list(table[args.get("id_keyword", "primary_Accession")])
        self.text_max_length = args.int("text_max_length", 512)
        self.seq_max_length = 1024
        self.alphabet = ESMAlphabet()
        if text_tokenizer is None:
            from biom3_tpu_torch.tokenizers.text import TextTokenizer

            text_tokenizer = TextTokenizer(args.text_model_path, max_length=self.text_max_length)
        self.text_tokenizer = text_tokenizer

    def __len__(self) -> int:
        return len(self.sequences)

    def get_batch(self, indices, *, with_masks: bool = False, rng=None) -> dict:
        """int32 numpy arrays: ``text_tokens``, ``text_attention_mask``,
        ``protein_tokens`` and, ``with_masks``, their corrupted copies
        ``text_tokens_masked``, ``protein_tokens_masked`` (drawn from ``rng``
        in that order)."""
        text = self.text_tokenizer.batch_encode([self.captions[i] for i in indices])
        protein = self.alphabet.batch_encode([self.sequences[i] for i in indices],
                                             pad_to=self.seq_max_length)
        batch = {"text_tokens": text["input_ids"], "text_attention_mask": text["attention_mask"],
                 "protein_tokens": protein}
        if with_masks:
            tok, ab = self.text_tokenizer.tokenizer, self.alphabet
            text_specials = tuple(tok.all_special_ids)
            text_random = np.setdiff1d(np.arange(tok.vocab_size), np.asarray(text_specials))
            # protein random bucket: the 20 standard amino acids
            aa_random = np.asarray([ab.get_idx(a) for a in "ACDEFGHIKLMNPQRSTVWY"], np.int32)
            batch["text_tokens_masked"] = mask_tokens(
                text["input_ids"], tok.mask_token_id, text_specials, random_ids=text_random,
                rng=rng)
            batch["protein_tokens_masked"] = mask_tokens(
                protein, ab.mask_idx, (ab.cls_idx, ab.padding_idx, ab.eos_idx),
                random_ids=aa_random, rng=rng)
        return batch

    @staticmethod
    def load_swissprot_csv(args: Config) -> dict[str, list]:
        """``args.data_path`` read, keeping the rows of at most 1022 residues
        (ref preprocess.py:156-164)."""
        table = read_csv(args.data_path)
        keep = [len(s) <= MAX_RESIDUES for s in table["protein_sequence"]]
        return {name: [v for v, k in zip(values, keep) if k] for name, values in table.items()}

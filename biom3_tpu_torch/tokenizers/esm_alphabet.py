"""ESM2 alphabet + batch conversion, reproducing fair-esm tokenization (the
port's copy of ``biom3_tpu/tokenizers/esm_alphabet.py``, plus
``esm_batch_encode``).

The reference tokenizes proteins with fair-esm's ``Alphabet.get_batch_converter()``
and then right-pads to 1024 with token id 1 (= ``<pad>``), see
``Stage1_source/preprocess.py:63-82``.  This module reproduces that behavior
(including unk mapping and BOS/EOS placement) without the fair-esm dependency.

The token table is the public ESM2 alphabet (33 entries):
index 0..3   : <cls> <pad> <eos> <unk>
index 4..30  : L A G V S E R T I D P K Q N F Y M H W C X B U Z O . -
index 31..32 : <null_1> <mask>
"""

from __future__ import annotations

import numpy as np

_PROTEINSEQ_TOKS = [
    "L", "A", "G", "V", "S", "E", "R", "T", "I", "D", "P", "K", "Q", "N",
    "F", "Y", "M", "H", "W", "C", "X", "B", "U", "Z", "O", ".", "-",
]


class ESMAlphabet:
    """ESM2-style alphabet with numpy batch encoding."""

    prepend_toks = ("<cls>", "<pad>", "<eos>", "<unk>")
    append_toks = ("<mask>",)

    def __init__(self) -> None:
        all_toks = list(self.prepend_toks) + list(_PROTEINSEQ_TOKS)
        # pad token table to a multiple of 8 (fair-esm convention) → <null_1>
        while (len(all_toks) % 8) != 0:
            all_toks.append(f"<null_{len(all_toks) - 30}>")
        all_toks += list(self.append_toks)
        self.all_toks = all_toks
        self.tok_to_idx = {tok: i for i, tok in enumerate(all_toks)}

        self.cls_idx = self.tok_to_idx["<cls>"]
        self.padding_idx = self.tok_to_idx["<pad>"]
        self.eos_idx = self.tok_to_idx["<eos>"]
        self.unk_idx = self.tok_to_idx["<unk>"]
        self.mask_idx = self.tok_to_idx["<mask>"]
        self.prepend_bos = True
        self.append_eos = True

    def __len__(self) -> int:
        return len(self.all_toks)

    def get_idx(self, tok: str) -> int:
        return self.tok_to_idx.get(tok, self.unk_idx)

    def encode(self, sequence: str) -> list[int]:
        """Per-character token ids (no BOS/EOS), unknown → <unk>."""
        return [self.get_idx(ch) for ch in sequence]

    def batch_encode(
        self,
        sequences: list[str],
        pad_to: int | None = None,
    ) -> np.ndarray:
        """Tokenize a batch: <cls> + seq + <eos>, right-padded with <pad>.

        With ``pad_to`` set this reproduces the reference's pad-to-1024
        pipeline exactly (batch_converter then concat of pad tokens,
        ref Stage1_source/preprocess.py:66-74).
        """
        encoded = [self.encode(seq) for seq in sequences]
        max_len = max((len(e) for e in encoded), default=0) + 2  # bos + eos
        if pad_to is not None and max_len > pad_to:
            over = max(len(e) for e in encoded)
            raise ValueError(
                f"sequence of length {over} does not fit pad_to={pad_to} - 2"
            )
        width = max(max_len, pad_to or 0)
        out = np.full((len(sequences), width), self.padding_idx, dtype=np.int32)
        for i, ids in enumerate(encoded):
            out[i, 0] = self.cls_idx
            out[i, 1 : 1 + len(ids)] = ids
            out[i, 1 + len(ids)] = self.eos_idx
        return out


def esm_batch_encode(sequences: list[str], pad_to: int) -> np.ndarray:
    """``ESMAlphabet().batch_encode(sequences, pad_to=pad_to)`` as numpy
    table lookups (the twin of the JAX package's native encoder,
    ``biom3_tpu/native.py:107-123``)."""
    alpha = ESMAlphabet()
    table = np.full(128, alpha.unk_idx, np.int32)
    for tok, i in alpha.tok_to_idx.items():
        if len(tok) == 1:
            table[ord(tok)] = i
    out = np.full((len(sequences), pad_to), alpha.padding_idx, np.int32)
    for r, seq in enumerate(sequences):
        if len(seq) + 2 > pad_to:
            raise ValueError(f"sequence of length {len(seq)} does not fit pad_to={pad_to} - 2")
        codes = np.frombuffer(seq.encode("utf-32-le"), np.uint32)
        ids = np.where(codes < 128, table[np.minimum(codes, 127)], alpha.unk_idx)
        out[r, 0], out[r, 1:len(seq) + 1], out[r, len(seq) + 1] = alpha.cls_idx, ids, alpha.eos_idx
    return out

"""Stage-3 (ProteoScribe) protein vocabularies (the port's copy of
``biom3_tpu/tokenizers/stage3_vocab.py``, plus ``stage3_batch_encode``).

The reference uses two deliberately mismatched token tables (SURVEY.md Q10):

  * the 28-entry *training* vocab (``Stage3_source/preprocess.py:82-84``):
    ``['<START>', A..Y, '<END>', '-', 'X', 'U', 'Z', 'B', 'O']``.  At train
    time all ids are shifted by +1 so id 0 is the absorbing (mask) state
    (``transformer_training_helper.py:199-203``).
  * the 29-entry *decode* table (``run_ProteoScribe_sample.py:88-92``):
    ``['-', '<START>', A..Y, '<END>', '<PAD>', 'X', 'U', 'Z', 'B', 'O']``,
    i.e. decode-index 0 ('-') is the absorbing state, and decode-index 23
    ('<PAD>') corresponds to the training pad character '-'.

We reproduce both tables exactly so that shifted training ids equal decode
indices for amino acids, and the pad character '-' (train id 22 → shifted 23)
decodes to '<PAD>'.
"""

from __future__ import annotations

import numpy as np

_AA = ["A", "C", "D", "E", "F", "G", "H", "I", "K", "L", "M",
       "N", "P", "Q", "R", "S", "T", "V", "W", "Y"]
_RARE = ["X", "U", "Z", "B", "O"]

# 28 tokens; training ids are shifted +1 before entering the model.
STAGE3_TRAIN_TOKENS: list[str] = ["<START>"] + _AA + ["<END>", "-"] + _RARE

# 29 tokens; index 0 is the absorbing/mask state.
STAGE3_DECODE_TOKENS: list[str] = (
    ["-", "<START>"] + _AA + ["<END>", "<PAD>"] + _RARE
)


class Stage3Vocab:
    """Encode/decode helpers for the Stage-3 diffusion model."""

    def __init__(self) -> None:
        self.train_tokens = list(STAGE3_TRAIN_TOKENS)
        self.decode_tokens = list(STAGE3_DECODE_TOKENS)
        self.train_tok_to_id = {t: i for i, t in enumerate(self.train_tokens)}
        self.num_classes = len(self.decode_tokens)  # 29, incl. absorbing state
        self.absorbing_id = 0
        self.pad_decode_id = self.decode_tokens.index("<PAD>")  # 23

    # --- encoding (training-side) -----------------------------------------
    def encode_sequence(self, sequence: str, pad_to: int) -> np.ndarray:
        """'<START>' + residues + '<END>', '-'-padded to ``pad_to``; train ids.

        Mirrors ``prepare_protein_data`` (Stage3_source/preprocess.py:94-146):
        gaps stripped by the caller, length filter done by the caller.
        """
        toks = ["<START>"] + list(sequence) + ["<END>"]
        if len(toks) > pad_to:
            raise ValueError(f"sequence too long: {len(toks)} > {pad_to}")
        toks += ["-"] * (pad_to - len(toks))
        return np.asarray([self.train_tok_to_id[t] for t in toks], dtype=np.int32)

    def batch_encode(self, sequences: list[str], pad_to: int) -> np.ndarray:
        return np.stack([self.encode_sequence(s, pad_to) for s in sequences])

    def shift_for_model(self, train_ids: np.ndarray) -> np.ndarray:
        """+1 shift making room for the absorbing state at id 0
        (ref transformer_training_helper.py:187-208)."""
        return train_ids + 1

    def encode_partial(
        self, sequence: str, pad_to: int, unknown: str = "?"
    ) -> np.ndarray:
        """Partial sequence → model-ready (decode-table) ids with the
        absorbing state (0) at ``unknown`` positions.

        Inpainting entry: known residues, the '<START>'/'<END>' markers and
        the '-' padding are committed (decode ids = shifted train ids);
        each ``unknown`` character becomes id 0 for the denoiser to fill.
        The sequence length is fixed by the input — markers and padding
        are never regenerated.
        """
        if len(unknown) != 1 or unknown in self.train_tok_to_id:
            raise ValueError(
                f"unknown marker must be a single non-vocabulary character, "
                f"got {unknown!r}"
            )
        toks = ["<START>"] + list(sequence) + ["<END>"]
        if len(toks) > pad_to:
            raise ValueError(f"sequence too long: {len(toks)} > {pad_to}")
        toks += ["-"] * (pad_to - len(toks))
        ids = np.empty(pad_to, dtype=np.int32)
        for i, t in enumerate(toks):
            if t == unknown:
                ids[i] = self.absorbing_id
            elif t in self.train_tok_to_id:
                ids[i] = self.train_tok_to_id[t] + 1
            else:
                raise ValueError(
                    f"invalid residue {t!r} at position {i - 1} "
                    f"(valid: amino acids, {unknown!r} for unknowns)"
                )
        return ids

    # --- decoding (sampling-side) ------------------------------------------
    def decode_ids(self, ids) -> str:
        """Model/decode-table ids → character string (ref animation_tools.py:7-11)."""
        return "".join(self.decode_tokens[int(i)] for i in ids)

    def clean_sequence(self, decoded: str) -> str:
        """Strip '<START>'/'<END>'/'<PAD>' markers (ref run_ProteoScribe_sample.py:123)."""
        return (
            decoded.replace("<START>", "").replace("<END>", "").replace("<PAD>", "")
        )


def stage3_batch_encode(sequences: list[str], pad_to: int) -> np.ndarray:
    """(N, pad_to) int32 training ids of ``sequences`` with gaps stripped:
    ``Stage3Vocab.batch_encode`` as one numpy table lookup (the twin of the
    JAX package's native encoder, ``biom3_tpu/native.py:126-146``)."""
    vocab = Stage3Vocab()
    table = np.full(128, -1, np.int32)
    for tok, i in vocab.train_tok_to_id.items():
        if len(tok) == 1:
            table[ord(tok)] = i
    start, end, pad = (vocab.train_tok_to_id[t] for t in ("<START>", "<END>", "-"))
    out = np.full((len(sequences), pad_to), pad, np.int32)
    for r, seq in enumerate(sequences):
        seq = seq.replace("-", "")
        if len(seq) + 2 > pad_to:
            raise ValueError(f"sequence {r} does not fit in {pad_to}")
        codes = np.frombuffer(seq.encode("utf-32-le"), np.uint32)
        ids = table[np.minimum(codes, 127)]
        if (codes > 127).any() or (ids < 0).any():
            raise ValueError(f"sequence {r} contains out-of-vocab characters")
        out[r, 0], out[r, 1:len(seq) + 1], out[r, len(seq) + 1] = start, ids, end
    return out

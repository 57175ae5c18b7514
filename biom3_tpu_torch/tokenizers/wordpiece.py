"""Self-contained BERT wordpiece tokenizer (no ``transformers`` runtime).

The port's copy of ``biom3_tpu/tokenizers/wordpiece.py`` without its C++
fast path.  The reference tokenizes captions with HF ``AutoTokenizer``
over the PubMedBERT-uncased wordpiece vocab, pad-to-max-length 512
(``Stage1_source/preprocess.py:45-61``).  This reimplements the BERT
tokenization algorithm (Devlin et al. 2019; WordPiece greedy
longest-match-first) over a local ``vocab.txt``:

  1. *basic* pass — unicode cleanup, CJK-char isolation, optional
     lowercase + accent stripping (NFD, drop Mn), punctuation splitting;
  2. *wordpiece* pass — greedy longest-prefix match with ``##``
     continuation pieces, whole-word ``[UNK]`` on any miss or >100 chars.
"""

from __future__ import annotations

import pathlib
import unicodedata

import numpy as np

_SPECIALS = ("[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]")
_MAX_WORD_CHARS = 100  # HF BertTokenizer's max_input_chars_per_word


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII blocks treated as punctuation even when unicode says otherwise
    # (e.g. "$", "`", "^" are S* categories but BERT splits on them)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (
        123 <= cp <= 126
    ):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class WordPieceTokenizer:
    """Drop-in host-side twin of ``BertTokenizer`` for a local vocab.

    ``path`` is a tokenizer directory (``vocab.txt`` inside) or the
    ``vocab.txt`` file itself.  ``do_lower_case=True`` matches the
    PubMedBERT-*uncased* tower the reference ships.
    """

    def __init__(self, path, *, do_lower_case: bool = True,
                 max_length: int = 512):
        p = pathlib.Path(path)
        vocab_file = p / "vocab.txt" if p.is_dir() else p
        self.vocab: dict[str, int] = {}
        with open(vocab_file, encoding="utf-8") as fh:
            for i, line in enumerate(fh):
                tok = line.rstrip("\n")
                if tok:
                    self.vocab[tok] = i
        missing = [s for s in _SPECIALS if s not in self.vocab]
        if missing:
            raise ValueError(f"vocab.txt lacks special tokens: {missing}")
        self.do_lower_case = do_lower_case
        self.max_length = max_length
        self.pad_token_id = self.vocab["[PAD]"]
        self.unk_token_id = self.vocab["[UNK]"]
        self.cls_token_id = self.vocab["[CLS]"]
        self.sep_token_id = self.vocab["[SEP]"]
        self.mask_token_id = self.vocab["[MASK]"]
        self.all_special_ids = [self.vocab[s] for s in _SPECIALS]
        self.all_special_tokens = list(_SPECIALS)
        self._never_split = set(_SPECIALS)

    @property
    def vocab_size(self) -> int:
        return len(self.vocab)

    # ---- basic pass -----------------------------------------------------

    def _clean(self, text: str) -> str:
        out = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            out.append(" " if _is_whitespace(ch) else ch)
        return "".join(out)

    def _isolate_cjk(self, text: str) -> str:
        out = []
        for ch in text:
            if _is_cjk(ord(ch)):
                out.extend((" ", ch, " "))
            else:
                out.append(ch)
        return "".join(out)

    def _strip_accents(self, text: str) -> str:
        return "".join(
            ch for ch in unicodedata.normalize("NFD", text)
            if unicodedata.category(ch) != "Mn"
        )

    def _split_punct(self, token: str) -> list[str]:
        if token in self._never_split:
            return [token]
        pieces, cur = [], []
        for ch in token:
            if _is_punctuation(ch):
                if cur:
                    pieces.append("".join(cur))
                    cur = []
                pieces.append(ch)
            else:
                cur.append(ch)
        if cur:
            pieces.append("".join(cur))
        return pieces

    def _basic_tokenize(self, text: str) -> list[str]:
        text = self._isolate_cjk(self._clean(text))
        out = []
        for tok in text.split():
            if tok not in self._never_split and self.do_lower_case:
                tok = self._strip_accents(tok.lower())
            out.extend(self._split_punct(tok))
        return out

    # ---- wordpiece pass -------------------------------------------------

    def _wordpiece(self, word: str) -> list[str]:
        if len(word) > _MAX_WORD_CHARS:
            return ["[UNK]"]
        pieces, start, n = [], 0, len(word)
        while start < n:
            end = n
            cur = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    cur = sub
                    break
                end -= 1
            if cur is None:
                return ["[UNK]"]
            pieces.append(cur)
            start = end
        return pieces

    def tokenize(self, text: str) -> list[str]:
        out = []
        # HF splits special-token literals ANYWHERE in the text first (its
        # added-tokens trie), before the basic pass — "x[MASK]y" →
        # ["x", "[MASK]", "y"]
        for seg in self._split_specials(text):
            if seg in self._never_split:
                out.append(seg)
                continue
            for tok in self._basic_tokenize(seg):
                if tok in self._never_split:
                    out.append(tok)
                else:
                    out.extend(self._wordpiece(tok))
        return out

    def _split_specials(self, text: str) -> list[str]:
        segs = [text]
        for sp in _SPECIALS:  # fixed order (the literals never overlap)
            nxt = []
            for seg in segs:
                if seg in self._never_split:
                    nxt.append(seg)
                    continue
                parts = seg.split(sp)
                for i, part in enumerate(parts):
                    if i:
                        nxt.append(sp)
                    if part:
                        nxt.append(part)
            segs = nxt
        return segs

    # ---- encoding -------------------------------------------------------

    def encode(self, text: str) -> list[int]:
        """[CLS] pieces[:max-2] [SEP] — HF single-sequence truncation."""
        ids = [self.vocab[t] for t in self.tokenize(text)]
        ids = ids[: self.max_length - 2]
        return [self.cls_token_id] + ids + [self.sep_token_id]

    def batch_encode(self, captions: list[str]) -> dict:
        """→ {"input_ids": (B, max_length) int32, "attention_mask": ...} —
        same contract as ``TextTokenizer.batch_encode``."""
        B, L = len(captions), self.max_length
        input_ids = np.full((B, L), self.pad_token_id, np.int32)
        attention_mask = np.zeros((B, L), np.int32)
        for i, text in enumerate(captions):
            ids = self.encode(text)
            input_ids[i, : len(ids)] = ids
            attention_mask[i, : len(ids)] = 1
        return {"input_ids": input_ids, "attention_mask": attention_mask}

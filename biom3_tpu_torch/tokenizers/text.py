"""Text (wordpiece) tokenizer for the PubMedBERT tower.

The port's copy of ``biom3_tpu/tokenizers/text.py``, trimmed to the path
the port uses: the self-contained ``WordPieceTokenizer`` over a local
``vocab.txt`` (no ``transformers`` runtime), pad-to-max-length as the
reference's ``AutoTokenizer`` call (``Stage1_source/preprocess.py:45-61``).
"""

from __future__ import annotations

import json
import pathlib

from biom3_tpu_torch.tokenizers.wordpiece import WordPieceTokenizer


def _read_do_lower_case(model_path: str) -> bool:
    cfg = pathlib.Path(model_path) / "tokenizer_config.json"
    if cfg.is_file():
        try:
            return bool(json.loads(cfg.read_text()).get("do_lower_case", True))
        except (ValueError, OSError):
            pass
    return True  # PubMedBERT-uncased default


class TextTokenizer:
    def __init__(self, model_path: str, max_length: int = 512):
        if not (pathlib.Path(model_path) / "vocab.txt").is_file():
            raise FileNotFoundError(f"no vocab.txt in {model_path}")
        self.tokenizer = WordPieceTokenizer(
            model_path, do_lower_case=_read_do_lower_case(model_path), max_length=max_length)
        self.max_length = max_length

    @property
    def mask_token_id(self) -> int:
        return self.tokenizer.mask_token_id

    def batch_encode(self, captions: list[str]) -> dict:
        """→ {"input_ids": (B, max_length) int32, "attention_mask": ...}."""
        return self.tokenizer.batch_encode(captions)

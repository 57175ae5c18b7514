"""Synthetic PubMedBERT-style wordpiece tokenizer directory (the port's
copy of ``biom3_tpu/tokenizers/synthetic.py::write_synthetic_wordpiece``).

The published text tower tokenizes with HF ``AutoTokenizer`` over the
PubMedBERT wordpiece vocab (Stage1_source/preprocess.py:45-61), whose
files are not downloadable in this sandbox.  This builder writes a
minimal-but-valid ``BertTokenizer`` directory (same specials, lowercase
letters + ##pieces + a few biology words) so every Stage-1 text surface —
CLI subprocess tests, the serving daemon, on-chip serving benches — runs
end-to-end without downloads.  Dims/config stay whatever the caller sets;
only the embedding-table vocab shrinks.
"""

from __future__ import annotations

import json
import pathlib


def write_synthetic_wordpiece(dirpath) -> int:
    """Write vocab.txt + tokenizer_config.json; returns the vocab size."""
    dirpath = pathlib.Path(dirpath)
    specials = ["[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    letters = [chr(c) for c in range(ord("a"), ord("z") + 1)]
    pieces = ["##" + ch for ch in letters]
    words = ["protein", "enzyme", "binding", "membrane", "kinase", "the",
             "a", "of", "with", "activity", "catalyzes", "transport"]
    vocab = specials + letters + pieces + words
    dirpath.mkdir(parents=True, exist_ok=True)
    (dirpath / "vocab.txt").write_text("\n".join(vocab) + "\n")
    (dirpath / "tokenizer_config.json").write_text(json.dumps({
        "tokenizer_class": "BertTokenizer", "do_lower_case": True,
        "model_max_length": 512,
    }))
    return len(vocab)

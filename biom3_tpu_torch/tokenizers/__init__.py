"""The port's tokenizers: its own copies of the JAX package's.

Wordpiece captions (``TextTokenizer``), the Stage-3 vocabularies
(``Stage3Vocab``, ``stage3_batch_encode``), the ESM protein encoder padded
to a fixed length (``esm_batch_encode``) and the synthetic wordpiece vocab
used when no PubMedBERT ``vocab.txt`` is at hand.  The batch encoders are
numpy twins of the JAX package's C++ host library, which is not copied.
"""

from biom3_tpu_torch.tokenizers.esm_alphabet import ESMAlphabet, esm_batch_encode
from biom3_tpu_torch.tokenizers.stage3_vocab import (
    STAGE3_DECODE_TOKENS,
    STAGE3_TRAIN_TOKENS,
    Stage3Vocab,
    stage3_batch_encode,
)
from biom3_tpu_torch.tokenizers.synthetic import write_synthetic_wordpiece
from biom3_tpu_torch.tokenizers.text import TextTokenizer

__all__ = [
    "ESMAlphabet", "STAGE3_DECODE_TOKENS", "STAGE3_TRAIN_TOKENS", "Stage3Vocab", "TextTokenizer",
    "esm_batch_encode", "stage3_batch_encode", "write_synthetic_wordpiece",
]

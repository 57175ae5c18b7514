"""The port's tokenizers: the JAX package's pure-Python ones, imported.

Wordpiece captions (``TextTokenizer``), the 29-token Stage-3 decode table
(``Stage3Vocab``), the ESM protein encoder padded to a fixed length
(``esm_batch_encode``: the C++ host library, or its identical Python
twin when no compiler is at hand) and the synthetic wordpiece vocab used
when no PubMedBERT ``vocab.txt`` is at hand.  None of them loads JAX.
"""

from biom3_tpu.native import esm_batch_encode  # noqa: F401
from biom3_tpu.tokenizers.stage3_vocab import Stage3Vocab  # noqa: F401
from biom3_tpu.tokenizers.synthetic import write_synthetic_wordpiece  # noqa: F401
from biom3_tpu.tokenizers.text import TextTokenizer  # noqa: F401

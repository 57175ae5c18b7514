"""PyTorch/CUDA port of biom3_tpu for one NVIDIA H100.

Imports ``torch`` and nothing of JAX or of the JAX package ``biom3_tpu``,
which stays the reference: what the port needs of its pure-Python modules
(config, tokenizers, torch file I/O, the demo data, the export mapping)
it keeps as its own copies, held equal to the originals by the tests.
Kernels are CUDA C++ for ``sm_90a`` under ``csrc/``, built on first use by
``ops/_build.py``.
"""

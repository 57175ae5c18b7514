"""PyTorch/CUDA port of biom3_tpu for one NVIDIA H100.

Imports ``torch`` and never ``jax``: the JAX package ``biom3_tpu`` stays the
reference, and its pure-numpy modules (config, tokenizers, native,
io.torch_load, io.export, cli.demo_data) are imported from there, not
copied.  Kernels are CUDA C++ for
``sm_90a`` under ``csrc/``, built on first use by ``ops/_build.py``.
"""

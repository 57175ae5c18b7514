"""The port's certification, parity and sweep tools, each run as ``python
-m biom3_tpu_torch.tools.<name>`` (on the card unless ``--device cpu``):
``certify_task`` (the class-conditioned copy task and its trainer),
``certify_int8``, ``certify_blocked`` and ``certify_inpaint`` (the
sampler-quality certification on that trained toy), ``parity_check`` (the
published-weights gates) and ``run_sweep`` (the bulk sweep with its QC
table).  Counterparts of the JAX package's ``tools/`` scripts of the same
names; they import the port only."""

#!/usr/bin/env python3
"""On-card smoke test of the PyTorch/CUDA port (``biom3_tpu_torch``).

Run from the repository root on a machine with one NVIDIA H100:

    python3 chip_smoke.py

Phases, one line each; any failure raises and the script exits non-zero:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions;
2. build the kernels from ``biom3_tpu_torch/csrc`` (seconds), then count
   the tensor-core and TMA instructions in each kernel's SASS
   (``cuobjdump -sass``; a ``[sass]`` line): ``gemm_bias_act``'s,
   ``gemm_dx``'s and ``gemm_dw``'s kernels must show HGMMA and
   ``gemm_i8``'s IGMMA, ``flash_attention``'s, ``dense_attention``'s,
   ``esm2_attention``'s, ``esm2_attention_bwd``'s two passes, the bf16
   ``local_window_attention``'s, ``stage3_attention_core``'s band heads'
   and ``stage3_attention_bwd``'s two band passes' HGMMA and
   ``stage3_attention_core_i8``'s band kernel IGMMA, all with UTMALDG
   loads, ``gather_head``'s HGMMA (its head product), and no kernel of the
   library may show HMMA (the ``mma.sync`` route); a ``[ptxas]`` line gives the attention kernels'
   (``stage3_attention_core``'s three, ``stage3_attention_bwd``'s band
   passes, ``stage3_attention_core_i8``'s pre-pass and band kernel), their
   staging launches' and the ``gemm_dx``/``gemm_dw``
   kernels' registers and spills (``nvcc -Xptxas -v``);
3. every kernel against its plain PyTorch version on the card at full
   width (Stage 3: L=1024, d=512, 8+8 heads, FF 2048; BERT: L=512, E=768,
   12 heads, FF 3072; ESM2-650M: L=1024, E=1280, 20 heads, FF 5120),
   timed at Stage-3 B=4 / BERT B=2 / ESM B=2 and checked also at the
   batches phase 5 gives them (2 replicas of 1 prompt), at phase 6's ESM
   batch (the 5 demo proteins) and on edge shapes (ragged tiles, ragged
   PAD tails, an all-PAD row; for the ESM2 and flash attention kernels
   also L = 1000 and 65, a 3-token protein, an all-PAD row at a ragged L
   and head dim 32; ``dense_attention`` at B = 1 and 16, L = 1, 65 and
   100, head dims 32 and 64; for the training kernels edge windows
   (``stage3_attention_bwd`` at W = 8, 16, 40, 64, 96 and 128, W = 40 also
   at L = 1000 and 200), local_heads 0 and = heads, head dim 64 (also at
   W = 32), ragged rows, ``gemm_dx`` also
   at M < 64 and at N = 5120 with both GELU derivatives and both output
   types; ``layernorm`` also on one f32 row at d = 1280 to an f32 output
   alone, on 37 f32 rows at d = 768 with the f32 copy, and past the
   1280 columns held in registers: d = 2560 (ESM2-3B, bf16), 4096 (a
   Stage-3 dim), a ragged 1288, a 16384-wide f32 row and a 60000-wide
   f32 row past one block's shared memory; ``bias_layernorm`` on 74 rows
   at d = 1280, 1288, 2560 and 4096 and on 6 rows at d = 120000 (past
   one block's shared memory); ``layernorm_bwd``
   on the same four widths (bf16 x at 2560, f32 x at 4096); ``col_sum`` on
   1 and 7 rows, a row count one past its slabs and 8 columns;
   ``gemm_dx``, ``gemm_dw``, ``layernorm``, ``bias_layernorm``,
   ``layernorm_bwd``, ``col_sum`` and ``stage3_attention_bwd`` must also
   give the same bits on a second call): bf16
   max|Δ|/max|ref| <= 2e-2 (the attention gradients per head group: 32
   columns for Stage 3, 64 for ESM2; the f32 sums of ``col_sum`` and
   ``layernorm_bwd``'s dγ, dβ <= 1e-3), with the kernel's, the plain version's and, where one exists,
   one PyTorch call's time, and the least time the card could take; the
   training kernels also at one ESM2-650M layer's backward (B=2, L=1024);
   The int8 serving recipe: ``gemm_i8`` at the three models' shapes (its
   library call ``torch._int_mm``, the int32 product only), ``quant_rows``
   on f32 and bf16 rows (edge widths 8, 2056 and 5120 f32, each with an
   all-zero row and a row whose max is its last column), whose codes and
   scales must equal the plain version's bit for bit, and
   ``local_window_attention`` (B=4, H=8, L=1024,
   D=32, bf16; edge cases one window, D=64, f32, and in bf16 W=32 (a
   warpgroup over two windows), W=96 (a key tile across the band's edge),
   W=64 at D=64 and L=1024, and B·H=1 with one window; library call SDPA
   with a boolean (L, L) band mask); then ``gemm_bias_act`` and ``gemm_i8`` at
   Stage-3 B=32 (M = 32768, a layer's four products; ``cli/measure_gemm.py``)
   against their plain versions, in TFLOP/s or TOP/s beside ``matmul`` /
   ``torch._int_mm`` and the bound, ``stage3_attention_core`` and
   ``stage3_attention_bwd`` there (per head group, the same bits on a
   second call, each time beside its bound), and ``bias_layernorm`` there (xb equal to h + bias, the same
   bits on a second call, its time beside the bound), ``gather_head`` on
   the full grid there (k = L: 32768 rows, the same bits on a second call,
   its time beside the plain version's and the bound; edge shapes in
   phase 3 off its 64-row tiles, d = 96 to 4096 and 5 to 32 classes),
   ``stage3_attention_core_i8`` there (the band heads' QKᵀ
   and PV in int8; its q, k, v codes and scales bit-equal to the plain
   version's, at Stage-3 B=4 and B=32 and on ``stage3_attention_core``'s
   edge shapes, the output per head group, the same bits on a second call,
   timed beside its bound and the bf16 core; its p codes, at B=4 and B=32,
   at most one step off the plain version's, and how many are), then
   the host µs of one wrapper call.  ``stage3_attention_core``
   is also checked at head dim 64, W = 32 and 8, no and all heads
   band-local, and L = 1000 and 200, and must give the same bits on a
   second call;
4. full-width ``fused_stack_logits`` on the kernels (bf16, tanh GELU)
   against the plain f32 ProteoScribe, the full-width BERT tower and
   ``fused_esm2_cls`` against the plain f32 towers, each also in int8
   (against its bf16 kernel chain and the plain f32 module), the PenCL graph
   path (bf16, the flash kernel) against the plain f32 PenCL, and
   ``ProteoScribe(attn_impl="kernel")`` in bf16 against the plain f32 module
   (the ``stage3_graph`` path): min cosine >= 0.999; ms per forward of the
   stack at B=2 and B=32 and of the towers, int8 against bf16;
5. the text→protein CLI (``biom3_tpu_torch.cli.run_e2e``) at full width on
   seeded random weights: 1 prompt, 2 replicas, exact mode (1024 denoise
   steps), at its default (int8 on the card), then with ``--ff-quant none
   --proj-quant none`` (Stage 3 in bf16, the ``e2e_bf16`` path), then the
   fast modes at the default, ``--sampler maskgit --maskgit_steps 16`` and
   ``--decode_order confidence --positions_per_step 8`` (the stack forward
   on the full grid: ``gather_head`` at k = L), then ``--inpaint_sequence``
   (a seeded 200-residue design with 40 '?': the confidence-order
   inpainter on the full grid, 128 forwards — the engine's chunk of 128
   positions, early exit after the first); checks the sequences (an
   inpainted design keeps every committed residue in place and has no '?'
   left), that the replicas differ, and that ``stage3_attention_core`` ran
   depth times and ``gather_head`` once a forward (1024, 16, 128 and 128
   forwards), and prints each run's wall time;
6. the PenCL CLI (``biom3_tpu_torch.cli.run_pencl_inference``) at full
   width on seeded random weights in the published ``.bin`` layout (LM,
   contact and MLM heads and buffers included): the 5 demo pairs at its
   default (int8); checks the latents and scores; then a ``PenCLEngine``
   with its four quant knobs at ``"none"`` (the bf16 tower chain,
   ``pencl_bf16``) and ``PenCLEngine(tower_impl="graph")`` on the same file,
   both built with ``dtype=torch.bfloat16``; on the bf16 engine also
   ``Stage1SweepRunner`` over 32 demo pairs in slabs of 16 (path
   ``sweep_stage1``, cosine 0.999 against ``embed``) (the engines' f32 default runs
   the PyTorch modules, as in the JAX package; the CLIs' ``--dtype auto``
   is bf16 on cuda); the published configs must take the kernel paths
   (``use_stack``, ``use_fused_stack``), here and in the serving phase;
   serving, at full width on phase 5's files: an in-process ``BioM3Server``
   (``rows_per_dispatch=4``, default flags: continuous, exact mode, int8,
   with ``--continuous_inpaint``)
   answers 3 concurrent requests x 2 replicas (one prompt twice, one seeded
   request twice: identical sequences), then ``--preset latency`` and
   ``--preset throughput`` (MaskGIT, 16 steps) through the trajectory
   scheduler (``/healthz``: ``continuous: false``; all three the ``serve``
   path), then the ``run_server`` CLI as a subprocess: one request,
   SIGTERM, exit code 0; seqs/s, p50 request latency and row occupancy on
   a line of their own; after each server's timed window one /v1/inpaint
   request (2 replicas, 40 unknowns; path ``serve_inpaint``) on its route —
   continuous inpaint rows (64 forwards), the packed confidence inpainter
   (chunk 16, early exit: 48), MaskGIT rows in generate dispatches (16) —
   and a bad sequence that must answer 400, with its wall time and
   ``inpaint_mode``; then the sample CLIs on phase 5's files:
   ``run_facilitator_sample`` (3 seeded z_t / z_p rows; no kernel, path
   ``facilitator_sample``) and ``run_proteoscribe_sample --sampler
   maskgit`` on its z_c (3 prompts x 2 replicas, path
   ``proteoscribe_sample``); then the generation sweep:
   ``pipeline/sweep.SweepRunner`` on the bf16 stack forward, 4 seeded z_c
   prompts x 8 replicas in one slab of 32, k = 8 (128 forwards, path
   ``sweep``), then with ``attn_quant="int8"`` (path ``sweep_i8``; one
   forward's logits within 0.999 cosine of the bf16 attention's), rows/s
   of each, then ``cli/run_eval.py`` as a subprocess on the int8 sweep's
   designs; then the device mesh (``biom3_tpu_torch/parallel``):
   ``make_mesh`` over the cards, then on (dp 2, fsdp 2) positions of one
   card the sharded stack forward at B=32 (k = 8; every shard's logits
   bit-equal to the one-device forward on its 8 rows, bf16 and int8 band
   attention), ``SweepRunner`` on that mesh (the sweep's 4 × 8 rows, path
   ``sweep_mesh``: ``stage3_attention_core`` shards × depth × forwards
   times), rows/s beside the one-device sweep's, an in-process
   ``BioM3Server`` on a dp-2 mesh (2 generate requests, path
   ``serve_mesh``, and one /v1/inpaint on continuous rows, path
   ``serve_mesh_inpaint``: 2 shards a forward), ``run_server --mesh_dp 2``
   as a subprocess where there are two cards (skipped on one), ring
   attention at ESM2-650M's head shapes (B 1, H 20, D 64, L 4096, 10 % PAD
   keys) over tp = 4 positions against ``flash_attention_plain`` within
   2e-2, and the 33-layer ESM2-650M with ``attn_impl="ring"`` against
   ``"plain"`` (f32, a 1022-residue protein) at cosine 0.999, both timed;
   then Stage-2 training: ``run_train_stage2`` on
   4096 seeded (z_t, z_p) pairs of width 512 (MMD, batch 64, 2 epochs,
   ``--export_bin``; the validation loss must fall), the exported .bin
   through ``run_facilitator_sample`` (path ``train_stage2``, no kernel),
   and ms a step of the train step at B=64;
7. Stage-3 training at full width on seeded weights: the loss and every
   parameter gradient of ``ProteoScribe(attn_impl="layer-block")``, then
   ``"block"``, in bf16 on the kernels against the plain f32 module (fixed
   paths and timesteps, PAD-tailed tokens, B=4); 40 ``layer_block`` train
   steps on one batch of 32 must cut the loss, and ms per step at B=32
   for ``layer_block``, ``block`` and ``unrolled`` with a profile of the
   first; then the training CLI (``biom3_tpu_torch.cli.run_train_stage3``)
   on a seeded synthetic data file: ``layer_block`` 4 steps with
   ``--export_bin``, ``--resume`` to 6, ``block`` 2 steps;
8. Stage-1 (PenCL) training at full width (ESM2-650M, PubMedBERT-base
   widths, projection heads to 512) on seeded weights: (a) the ``pfam``
   loss (all four terms) and every parameter gradient of ``PenCL(attn_impl=
   "layer-block")`` in bf16 on the kernels against the plain f32 module
   (dropout off, fixed masks, B=2 pairs, the projection heads' output
   LayerNorms seeded small so that the contrastive terms' gradient, which
   bf16 moves on torch ops too, is a small part of the whole); (b)
   ``STAGE1_STEPS`` train steps on one fixed batch of 4 full-length pairs
   must cut the loss and its MLM terms to 0.8x, with ms per step, peak memory and a profile for
   ``layer_block``, then 3 more ``layer_block`` steps each with Adafactor
   and with a bf16 AdamW first moment (finite losses, the optimizer
   state's size beside AdamW's), and ms per step for ``xla`` with ``--remat`` at B=4 and
   without it at B=1 (where its attention maps fit with room), beside
   ``layer_block`` at B=1; (c) the training CLI
   (``biom3_tpu_torch.cli.run_train_stage1``) on a seeded synthetic CSV:
   ``layer_block`` 3 steps with ``--export_bin``, ``--resume`` to 5, then
   ``run_pencl_inference --device cuda`` on the exported ``.bin``;
   (d) one ESM2-3B-width layer (E = 2560, 40 heads, FF 10240, B = 1, L =
   1024, a PAD tail): ``ESM2Layer(attn_impl="layer-block")`` in bf16 on the
   kernels (``layernorm`` and ``layernorm_bwd`` on their shared-memory
   routes) against the plain f32 layer, forward and backward, at phase
   8a's gates;
9. sharded training on a one-rank NCCL group (``tcp://localhost``, world
   size 1; NCCL takes one rank a card): ``make_sharded_stage3_train_step``
   (FSDP2 over the (dp, fsdp) mesh, ``layer_block``, bf16, AdamW, EMA) at
   full width, B=32, 3 steps, against ``make_stage3_train_step`` on the
   same seeded weights, batch and generator (path ``train_sharded``), then
   ``make_sharded_stage1_train_step`` (the gathered latents, the summed MLM
   terms) at full width, B=4 ``pfam`` pairs of 1022 residues, 2 steps,
   against the one-device Stage-1 step (path ``train_stage1_sharded``): the
   losses, the first step's gradients and the parameters' updates must
   agree (``SHARDED_REL_TOL``, ``SHARDED_UPDATE_TOL``), with the worst
   differences, ms per step of both and a profile (device ms, the host ms
   of the optimizer step and of FSDP2's hooks) printed beside the card's
   name and power limit;
10. tensor parallelism (tp 2) on the one card: ``stage3_attention_core``
   and ``stage3_attention_bwd`` at Stage-3 B=32 on each tp rank's 8 of 16
   heads (rank 0 all band-local, rank 1 all linear) and ``esm2_attention``
   / ``_bwd`` at ESM2-650M B=2 on 10 of 20 heads, each within ``REL_TOL``
   of its plain version and of the whole-head call's columns, timed beside
   the whole-head call; then two worker processes of this script
   (``--tp-worker``) in a gloo group over CUDA tensors (NCCL refuses two
   ranks on one card) run the sharded Stage-3 ``layer_block`` step (full
   width, B=32, 3 steps; path ``train_tp``) and the sharded Stage-1 step
   (ESM2-650M + PubMedBERT, B=4 pfam pairs, 2 steps; path
   ``train_stage1_tp``) at (dp 1, fsdp 1, tp 2) from phase 9's seeds, and
   rank 0 holds each against the one-device step (every loss term within
   ``TP_LOSS_TOL``, the first step's gradients within ``TP_GRAD_TOL``),
   with ms per step (no tp speed: the ranks share the card and sum through
   the host) and the ms of one all-reduce of a layer's size; last, each of
   the two ranks runs the per-rank ring body ``ring_attention_sharded`` on
   its half of L at ESM2-650M's heads (B 2, H 20, L 1024, D 64, f32, PAD
   tails) over their group, held within 2e-5 of plain full attention and of
   the one-process ``ring_attention``, with its ms a call;
11. the port's tools (``biom3_tpu_torch/tools``) in this process on the
   built kernels: ``certify_task.build_and_train`` trains the copy-task toy
   (dim 128, depth 4, 4 heads of 32 with 2 band-local, L 256) 600 steps at
   B=64 in bf16 ``layer_block`` (path ``certify_train``; the loss must end
   under 0.1), ``certify_int8`` on bf16, int8-ff and int8-ff+proj with
   temp-0 sampling at sample batch 64 (path ``certify_int8``: class
   accuracy >= 0.99 in each mode, int8-ff+proj logit min cosine >= 0.999),
   ``certify_blocked`` at k 1 and 8, temperatures 1.0 and 0.0, and
   ``certify_inpaint`` at revealed fraction 0.25, temperature 0 and MaskGIT
   16 (the committed positions never move) on the f32 module forward from
   the toy's state file, ``parity_check`` on small seeded checkpoints in the
   published layouts (every gate's verdict line, exit code 1), and
   ``run_sweep`` at 4 prompts x 2 replicas, batch 8, MaskGIT (its QC keys).

Each path (phase 4's graph-path ProteoScribe, the five runs of phase 5,
the three PenCL runs of phase 6 and the bulk embedding, the serving runs
and their inpaint requests, the sample CLIs, the two sweeps, the mesh's
sweep and server, Stage-2 training, the two training CLI modes
of phase 7, the Stage-1 training CLI runs and the inference CLI on their
``.bin`` in phase 8, the two sharded steps of phase 9, the two tp steps of
phase 10, both ranks' launches summed, and each tool of phase 11) runs with the launch counts
set to 0 just before it and read just after, and must have launched
exactly its own kernels.  The line before the last is the kernels' JSON record, with
each kernel's time, its plain version's, the least time the card could
take (``bound_ms``) and one PyTorch call's time where one computes the
same function (``library_ms``); the last is ``{"ok": true, "device":
{...}}``.  Imports nothing of JAX.
"""

from __future__ import annotations

import copy
import json
import pathlib
import re
import subprocess
import sys
import tempfile
import time

import numpy as np

REL_TOL = 2e-2     # bf16 kernel vs plain version, max|Δ| / max|ref|
SUM_TOL = 1e-3     # f32 column sums (col_sum, layernorm_bwd's dγ and dβ), the same
COS_MIN = 0.999    # drift gate of the serving modes (PARITY.md)
SEED = 0
TIMED_ITERS = 20   # calls per kernel timing
ESM_LAYERS, BERT_LAYERS = 33, 12
PEAK_FLOPS = 989e12   # H100 SXM dense bf16 (NVIDIA data sheet)
PEAK_INT8 = 1979e12   # H100 SXM dense int8 operations/s (NVIDIA data sheet)
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s
# phase 7 gates: bf16 training on the kernels vs the plain f32 module.  A
# tensor under TENSOR_COS_MIN passes only where the same module in bf16 on
# torch ops is under it too and the kernels stay within TENSOR_COS_SLACK of
# it: at seeded weights the linear heads' to_q gradients are small and
# bf16 rounding in the forward moves them as much on torch ops (PERF.md)
LOSS_REL_TOL, GRAD_COS_MIN, TENSOR_COS_MIN, TENSOR_COS_SLACK = 1e-2, 0.999, 0.99, 0.1
# phase 8a, the same gates.  A tensor whose f32 gradient norm is under
# ZERO_GRAD_REL of the whole gradient's is zero up to rounding (a BERT key
# bias), and its bf16 norm must stay under ZERO_GRAD_MAX of the whole's.
# Phase 8 seeds the projection heads' output LayerNorms small
# (``measure_stage1.seeded_stage1``): the seeded latents are nearly
# parallel, which bf16 resolves poorly in the contrastive terms' gradient,
# on torch ops as on the kernels; at the usual scale that gradient is most
# of the whole, at the small one a small part of it (PERF.md)
ZERO_GRAD_REL, ZERO_GRAD_MAX = 1e-6, 1e-4
TRAIN_STEPS, TRAIN_B, TRAIN_LR = 40, 32, 1e-3
# phase 8b: Stage-1 steps on one fixed batch of 4 pairs.  The mean of the
# last 3 steps' loss must be under step 1's, and that of the MLM terms at
# most STAGE1_MLM_FALL of step 1's: in 16 steps the seeded towers learn the
# masked tokens, while the contrastive terms stay at log 7 (PERF.md)
STAGE1_STEPS, STAGE1_LR, STAGE1_MLM_FALL = 16, 1e-3, 0.8
# phase 9: one rank runs the one-device step's arithmetic on FSDP2's
# gathered copies of the same weights.  Every loss term of every step, and
# the first step's gradients (max|Δg| over the model / its max|g|), within
# SHARDED_REL_TOL of the one-device step's: FSDP2 sums a weight's gradient
# over the three Stage-1 forwards in another order, and the BERT
# word-embedding gradient differs from call to call on the same inputs
# (3.8e-7, 3.8e-7, 8.3e-7 in three calls).  AdamW's first step takes the
# sign of a gradient near 0, so the parameters are held by their update:
# ||Δp − Δp_one|| / ||Δp_one|| over the model under SHARDED_UPDATE_TOL
# (Stage 1 read 1.6e-4, 3.8e-4 and 4.1e-4)
SHARDED_REL_TOL, SHARDED_UPDATE_TOL = 1e-5, 1e-2

# kernel → (source, TPU kernel it replaces)
KERNEL_SOURCES = {
    "gemm_bias_act": ("biom3_tpu_torch/csrc/gemm_bf16.cu",
                      "biom3_tpu/ops/pallas/stack_kernel_tpu.py:765"),
    "stage3_attention_core": ("biom3_tpu_torch/csrc/stage3_attn.cu",
                              "biom3_tpu/ops/pallas/fused_layer_tpu.py:186"),
    "stage3_attention_core_i8": ("biom3_tpu_torch/csrc/stage3_attn_i8.cu",
                                 "biom3_tpu/ops/pallas/stack_kernel_tpu.py:112"),
    "dense_attention": ("biom3_tpu_torch/csrc/dense_attn.cu",
                        "biom3_tpu/ops/pallas/bert_stack_tpu.py:198"),
    "bias_layernorm": ("biom3_tpu_torch/csrc/rowwise.cu",
                       "biom3_tpu/ops/pallas/fused_layer_tpu.py:186"),
    "layernorm": ("biom3_tpu_torch/csrc/rowwise.cu",
                  "biom3_tpu/ops/pallas/fused_layer_tpu.py:269"),
    "embed_tokens": ("biom3_tpu_torch/csrc/rowwise.cu",
                     "biom3_tpu/ops/pallas/stack_kernel_tpu.py:765"),
    "gather_head": ("biom3_tpu_torch/csrc/gather_head.cu",
                    "biom3_tpu/ops/pallas/stack_kernel_tpu.py:765"),
    "esm2_embed": ("biom3_tpu_torch/csrc/rowwise.cu",
                   "biom3_tpu/ops/pallas/esm2_stack_tpu.py:294"),
    "esm2_attention": ("biom3_tpu_torch/csrc/esm2_attn.cu",
                       "biom3_tpu/ops/pallas/esm2_stack_tpu.py:294"),
    "flash_attention": ("biom3_tpu_torch/csrc/flash_attn.cu",
                        "biom3_tpu/ops/pallas/flash_attention_tpu.py:69"),
    "stage3_attention_bwd": ("biom3_tpu_torch/csrc/stage3_attn_bwd.cu",
                             "biom3_tpu/ops/pallas/attn_block_tpu.py:379"),
    "gemm_dx": ("biom3_tpu_torch/csrc/gemm_bf16.cu",
                "biom3_tpu/ops/pallas/layer_block_tpu.py:419"),
    "gemm_dw": ("biom3_tpu_torch/csrc/gemm_bf16.cu",
                "biom3_tpu/ops/pallas/attn_block_tpu.py:379"),
    "layernorm_bwd": ("biom3_tpu_torch/csrc/rowwise.cu",
                      "biom3_tpu/ops/pallas/layer_block_tpu.py:419"),
    "col_sum": ("biom3_tpu_torch/csrc/rowwise.cu",
                "biom3_tpu/ops/pallas/layer_block_tpu.py:419"),
    "esm2_attention_bwd": ("biom3_tpu_torch/csrc/esm2_attn_bwd.cu",
                           "biom3_tpu/ops/pallas/esm2_block_tpu.py:411"),
    "gemm_i8": ("biom3_tpu_torch/csrc/gemm_i8.cu",
                "biom3_tpu/ops/pallas/stack_kernel_tpu.py:765"),
    "quant_rows": ("biom3_tpu_torch/csrc/rowwise.cu", "biom3_tpu/ops/pallas/quant.py:35"),
    "local_window_attention": ("biom3_tpu_torch/csrc/local_attn.cu",
                               "biom3_tpu/ops/pallas/local_attention_tpu.py:73"),
}
# kernel → its first output that must equal the plain version's bit for bit:
# quant_rows' codes and scales; the int8 attention's q, k, v codes and scales
BIT_EQUAL = {"quant_rows": 0, "stage3_attention_core_i8": 1}

# path → the kernels it launches, and no other
INT8 = {"gemm_i8", "quant_rows"}
STAGE3_INT8 = INT8 | {"stage3_attention_core", "bias_layernorm", "layernorm", "embed_tokens",
                      "gather_head"}
E2E_INT8 = STAGE3_INT8 | {"dense_attention"}
STAGE3_BF16 = {"gemm_bias_act", "stage3_attention_core", "bias_layernorm", "layernorm",
               "embed_tokens", "gather_head"}
PENCL_BF16 = {"gemm_bias_act", "dense_attention", "layernorm", "esm2_embed", "esm2_attention"}
PATH_KERNELS = {
    "e2e": E2E_INT8,
    # the fast modes: the stack forward on the full grid
    "e2e_maskgit": E2E_INT8,
    "e2e_confidence": E2E_INT8,
    # the confidence-order inpainter: the stack forward on the full grid
    "e2e_inpaint": E2E_INT8,
    # the sample CLIs: the Facilitator has no kernel; Stage 3 alone
    "facilitator_sample": set(),
    "proteoscribe_sample": STAGE3_INT8,
    # Stage 3 in bf16; the text tower stays at its engine's int8 default
    "e2e_bf16": E2E_INT8 | {"gemm_bias_act"},
    "serve": E2E_INT8,
    # one /v1/inpaint request on each route (a prompt not yet cached)
    "serve_inpaint": E2E_INT8,
    # the Facilitator's training: two F.linear products, no kernel
    "train_stage2": set(),
    "stage3_graph": {"local_window_attention"},
    "pencl": INT8 | {"dense_attention", "layernorm", "esm2_embed", "esm2_attention"},
    "pencl_bf16": PENCL_BF16,
    # the generation sweep on the bf16 stack forward, then with the band
    # heads' products in int8; the bulk embedding on the bf16 towers
    "sweep": STAGE3_BF16,
    "sweep_i8": STAGE3_BF16 - {"stage3_attention_core"} | {"stage3_attention_core_i8"},
    "sweep_stage1": PENCL_BF16,
    # the mesh phase: the sweep over 4 positions of one card, the mesh server
    "sweep_mesh": STAGE3_BF16,
    "serve_mesh": E2E_INT8,
    "serve_mesh_inpaint": E2E_INT8,
    "pencl_graph": {"flash_attention"},
    "train_layer_block": {"layernorm", "gemm_bias_act", "stage3_attention_core",
                          "stage3_attention_bwd", "gemm_dx", "gemm_dw", "col_sum",
                          "layernorm_bwd"},
    "train_block": {"gemm_bias_act", "stage3_attention_core", "stage3_attention_bwd",
                    "gemm_dx", "gemm_dw", "col_sum"},
    "train_stage1": {"layernorm", "gemm_bias_act", "esm2_attention", "esm2_attention_bwd",
                     "gemm_dx", "gemm_dw", "col_sum", "layernorm_bwd"},
}
# the sharded steps launch the one-device steps' kernels
PATH_KERNELS["train_sharded"] = PATH_KERNELS["train_layer_block"]
PATH_KERNELS["train_stage1_sharded"] = PATH_KERNELS["train_stage1"]
# so do the tp-2 steps, on each rank's shards
PATH_KERNELS["train_tp"] = PATH_KERNELS["train_layer_block"]
PATH_KERNELS["train_stage1_tp"] = PATH_KERNELS["train_stage1"]


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def rel_err(got, want, group: int = 0) -> tuple[float, float]:
    """(max|Δ|, max|Δ| / max|ref|) in f32; with ``group`` the relative
    error is the worst over groups of that many last-dim columns, each
    against its own max|ref| (a small head's gradient is not hidden by a
    large one's)."""
    got, want = got.float(), want.float()
    if not bool(got.isfinite().all()):
        raise AssertionError("kernel output has non-finite values")
    diff = float((got - want).abs().max())
    if not group:
        return diff, diff / max(float(want.abs().max()), 1e-30)
    g, w = got.reshape(-1, got.shape[-1] // group, group), want.reshape(-1, want.shape[-1] // group,
                                                                          group)
    rel = (g - w).abs().amax((0, 2)) / w.abs().amax((0, 2)).clamp(min=1e-30)
    return diff, float(rel.max())


def min_cosine(a, b) -> float:
    import torch

    return float(torch.nn.functional.cosine_similarity(a.float(), b.float(), dim=-1).min())


def flat(x) -> list:
    """The tensors of a kernel's (possibly nested) output tuple."""
    return [t for item in x for t in flat(item)] if isinstance(x, tuple) else [x]


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def band_pairs(B: int, L: int, window: int, heads: int) -> int:
    """(query, key) pairs of the band-local heads: each window's queries
    see windows w-1..w+1 that exist."""
    nw = L // window
    keys = sum(min(nw, w + 2) - max(0, w - 1) for w in range(nw)) * window
    return B * heads * window * keys


def live_keys(pad) -> int:
    """Σ over rows of one past the last non-PAD key (L for an all-PAD
    row): the keys the attention kernels visit."""
    import torch

    L = pad.shape[1]
    idx = torch.arange(1, L + 1, device=pad.device)
    last = ((pad == 0) * idx).amax(1)
    return int(torch.where(last > 0, last, torch.full_like(last, L)).sum())


# --------------------------------------------------------------------------
# phase 1-2
# --------------------------------------------------------------------------

def card() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]


def phase_device() -> dict:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: this smoke test needs the card")
    print(card(), flush=True)
    say("device", f"torch {torch.__version__} cuda {torch.version.cuda} "
                  f"python {sys.version.split()[0]} count {torch.cuda.device_count()}")
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}


# kernel name fragment → the SASS its kernels must show: the GEMMs and the
# tensor-core attention kernels on wgmma (HGMMA bf16, IGMMA int8) fed by
# TMA (UTMALDG); no kernel of the library may show HMMA (the mma.sync route)
SASS_NEEDS = {"gemm_bias_act_wgmma": ("HGMMA", "UTMALDG"), "gemm_i8_wgmma": ("IGMMA", "UTMALDG"),
              "gemm_dx_wgmma": ("HGMMA", "UTMALDG"), "gemm_dw_wgmma": ("HGMMA", "UTMALDG"),
              "flash_attn_wgmma": ("HGMMA", "UTMALDG"), "dense_attn_wgmma": ("HGMMA", "UTMALDG"),
              "esm2_attn_wgmma": ("HGMMA", "UTMALDG"), "esm2_bwd_dq_wgmma": ("HGMMA", "UTMALDG"),
              "esm2_bwd_dkv_wgmma": ("HGMMA", "UTMALDG"), "local_attn_wgmma": ("HGMMA", "UTMALDG"),
              "stage3_local_wgmma": ("HGMMA", "UTMALDG"),
              "stage3_bwd_dq_wgmma": ("HGMMA", "UTMALDG"),
              "stage3_bwd_dkv_wgmma": ("HGMMA", "UTMALDG"),
              "stage3_i8_band_wgmma": ("IGMMA", "UTMALDG"),
              # the head product on wgmma from shared memory the warps fill
              "gather_head": ("HGMMA",)}
# kernels whose registers and spills the build prints (``ptxas.txt``),
# each in two instantiations: head dims 32 and 64, or the GEMM's two tiles
PTXAS_SHOW = ("flash_attn_wgmma_kernel", "dense_attn_wgmma_kernel", "esm2_attn_wgmma_kernel",
              "esm2_attn_stage_kernel", "esm2_bwd_dq_wgmma_kernel", "esm2_bwd_dkv_wgmma_kernel",
              "esm2_bwd_stage_kernel", "gemm_dx_wgmma", "gemm_dw_wgmma", "local_attn_wgmma_kernel",
              "stage3_local_wgmma_kernel", "stage3_linear_stats_kernel", "stage3_linear_ctx_kernel",
              "stage3_bwd_dq_wgmma_kernel", "stage3_bwd_dkv_wgmma_kernel",
              "stage3_i8_quant_kernel", "stage3_i8_band_wgmma_kernel")
# kernels whose output must not change from call to call (no split sums
# in another order, no atomics)
DETERMINISTIC = {"gemm_dx", "gemm_dw", "layernorm", "layernorm_bwd", "col_sum",
                 "stage3_attention_core", "stage3_attention_core_i8", "stage3_attention_bwd",
                 "bias_layernorm", "gather_head"}
# kernel → how many of its last outputs are f32 column sums (SUM_TOL)
COLUMN_SUMS = {"col_sum": 1, "layernorm_bwd": 2}


def ptxas_usage(report: str) -> dict[str, dict[str, int]]:
    """``PTXAS_SHOW`` kernel<template ints> → registers, spill stores and
    spill loads (bytes a thread), from the compilers' ``-Xptxas -v``
    report."""
    usage, key = {}, None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '(\S+)'", line)
        if entry:
            name = entry.group(1)
            key = next((f"{f}<{','.join(re.findall(r'Li(\d+)E', m.group(1)))}>"
                        for f in PTXAS_SHOW if (m := re.search(f + r"I((?:Li\d+E)+)E", name))),
                       None)
            continue
        if key is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if spill:
            usage.setdefault(key, {}).update(spill_stores=int(spill.group(1)),
                                             spill_loads=int(spill.group(2)))
        regs = re.search(r"Used (\d+) registers", line)
        if regs:
            usage.setdefault(key, {})["registers"] = int(regs.group(1))
    return usage


def phase_build() -> None:
    from biom3_tpu_torch.cli.measure_gemm import sass_counts
    from biom3_tpu_torch.ops import _build

    info = _build.build(force=True)
    _build.library()
    say("build", f"nvcc built {_build.LIB_PATH.name} in {info['seconds']:.1f} s "
                 f"(per-kernel registers and spills: {_build.PTXAS_REPORT})")
    sass = sass_counts(_build.LIB_PATH)
    print("[sass] " + json.dumps(sass), flush=True)
    for frag, ops in SASS_NEEDS.items():
        kernels = {name: c for name, c in sass.items() if frag in name}
        if not kernels or any(not c[op] for c in kernels.values() for op in ops):
            raise AssertionError(f"{frag}: no {'/'.join(ops)} in its SASS: {kernels}")
    hmma = {name: c["HMMA"] for name, c in sass.items() if c["HMMA"]}
    if hmma:
        raise AssertionError(f"HMMA (mma.sync) in the SASS of {hmma}")
    usage = ptxas_usage(_build.PTXAS_REPORT.read_text())
    if len(usage) != 2 * len(PTXAS_SHOW):   # each kernel in two instantiations
        raise AssertionError(f"ptxas report lacks kernels of PTXAS_SHOW: {sorted(usage)}")
    print("[ptxas] " + json.dumps(usage), flush=True)


# --------------------------------------------------------------------------
# phase 3: kernels vs plain versions at full shapes
# --------------------------------------------------------------------------

def esm_ids(lengths, L: int, g):
    """(len(lengths), L) int32 ESM tokens: <cls>, residues, <eos>, then a
    PAD tail to L; one <mask> in row 0."""
    import torch

    ids = torch.ones((len(lengths), L), dtype=torch.int32, device=g.device)
    for b, n in enumerate(lengths):
        ids[b, 1:n - 1] = torch.randint(4, 24, (n - 2,), generator=g, device=g.device,
                                        dtype=torch.int32)
        ids[b, 0], ids[b, n - 1] = 0, 2
    ids[0, 5] = 32
    return ids


def kernel_cases(B: int, Bb: int, esm_lengths, g) -> dict[str, list]:
    """Kernel → [case, ...] at full width, Stage-3 batch B (L 1024, d 512,
    8 + 8 heads, W 128, FF 2048), BERT batch Bb (L 512, E 768, 12 heads, FF
    3072) and one ESM2-650M row (L 1024, E 1280, 20 heads, FF 5120) of each
    length in ``esm_lengths`` (the rest PAD).  A case holds the kernel call,
    its plain version, the FLOPs and bytes the function needs (each input
    read once, each output written once) and, where one PyTorch call
    computes the same function, that call (timed only).  The first four
    GEMMs are one Stage-3 layer's products, then BERT's and ESM's; the
    training kernels' first calls are one Stage-3 layer's backward; every
    other kernel's first call is its Stage-3 call (``dense_attention``: its
    BERT call; the ESM kernels and ``flash_attention``: their ESM-width
    call).  ``ESM_BACKWARD`` slices out the training kernels' calls of one
    ESM2 layer's backward at the ESM batch."""
    import torch
    import torch.nn.functional as F

    from biom3_tpu_torch.ops import kernels as K
    from biom3_tpu_torch.ops.quant import quantize_weight_int8
    from biom3_tpu_torch.ops.rotary import apply_rotary, rotary_cos_sin

    dev, bf, f32 = g.device, torch.bfloat16, torch.float32
    L, d, H, NL, W, FF = 1024, 512, 16, 8, 128, 2048
    Lb, E, Hb, FFb = 512, 768, 12, 3072
    Ee, He, FFe = 1280, 20, 5120
    Be = len(esm_lengths)
    M = B * L

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def vec(n, base=0.0, scale=0.1):
        return (base + scale * torch.randn(n, generator=g, device=dev)).float()

    def case(name, *args, flops=0, out=0, lib=None, peak=PEAK_FLOPS, **kw):
        tensors = [t for t in (*args, *kw.values()) if isinstance(t, torch.Tensor)]
        # the timed call leaves out ``codes=True``, which only the check reads
        timed = {k: v for k, v in kw.items() if k != "codes"}
        return {"run": lambda: getattr(K, name)(*args, **kw),
                "timed": lambda: getattr(K, name)(*args, **timed),
                "plain": lambda: getattr(K, name + "_plain")(*args, **kw),
                "flops": flops, "bytes": nbytes(*tensors) + out, "lib": lib, "peak": peak}

    def gemm8(m, k, n, *, bias=True, out_dtype=bf, **kw):
        """One int8 product at (m, k, n): seeded activation codes and their
        row scales, per-output-channel weight codes (N, K); the library
        call is the int32 product alone (``torch._int_mm``)."""
        a8, sa = K.quant_rows_plain(rnd(m, k))
        w8, sw = quantize_weight_int8(rnd(k, n, dtype=f32, scale=k ** -0.5))
        w8 = w8.t().contiguous()
        size = torch.finfo(out_dtype).bits // 8
        return case("gemm_i8", a8, sa, w8, sw, vec(n) if bias else None, out_dtype=out_dtype,
                    **kw, flops=2 * m * k * n, out=m * n * size, peak=PEAK_INT8,
                    lib=lambda: torch._int_mm(a8, w8.t()))

    def quant(x):
        rows, n = x.shape
        return case("quant_rows", x, flops=3 * rows * n, out=rows * n + rows * 4)

    def band_mask(L, W):
        win = torch.arange(L, device=dev) // W
        return (win[:, None] - win[None, :]).abs() <= 1

    def gemm(a, w, bias=None, out_dtype=None, **kw):
        m, k, n = a.shape[0], a.shape[1], w.shape[1]
        size = torch.finfo(out_dtype or a.dtype).bits // 8
        return case("gemm_bias_act", a, w, bias, out_dtype=out_dtype, **kw, flops=2 * m * k * n,
                    out=m * n * size, lib=lambda: torch.matmul(a, w))

    def gemm_dx(dy, w, out_dtype=None, **kw):
        m, k, n = dy.shape[0], dy.shape[1], w.shape[0]
        size = torch.finfo(out_dtype or dy.dtype).bits // 8
        return case("gemm_dx", dy, w, out_dtype=out_dtype, **kw, flops=2 * m * k * n,
                    out=m * n * size, lib=lambda: torch.matmul(dy, w.t()))

    def gemm_dw(x, dy):
        m, k, n = x.shape[0], x.shape[1], dy.shape[1]
        return case("gemm_dw", x, dy, flops=2 * m * k * n, out=k * n * 4,
                    lib=lambda: torch.matmul(x.t(), dy))

    def heads_of(qkv, h):
        b, l, e3 = qkv.shape
        return qkv.view(b, l, 3, h, e3 // 3 // h).permute(2, 0, 3, 1, 4)

    def ln_bwd(x, dy, scale, *, eps, out_dtype, want_cd=False, **kw):
        """The library call is aten's LayerNorm backward from the mean and
        rstd (computed here, outside the timing), without the residual."""
        rows, n = x.shape
        xf32 = x.float()
        shift = torch.zeros_like(scale)
        _, mean, rstd = torch.native_layer_norm(xf32, (n,), scale, shift, eps)
        out = rows * n * (torch.finfo(out_dtype).bits // 8 + 2 * want_cd) + 8 * n
        return case("layernorm_bwd", x, dy, scale, eps=eps, out_dtype=out_dtype, want_cd=want_cd,
                    **kw, flops=12 * rows * n, out=out,
                    lib=lambda: torch.ops.aten.native_layer_norm_backward(
                        dy, xf32, (n,), mean, rstd, scale, shift, [True, True, True]))

    def col_sum(x):
        rows, n = x.shape
        return case("col_sum", x, flops=rows * n, out=n * 4,
                    lib=lambda: torch.sum(x, 0, dtype=f32))

    def ln(x, scale, shift, eps, out_dtype=bf, want_f32=False):
        rows, n = x.shape
        out = rows * n * (2 + 4 * want_f32)
        ws, bs = scale.to(x.dtype), shift.to(x.dtype)
        return case("layernorm", x, scale, shift, eps=eps, out_dtype=out_dtype,
                    want_f32=want_f32, flops=8 * rows * n, out=out,
                    lib=lambda: F.layer_norm(x, (n,), ws, bs, eps))

    x, xf, mid = rnd(M, d), rnd(M, d, dtype=f32), rnd(M, FF)
    xb = rnd(Bb * Lb, E)
    h, s, t = rnd(B, L, d), vec(d, 1.0), vec(d)
    ids = esm_ids(esm_lengths, L, g)
    pad = (ids == 1).int()
    cos, sin = rotary_cos_sin(L, Ee // He, dtype=bf, device=dev)
    xe = rnd(Be * L, Ee)
    qkv3, qkvb, qkve = rnd(B, L, 3 * d), rnd(Bb, Lb, 3 * E), rnd(Be, L, 3 * Ee)
    fq = [rnd(Be, He, L, Ee // He) for _ in range(3)]
    fmask = (pad == 0)[:, None, None, :]
    band = band_pairs(B, L, W, NL)
    lin = B * (H - NL) * L * (d // H) ** 2
    # one Stage-3 layer's backward at batch B
    dy, dxa, h1, dh1 = rnd(M, d), rnd(M, d, dtype=f32), rnd(M, FF, dtype=f32), rnd(M, FF)
    dqkv, u = rnd(M, 3 * d), rnd(M, d)
    w1, w2, wo, w3 = (rnd(d, FF, scale=d ** -0.5), rnd(FF, d, scale=FF ** -0.5),
                      rnd(d, d, scale=d ** -0.5), rnd(d, 3 * d, scale=d ** -0.5))
    dattn = rnd(B, L, d)
    # one ESM2-650M layer's backward at the ESM batch
    Me = Be * L
    dye, dqe, dhe, atte, ge = rnd(Me, Ee), rnd(Me, 3 * Ee), rnd(Me, FFe), rnd(Me, Ee), rnd(Me, FFe)
    he, due = rnd(Me, FFe, dtype=f32), rnd(Me, Ee, dtype=f32)
    woe, w3e = rnd(Ee, Ee, scale=Ee ** -0.5), rnd(Ee, 3 * Ee, scale=Ee ** -0.5)
    w1e, w2e = rnd(Ee, FFe, scale=Ee ** -0.5), rnd(FFe, Ee, scale=FFe ** -0.5)
    # the attention gradient and its library yardstick: autograd through
    # SDPA with the boolean key mask on the already-rotated q, k (the
    # rotation and its adjoint left out), graph built once, backward timed
    dae = rnd(Be, L, Ee)
    qs, ks, vs = (t.contiguous() for t in heads_of(qkve, He))
    qs, ks = apply_rotary(qs, cos, sin), apply_rotary(ks, cos, sin)
    rotated = (qs, ks, vs)
    qs, ks, vs = (t.detach().requires_grad_() for t in (qs, ks, vs))
    sdpa = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=fmask)
    dsdpa = dae.view(Be, L, He, Ee // He).transpose(1, 2)
    # the standalone local attention at the stage3_graph path's shape
    ql = [rnd(B, NL, L, d // H) for _ in range(3)]
    bandm = band_mask(L, W)
    return {
        # one Stage-3 layer's four int8 products, then BERT's and ESM's
        "gemm_i8": [
            gemm8(M, d, 3 * d, bias=False),
            gemm8(M, d, d, residual=xf, out_dtype=f32),
            gemm8(M, d, FF, act="tanh", out_dtype=f32),
            gemm8(M, FF, d, residual=xf),
            gemm8(Bb * Lb, E, 3 * E),
            gemm8(Bb * Lb, E, E, residual=xb, out_dtype=f32),
            gemm8(Bb * Lb, E, FFb, act="tanh", out_dtype=f32),
            gemm8(Bb * Lb, FFb, E, residual=rnd(Bb * Lb, E, dtype=f32), out_dtype=f32),
            gemm8(Me, Ee, 3 * Ee),
            gemm8(Me, Ee, Ee, residual=xe, out_dtype=f32),
            gemm8(Me, Ee, FFe, act="tanh", out_dtype=f32),
            gemm8(Me, FFe, Ee, residual=rnd(Me, Ee, dtype=f32)),
        ],
        # a Stage-3 layer's four activation quants (LN1 output, head
        # outputs, f32 LN2 output, f32 GELU output), then BERT's and ESM's
        "quant_rows": [quant(x), quant(rnd(M, d)), quant(xf), quant(rnd(M, FF, dtype=f32)),
                       quant(xb), quant(rnd(Me, Ee, dtype=f32)), quant(rnd(Me, FFe, dtype=f32))],
        "local_window_attention": [
            case("local_window_attention", *ql, window=W,
                 flops=4 * (d // H) * band_pairs(B, L, W, NL), out=nbytes(ql[0]),
                 lib=lambda: F.scaled_dot_product_attention(*ql, attn_mask=bandm))],
        "gemm_bias_act": [
            gemm(x, w3),
            gemm(x, wo, vec(d), residual=xf, out_dtype=f32),
            gemm(x, w1, vec(FF), act="tanh"),
            gemm(mid, w2, vec(d), residual=xf),
            gemm(x, w1, vec(FF), act="erf", want_pre=True),   # the FF backward's recompute
            gemm(xb, rnd(E, 3 * E, scale=E ** -0.5), vec(3 * E)),
            gemm(xb, rnd(E, FFb, scale=E ** -0.5), vec(FFb), act="tanh"),
            gemm(rnd(Bb * Lb, FFb), rnd(FFb, E, scale=FFb ** -0.5), vec(E), residual=xb,
                 out_dtype=f32),
            gemm(xe, rnd(Ee, 3 * Ee, scale=Ee ** -0.5), vec(3 * Ee)),
            gemm(xe, rnd(Ee, FFe, scale=Ee ** -0.5), vec(FFe), act="tanh"),
            gemm(rnd(Be * L, FFe), rnd(FFe, Ee, scale=FFe ** -0.5), vec(Ee),
                 residual=rnd(Be * L, Ee, dtype=f32)),
        ],
        "stage3_attention_core": [
            case("stage3_attention_core", qkv3, heads=H, local_heads=NL, window=W,
                 flops=4 * (d // H) * band + 4 * lin, out=M * d * 2)],
        # the band heads' products in int8 (their ops at the int8 peak, the
        # linear heads' at bf16's, as int8-peak equivalents); bytes: qkv in,
        # the head outputs out
        "stage3_attention_core_i8": [
            case("stage3_attention_core_i8", qkv3, heads=H, local_heads=NL, window=W, codes=True,
                 flops=4 * (d // H) * band + 4 * lin * PEAK_INT8 / PEAK_FLOPS, out=M * d * 2,
                 peak=PEAK_INT8)],
        "dense_attention": [
            case("dense_attention", qkvb, heads=Hb, flops=4 * Bb * Hb * Lb * Lb * (E // Hb),
                 out=Bb * Lb * E * 2,
                 lib=lambda: F.scaled_dot_product_attention(*heads_of(qkvb, Hb)))],
        "bias_layernorm": [case("bias_layernorm", h, rnd(B, d), s, t, flops=9 * M * d,
                                out=M * d * 6)],
        "layernorm": [
            ln(xf, s, t, 1e-6),
            ln(rnd(Bb * Lb, E, dtype=f32, scale=3.0), vec(E, 1.0), vec(E), 1e-12,
               want_f32=True),
            # ESM2: LN1 on the bf16 residual, LN2 on the f32 one, the final
            # norm on the bf16 CLS rows with the f32 copy
            ln(rnd(Be * L, Ee, scale=3.0), vec(Ee, 1.0), vec(Ee), 1e-5),
            ln(rnd(Be * L, Ee, dtype=f32, scale=3.0), vec(Ee, 1.0), vec(Ee), 1e-5),
            ln(rnd(Be, Ee, scale=3.0), vec(Ee, 1.0), vec(Ee), 1e-5, want_f32=True),
        ],
        "embed_tokens": [case("embed_tokens",
                              torch.randint(0, 29, (B, L), generator=g, device=dev,
                                            dtype=torch.int32), rnd(29, d), rnd(L, d),
                              flops=M * d, out=M * d * 2)],
        "gather_head": [case("gather_head", h,
                             torch.randint(0, L, (B, k), generator=g, device=dev,
                                           dtype=torch.int32),
                             s, t, K.pad_head(rnd(d, 29, scale=d ** -0.5)), vec(29),
                             flops=2 * B * k * d * 29 + 8 * B * k * d, out=B * k * 29 * 4)
                        for k in (1, 8)],
        "esm2_embed": [case("esm2_embed", ids, rnd(33, Ee), flops=Be * L * Ee,
                            out=Be * L * Ee * 2)],
        # library: SDPA with the key mask on the already-rotated q, k (the
        # rotation left out), as for esm2_attention_bwd
        "esm2_attention": [case("esm2_attention", qkve, pad, cos, sin, heads=He,
                                flops=4 * He * L * live_keys(pad) * (Ee // He),
                                out=Be * L * Ee * 2,
                                lib=lambda: F.scaled_dot_product_attention(
                                    *rotated, attn_mask=fmask))],
        "flash_attention": [
            case("flash_attention", *fq, pad, flops=4 * He * L * live_keys(pad) * (Ee // He),
                 out=nbytes(fq[0]),
                 lib=lambda: F.scaled_dot_product_attention(*fq, attn_mask=fmask)),
            case("flash_attention", *(rnd(Bb, Hb, Lb, E // Hb) for _ in range(3)),
                 flops=4 * Bb * Hb * Lb * Lb * (E // Hb), out=Bb * Hb * Lb * (E // Hb) * 2),
        ],
        "stage3_attention_bwd": [
            case("stage3_attention_bwd", qkv3, dattn, heads=H, local_heads=NL, window=W,
                 flops=10 * (d // H) * band + 10 * lin, out=M * 3 * d * 2)],
        "gemm_dx": [
            gemm_dx(dy, wo),                                   # dattn = dxa·Woᵀ
            gemm_dx(dy, w2, gelu_of=h1),                       # dh1 = (dy·W2ᵀ)∘gelu'(h1)
            gemm_dx(dh1, w1, out_dtype=f32),                   # du = dh1·W1ᵀ
            gemm_dx(dqkv, w3, out_dtype=f32),                  # dxn1 = dqkv·W3ᵀ
            # ESM2: (K, N) = (1280, 1280), (1280, 5120), (5120, 1280), (3840, 1280)
            gemm_dx(dye, woe), gemm_dx(dye, w2e, gelu_of=he), gemm_dx(dhe, w1e, out_dtype=f32),
            gemm_dx(dqe, w3e, out_dtype=f32),
        ],
        "gemm_dw": [gemm_dw(mid, dy), gemm_dw(u, dh1), gemm_dw(x, dy), gemm_dw(u, dqkv),
                    # ESM2: dW2, dW1, dWo, dW3
                    gemm_dw(ge, dye), gemm_dw(atte, dhe), gemm_dw(atte, dye), gemm_dw(atte, dqe)],
        "layernorm_bwd": [
            ln_bwd(xf, dxa, s, residual=dy, eps=1e-6, out_dtype=f32, want_cd=True),  # LN2
            ln_bwd(x, dxa, s, residual=xf, eps=1e-6, out_dtype=bf),                  # LN1
            # ESM2: LN2 and LN1 at d = 1280, both into the bf16 dx with dy added
            ln_bwd(rnd(Me, Ee, scale=3.0), due, vec(Ee, 1.0), residual=dye, eps=1e-5,
                   out_dtype=bf),
            ln_bwd(rnd(Me, Ee, scale=3.0), due, vec(Ee, 1.0), residual=dye, eps=1e-5,
                   out_dtype=bf),
        ],
        # dbo, db2, db1; ESM2: dbo (= db2), db3, db1
        "col_sum": [col_sum(xf), col_sum(dy), col_sum(dh1), col_sum(dye), col_sum(dqe),
                    col_sum(dhe)],
        "esm2_attention_bwd": [
            case("esm2_attention_bwd", qkve, dae, pad, cos, sin, heads=He,
                 flops=10 * He * L * live_keys(pad) * (Ee // He), out=Be * L * 3 * Ee * 2,
                 lib=lambda: torch.autograd.grad(sdpa, (qs, ks, vs), dsdpa, retain_graph=True))],
    }


def edge_cases(g) -> dict[str, list]:
    """Shapes off the main path that the kernels' tiling must still get
    right: a GEMM with M, N, K off the 128x128x64 tile and M under one
    64-row tile, a smaller window, lengths (1000, 100, 65, 1) that leave
    ragged query and key tiles, ragged PAD tails down to a 3-token
    protein, an all-PAD row (also at a ragged length), head dim 32, batches
    of 1 and 16, bf16 LayerNorm rows off the 8-row block and a width off
    the 256-column stride."""
    import torch

    from biom3_tpu_torch.ops import kernels as K
    from biom3_tpu_torch.ops.rotary import rotary_cos_sin

    dev, bf = g.device, torch.bfloat16

    def rnd(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(bf)

    def pair(name, *args, **kw):
        return (lambda: getattr(K, name)(*args, **kw),
                lambda: getattr(K, name + "_plain")(*args, **kw))

    a, w, r = rnd(1000, 264), rnd(264, 200, scale=264 ** -0.5), rnd(1000, 200)
    bias = 0.1 * torch.randn(200, generator=g, device=dev)
    q3, qd = rnd(2, 256, 1536), rnd(3, 200, 2304)
    # BERT's attention at the e2e prompt's batch (1) and PenCL's (16),
    # lengths off the 64-row tiles down to one token, head dims 64 and 32
    dense = [(rnd(b, n, 3 * 12 * dh), 12) for b in (1, 16) for n in (1, 65, 100)
             for dh in (32, 64)]
    # gemm_dx: ragged M (1000, and 37 < 64 rows) at the ESM2 FF width N =
    # 5120 with each GELU derivative and each output type
    dx_esm = [pair("gemm_dx", rnd(m, 1280), rnd(5120, 1280, scale=1280 ** -0.5),
                   gelu_of=torch.randn(m, 5120, generator=g, device=dev), gelu=gelu,
                   out_dtype=out)
              for m, gelu, out in ((1000, "erf", bf), (1000, "tanh", torch.float32),
                                   (37, "tanh", bf), (37, "erf", torch.float32))]
    kw = dict(act="erf", residual=r, out_dtype=torch.float32)
    Le = 1000
    ids = esm_ids([Le, 517, 3], Le, g)
    ids[2, 1:] = 1                                   # <cls> then PAD only
    pad = (ids == 1).int()
    mask = (torch.rand(3, Le, generator=g, device=dev) < 0.25).int()
    mask[1] = 1                                      # every key PAD
    mask[2, 700:] = 1
    cos, sin = rotary_cos_sin(Le, 64, dtype=bf, device=dev)
    qe, table = rnd(3, Le, 768), rnd(33, 1280)
    fl = [rnd(3, 4, Le, 64) for _ in range(3)]
    fl32 = [rnd(2, 3, 130, 32) for _ in range(3)]      # head dim 32, no mask
    # the attention gradient: a ragged PAD row and an all-PAD row at L=1000,
    # and head dim 32 with a ragged tile at L=130
    pad_b = torch.zeros(3, Le, dtype=torch.int32, device=dev)
    pad_b[1, 517:], pad_b[2] = 1, 1
    pad32 = torch.zeros(2, 130, dtype=torch.int32, device=dev)
    pad32[1, 77:] = 1
    c32, s32 = rotary_cos_sin(130, 32, dtype=bf, device=dev)
    # the tensor-core attention kernels' 64-row tiles: L = 65 (one key past
    # a tile) with a full row, a 3-token protein and an all-PAD row, at head
    # dims 64 and 32; a 3-token protein beside an all-PAD row at L = 1000
    def pad_rows(L, *lengths):
        rows = torch.ones(len(lengths), L, dtype=torch.int32, device=dev)
        for b, n in enumerate(lengths):
            rows[b, :n] = 0
        return rows

    p65, p65b, p1000 = pad_rows(65, 65, 3, 0), pad_rows(65, 40, 0), pad_rows(Le, 3, 0)
    r65 = {dh: rotary_cos_sin(65, dh, dtype=bf, device=dev) for dh in (32, 64)}
    # bf16 rows off the 8-row block and d off the warp's 256-column stride
    xl = rnd(1003, 264, scale=3.0)
    ln = (1.0 + 0.1 * torch.randn(264, generator=g, device=dev),
          0.1 * torch.randn(264, generator=g, device=dev))
    a8 = torch.randint(-127, 128, (1000, 96), generator=g, device=dev, dtype=torch.int8)
    w8 = torch.randint(-127, 128, (200, 96), generator=g, device=dev, dtype=torch.int8)
    s8 = [torch.rand(n, generator=g, device=dev) * 0.01 for n in (1000, 200)]
    a8b = torch.randint(-127, 128, (37, 64), generator=g, device=dev, dtype=torch.int8)
    w8b = torch.randint(-127, 128, (8, 64), generator=g, device=dev, dtype=torch.int8)
    s8b = [torch.rand(n, generator=g, device=dev) for n in (37, 8)]
    # local attention: (q, k, v, window); bf16 on the tensor cores, f32 on
    # CUDA cores.  W = 32: a 64-row warpgroup spans two windows; W = 96: a
    # key tile straddles the band's edge (and L = 288 leaves the last
    # block's second warpgroup without a row); B·H = 1 with one window:
    # both neighbours masked
    loc = [([rnd(2, 3, 128, 32) for _ in range(3)], 128),
           ([rnd(2, 4, 512, 64) for _ in range(3)], 128),
           ([torch.randn(1, 2, 256, 32, generator=g, device=dev) for _ in range(3)], 64),
           ([torch.randn(1, 2, 256, 64, generator=g, device=dev) for _ in range(3)], 64),
           ([rnd(2, 3, 256, 32) for _ in range(3)], 32),
           ([rnd(2, 2, 288, 32) for _ in range(3)], 96),
           ([rnd(1, 4, 1024, 64) for _ in range(3)], 64),
           ([rnd(1, 1, 128, 32) for _ in range(3)], 128)]
    # LayerNorm: one f32 row at ESM2's width to an f32 output alone (the
    # int8 FF's input), and 37 f32 rows at BERT's width with the f32 copy
    x1280, x768 = (torch.randn(n, d, generator=g, device=dev) * 3.0 for n, d in ((1, 1280),
                                                                              (37, 768)))
    ln1280, ln768 = ((1.0 + 0.1 * torch.randn(d, generator=g, device=dev),
                      0.1 * torch.randn(d, generator=g, device=dev)) for d in (1280, 768))
    # ... and rows past the 1280 columns held in registers, staged in shared
    # memory: ESM2-3B's LN1 (bf16, d 2560), a Stage-3 dim of 4096, a ragged
    # 1288 with the f32 copy, and a row over 48 KB (a block of one warp);
    # then a row over one block's shared memory (read from global memory)
    f32 = torch.float32
    ln_wide = [((torch.randn(n, d, generator=g, device=dev) * 3.0).to(xd),
                1.0 + 0.1 * torch.randn(d, generator=g, device=dev),
                0.1 * torch.randn(d, generator=g, device=dev),
                dict(eps=eps, out_dtype=od, want_f32=wf))
               for n, d, xd, eps, od, wf in ((19, 2560, bf, 1e-5, bf, False),
                                             (37, 4096, f32, 1e-6, bf, False),
                                             (11, 1288, f32, 1e-5, bf, True),
                                             (3, 16384, f32, 1e-5, f32, False),
                                             (5, 60000, f32, 1e-5, bf, True))]
    # layernorm_bwd past the 1280 columns held in registers, on its
    # shared-memory route: ESM2-3B's (bf16 x and residual into bf16 dx), a
    # Stage-3 dim of 4096 (f32 x, bf16 residual, f32 dx with its bf16
    # copy), a ragged 1288 and one 16384-wide f32 row (one row a round)
    lnb_wide = [((torch.randn(n, d, generator=g, device=dev) * 3.0).to(xd),
                 torch.randn(n, d, generator=g, device=dev),
                 1.0 + 0.1 * torch.randn(d, generator=g, device=dev),
                 dict(residual=torch.randn(n, d, generator=g, device=dev).to(rd), eps=1e-5,
                      out_dtype=od, want_cd=wc))
                for n, d, xd, rd, od, wc in ((19, 2560, bf, bf, bf, False),
                                             (37, 4096, f32, bf, f32, True),
                                             (11, 1288, bf, f32, bf, False),
                                             (1, 16384, f32, f32, f32, False))]
    # col_sum on 1 and 7 rows, one row past its slabs (4161 = 64 x 65 + 1
    # rows of 512 columns: 65 slabs of 65 rows at the H100's 528 resident
    # blocks, the last of one row), and 8 columns (one tile, 7 of its 8
    # lanes idle)
    cs_edge = [torch.randn(1, 264, generator=g, device=dev), rnd(7, 264), rnd(4161, 512),
               torch.randn(4161, 8, generator=g, device=dev), rnd(1000, 8)]
    # quant_rows: 8 columns (one lane of one warp), 2056 (two warps a row,
    # 8-byte stores) and ESM2's 5120 in f32 (four warps a row, 16-byte
    # stores), each with an all-zero row and a row whose max is its last
    # column
    q_edge = [torch.randn(n, d, generator=g, device=dev) for n, d in ((37, 8), (13, 2056),
                                                                      (11, 5120))]
    for x in q_edge:
        x[0], x[1, -1] = 0.0, 1000.0
    # stage3_attention_core (B, L, heads, local heads, W) at d = 512: head
    # dim 64; W = 32 (a warpgroup over two windows) and W = 8; linear heads
    # only (the sequence split in 8 chunks) and band heads only; L = 1000
    # (ragged 64-row tiles and a short last chunk); then d = 256 at L = 200,
    # head dim 64, B = 3
    s3_edge = [(2, 512, 8, 4, 128), (2, 512, 16, 8, 32), (2, 256, 16, 8, 8),
               (2, 1024, 16, 0, 128), (2, 1024, 16, 16, 128), (2, 1000, 16, 8, 40)]
    # stage3_attention_bwd's band passes (B, L, heads, local heads, W) at d =
    # 512: W = 16 and 40 (a 64-row warpgroup over several windows, W = 40
    # also at L = 1000: keys past the last 64-row tile), W = 8, W = 96 (a
    # tile across the band's edge; L = 288 leaves a warpgroup without a
    # row), head dim 64 at W = 32; then d = 256 at L = 200, head dim 64
    s3b_edge = [(2, 256, 16, 8, 16), (2, 1000, 16, 8, 40), (2, 256, 16, 8, 8),
                (2, 288, 16, 8, 96), (2, 512, 8, 4, 32)]
    # bias_layernorm: 74 rows (off the 8-row block; a warp's rows cross a
    # batch row's bias) at d = 1280 (the widest row held in registers), a
    # ragged 1288, 2560 and 4096 (staged in shared memory); then 6 rows of
    # 120000 (a bf16 row past one block's shared memory, read from global)
    # gather_head: 64-row tiles left ragged (3 x 37 rows), the full grid at
    # L = 100 and 130, d = 96 (a 64-column block half used) and 256 (one
    # register chunk a lane), d past one shared-memory slab (1280, 4096, a
    # slab of 256 after 1024), 5 and 32 classes, one row
    def head_case(B, L, k, d, C):
        pos = (torch.arange(L, device=dev, dtype=torch.int32).expand(B, L).contiguous()
               if k == L else torch.randint(0, L, (B, k), generator=g, device=dev,
                                             dtype=torch.int32))
        return pair("gather_head", rnd(B, L, d, scale=3.0), pos,
                    1.0 + 0.1 * torch.randn(d, generator=g, device=dev),
                    0.1 * torch.randn(d, generator=g, device=dev),
                    K.pad_head(rnd(d, C, scale=d ** -0.5)),
                    0.1 * torch.randn(C, generator=g, device=dev))

    gh_edge = [head_case(*a) for a in ((3, 100, 37, 512, 29), (2, 100, 100, 96, 5),
                                       (2, 130, 130, 256, 32), (2, 70, 70, 1280, 29),
                                       (2, 64, 64, 4096, 29), (3, 50, 50, 1280 + 256, 29),
                                       (1, 1024, 1, 512, 29))]
    bln_edge = [(rnd(b, n, d, scale=3.0), rnd(b, d),
                 1.0 + 0.1 * torch.randn(d, generator=g, device=dev),
                 0.1 * torch.randn(d, generator=g, device=dev))
                for b, n, d in ((2, 37, 1280), (2, 37, 1288), (2, 37, 2560), (2, 37, 4096),
                                (2, 3, 120000))]
    return {
        # int8: M, N, K off the 128x128x64 tile (K a multiple of 32), a bf16
        # residual and erf GELU; quant rows off the 8-row block and the
        # 256-column stride; local attention on one window (both
        # neighbours masked), head dim 64, and f32
        "gemm_i8": [pair("gemm_i8", a8, s8[0], w8, s8[1], bias, act="erf", residual=r,
                         out_dtype=bf),
                    pair("gemm_i8", a8b, s8b[0], w8b, s8b[1], out_dtype=torch.float32)],
        "quant_rows": [pair("quant_rows", xl),
                       pair("quant_rows", torch.randn(7, 5120, generator=g, device=dev)),
                       *(pair("quant_rows", x) for x in q_edge)],
        "local_window_attention": [pair("local_window_attention", *t, window=w) for t, w in loc],
        "gemm_bias_act": [(lambda: K.gemm_bias_act(a, w, bias, **kw),
                           lambda: K.gemm_bias_act_plain(a, w, bias, **kw))],
        "stage3_attention_core": [
            (lambda: K.stage3_attention_core(q3, heads=16, local_heads=8, window=64),
             lambda: K.stage3_attention_core_plain(q3, heads=16, local_heads=8, window=64)),
            *(pair("stage3_attention_core", rnd(b, n, 1536), heads=h, local_heads=nl, window=w)
              for b, n, h, nl, w in s3_edge),
            pair("stage3_attention_core", rnd(3, 200, 768), heads=4, local_heads=2, window=40)],
        # the same shapes in int8 (every window a multiple of 4)
        "stage3_attention_core_i8": [
            *(pair("stage3_attention_core_i8", rnd(b, n, 1536), heads=h, local_heads=nl,
                   window=w, codes=True) for b, n, h, nl, w in s3_edge),
            pair("stage3_attention_core_i8", rnd(3, 200, 768), heads=4, local_heads=2, window=40,
                 codes=True)],
        "dense_attention": [pair("dense_attention", qd, heads=12),
                            *(pair("dense_attention", x, heads=h) for x, h in dense)],
        "layernorm": [(lambda: K.layernorm(xl, *ln, eps=1e-5, out_dtype=bf, want_f32=True),
                       lambda: K.layernorm_plain(xl, *ln, eps=1e-5, out_dtype=bf,
                                                 want_f32=True)),
                      pair("layernorm", x1280, *ln1280, eps=1e-5, out_dtype=torch.float32),
                      pair("layernorm", x768, *ln768, eps=1e-12, out_dtype=bf, want_f32=True),
                      *(pair("layernorm", x, sc, sh, **kw) for x, sc, sh, kw in ln_wide)],
        "esm2_embed": [(lambda: K.esm2_embed(ids, table),
                        lambda: K.esm2_embed_plain(ids, table))],
        # the tensor-core forward: flash's edge shapes with the rotary tables
        "esm2_attention": [
            pair("esm2_attention", qe, pad, cos, sin, heads=4),
            pair("esm2_attention", rnd(3, Le, 2304), pad_b, cos, sin, heads=12),
            pair("esm2_attention", rnd(2, 130, 768), pad32, c32, s32, heads=8),
            pair("esm2_attention", rnd(3, 65, 768), p65, *r65[64], heads=4),
            pair("esm2_attention", rnd(2, 65, 768), p65b, *r65[32], heads=8),
            pair("esm2_attention", rnd(2, Le, 2304), p1000, cos, sin, heads=12)],
        "flash_attention": [(lambda: K.flash_attention(*fl, mask),
                             lambda: K.flash_attention_plain(*fl, mask)),
                            (lambda: K.flash_attention(*fl32),
                             lambda: K.flash_attention_plain(*fl32)),
                            pair("flash_attention", *(rnd(3, 4, 65, 64) for _ in range(3)), p65),
                            pair("flash_attention", *(rnd(2, 3, 65, 32) for _ in range(3)),
                                 p65b),
                            pair("flash_attention", *(rnd(2, 4, Le, 64) for _ in range(3)),
                                 p1000)],
        # training: edge windows at W=64, no local heads (and a ragged last
        # chunk of the linear heads), only local heads, head dim 64; GEMMs
        # with M, N, K off the tiles (ragged row counts for dW, one over two
        # splits); LayerNorm and column sums off the row blocks and the
        # 256-column stride
        "stage3_attention_bwd": [
            pair("stage3_attention_bwd", rnd(2, 256, 1536), rnd(2, 256, 512), heads=16,
                 local_heads=8, window=64),
            pair("stage3_attention_bwd", rnd(2, 1000, 1536), rnd(2, 1000, 512), heads=16,
                 local_heads=0, window=128),
            pair("stage3_attention_bwd", rnd(2, 512, 1536), rnd(2, 512, 512), heads=16,
                 local_heads=16, window=128),
            pair("stage3_attention_bwd", rnd(2, 256, 1536), rnd(2, 256, 512), heads=8,
                 local_heads=4, window=64),
            *(pair("stage3_attention_bwd", rnd(b, n, 1536), rnd(b, n, 512), heads=h,
                   local_heads=nl, window=w) for b, n, h, nl, w in s3b_edge),
            pair("stage3_attention_bwd", rnd(3, 200, 768), rnd(3, 200, 256), heads=4,
                 local_heads=2, window=40),
        ],
        "bias_layernorm": [pair("bias_layernorm", *t) for t in bln_edge],
        "gather_head": gh_edge,
        "gemm_dx": [pair("gemm_dx", rnd(1000, 264), rnd(200, 264, scale=264 ** -0.5),
                         gelu_of=torch.randn(1000, 200, generator=g, device=dev),
                         out_dtype=torch.float32),
                    pair("gemm_dx", rnd(1000, 200), rnd(264, 200, scale=200 ** -0.5)),
                    pair("gemm_dx", rnd(37, 200), rnd(264, 200, scale=200 ** -0.5),
                         out_dtype=torch.float32),
                    *dx_esm],
        "gemm_dw": [pair("gemm_dw", rnd(1000, 264), rnd(1000, 200)),
                    pair("gemm_dw", rnd(37, 264), rnd(37, 200)),
                    pair("gemm_dw", rnd(8191, 264), rnd(8191, 200))],
        "layernorm_bwd": [pair("layernorm_bwd", xl, torch.randn(1003, 264, generator=g,
                                                                 device=dev), ln[0],
                               residual=rnd(1003, 264), out_dtype=torch.float32,
                               want_cd=True),
                          *(pair("layernorm_bwd", x, dy, sc, **kw) for x, dy, sc, kw in lnb_wide)],
        "col_sum": [pair("col_sum", torch.randn(1003, 264, generator=g, device=dev)),
                    *(pair("col_sum", x) for x in cs_edge)],
        "esm2_attention_bwd": [
            pair("esm2_attention_bwd", rnd(3, Le, 2304), rnd(3, Le, 768), pad_b, cos, sin,
                 heads=12),
            pair("esm2_attention_bwd", rnd(2, 130, 768), rnd(2, 130, 256), pad32, c32, s32,
                 heads=8),
            pair("esm2_attention_bwd", rnd(3, 65, 768), rnd(3, 65, 256), p65, *r65[64], heads=4),
            pair("esm2_attention_bwd", rnd(2, 65, 768), rnd(2, 65, 256), p65b, *r65[32],
                 heads=8),
            pair("esm2_attention_bwd", rnd(2, Le, 2304), rnd(2, Le, 768), p1000, cos, sin,
                 heads=12)],
    }


# the training kernels' calls of one ESM2 layer's backward in kernel_cases
ESM_BACKWARD = {"gemm_dx": slice(4, 8), "gemm_dw": slice(4, 8), "layernorm_bwd": slice(2, 4),
                "col_sum": slice(3, 6)}


def time_cases(cases) -> dict:
    """ms of the kernels, their plain versions and, where every case has
    one, the library calls (CUDA events), and the bound of the cases."""
    from biom3_tpu_torch.cli.measure_pencl import event_ms

    ms = event_ms(lambda: [c.get("timed", c["run"])() for c in cases], TIMED_ITERS)
    plain_ms = event_ms(lambda: [c["plain"]() for c in cases], TIMED_ITERS)
    libs = [c["lib"] for c in cases]
    library_ms = event_ms(lambda: [lib() for lib in libs], TIMED_ITERS) if all(libs) else None
    t_ops = sum(c["flops"] / c["peak"] for c in cases) * 1e3
    t_bytes = sum(c["bytes"] for c in cases) / PEAK_BYTES * 1e3
    bound_ms = sum(max(c["flops"] / c["peak"], c["bytes"] / PEAK_BYTES) for c in cases) * 1e3
    return {"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes", "library_ms": library_ms}


def timing_text(t: dict) -> str:
    lib_txt = "—" if t["library_ms"] is None else f"{t['library_ms']:.4f} ms"
    return (f"kernel {t['ms']:.4f} ms plain {t['plain_ms']:.4f} ms bound {t['bound_ms']:.4f} ms "
            f"({t['bound_by']}) library {lib_txt}")


def phase_kernels() -> dict:
    import torch

    from biom3_tpu_torch.cli.run_pencl_inference import DEMO_SEQUENCES

    t0 = time.perf_counter()
    g = torch.Generator(device="cuda").manual_seed(SEED)
    # timed: the check shapes (Stage 3 B=4, BERT B=2, ESM B=2 with one
    # full-length and one PAD-tailed row); also checked: the shapes phase
    # 5's run gives the kernels (2 replicas, 1 prompt), phase 6's ESM batch
    # (the 5 demo proteins) and the edge cases
    timed = kernel_cases(4, 2, [1024, 400], g)
    demo = [len(seq) + 2 for seq in DEMO_SEQUENCES]
    small = kernel_cases(2, 1, demo, g)
    checked = [{n: [(c["run"], c["plain"]) for c in cs] for n, cs in cases.items()}
               for cases in (timed, small)] + [edge_cases(g)]
    # timed calls: one Stage-3 layer's four forward products; every
    # training kernel's calls of one layer's backward
    n_timed = {"gemm_bias_act": 4, "gemm_dx": 4, "gemm_dw": 4, "layernorm_bwd": 2,
               "col_sum": 3, "gemm_i8": 4, "quant_rows": 4}
    # dqkv: each 32-column head group against its own scale (the linear
    # heads' dk is ~1/L of the local heads' dv)
    grouped = {"stage3_attention_bwd": 32, "esm2_attention_bwd": 64,
               # the linear heads' outputs against their own scale, too
               "stage3_attention_core": 32, "stage3_attention_core_i8": 32}

    results = {}
    for name, cases in timed.items():
        worst_abs, worst_rel = 0.0, 0.0
        for run, plain in (c for chk in checked for c in chk.get(name, [])):
            got, want = flat(run()), flat(plain())
            torch.cuda.synchronize()
            if name in DETERMINISTIC and not all(map(torch.equal, got, flat(run()))):
                raise AssertionError(f"{name}: a second call on the same inputs gave other bits")
            for i, (a, b) in enumerate(zip(got, want)):
                if i >= BIT_EQUAL.get(name, len(got)):
                    if not torch.equal(a, b):
                        raise AssertionError(f"{name}: {int((a != b).sum())} of {a.numel()} "
                                             f"values differ from the plain version's")
                    continue
                err_abs, err_rel = rel_err(a, b, group=grouped.get(name, 0))
                worst_abs, worst_rel = max(worst_abs, err_abs), max(worst_rel, err_rel)
                if i >= len(got) - COLUMN_SUMS.get(name, 0) and err_rel > SUM_TOL:
                    raise AssertionError(f"{name}: column sums of {tuple(a.shape)} off by "
                                         f"{err_rel:.3e} relative > {SUM_TOL}")
        if worst_rel > REL_TOL:
            raise AssertionError(f"{name}: max|Δ|/max|ref| = {worst_rel:.3e} > {REL_TOL}")
        results[name] = {"max_abs_err": worst_abs,
                         **time_cases(cases[:n_timed.get(name, 1)])}
        say("kernels", f"{name}: max|Δ| {worst_abs:.3e} rel {worst_rel:.3e} "
                       f"{timing_text(results[name])}")
    for name, part in ESM_BACKWARD.items():
        cases = timed[name][part]
        say("kernels", f"{name}, one ESM2-650M layer's backward (B=2, L=1024, {len(cases)} "
                       f"calls): {timing_text(time_cases(cases))}")
    del timed, small, checked
    torch.cuda.empty_cache()
    phase_gemms_b32(results, g)
    say("kernels", f"phase 3 took {time.perf_counter() - t0:.1f} s")
    return results


def phase_gemms_b32(results: dict, g) -> None:
    """The forward GEMMs at Stage-3 B=32 (M = 32768): one layer's four
    products in bf16 and in int8, each against its plain version, timed
    with their library calls and bound (``cli/measure_gemm.py``), and
    ``stage3_attention_core`` at the same batch (``stage3_core_b32``); then
    the host cost of one wrapper call beside ``layernorm``'s, which encodes
    no tensor maps."""
    import torch

    from biom3_tpu_torch.cli import measure_gemm as mg

    for name, cases in mg.stage3_gemm_cases(32, g).items():
        err_abs, err_rel = mg.check(cases)
        t = mg.timing(cases)
        unit = "TOP/s" if name == "gemm_i8" else "TFLOP/s"
        results[name].update({f"{k}_b32": v for k, v in t.items()})
        results[name]["max_abs_err"] = max(results[name]["max_abs_err"], err_abs)
        say("kernels", f"{name}, Stage-3 B=32 (M=32768, 4 products): max|Δ| {err_abs:.3e} rel "
                       f"{err_rel:.3e} kernel {t['ms']:.4f} ms ({t['rate_t_per_s']:.1f} {unit}) "
                       f"library {t['library_ms']:.4f} ms ({t['library_rate_t_per_s']:.1f} "
                       f"{unit}) bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    del cases
    stage3_core_b32(results, g)
    stage3_core_i8_b32(results, g)
    stage3_bwd_b32(results, g)
    bias_layernorm_b32(results, g)
    gather_head_full_grid(results, g)
    torch.cuda.empty_cache()
    say("kernels", "host µs per wrapper call (enqueue, Stage-3 B=4): "
                   + " ".join(f"{k} {v:.1f}" for k, v in mg.host_costs(g).items()))


def stage3_core_b32(results: dict, g) -> None:
    """``stage3_attention_core`` at Stage-3 B=32 (L 1024, d 512, 8 + 8
    heads, W 128): against its plain version per 32-column head group, the
    same bits on a second call, timed beside its bound."""
    import torch

    from biom3_tpu_torch.cli.measure_pencl import event_ms
    from biom3_tpu_torch.ops import kernels as K

    B, L, d, H, NL, W = 32, 1024, 512, 16, 8, 128
    qkv = torch.randn(B, L, 3 * d, generator=g, device=g.device).bfloat16()
    kw = dict(heads=H, local_heads=NL, window=W)
    got, want = K.stage3_attention_core(qkv, **kw), K.stage3_attention_core_plain(qkv, **kw)
    err_abs, err_rel = rel_err(got, want, group=d // H)
    if err_rel > REL_TOL:
        raise AssertionError(f"stage3_attention_core B=32: max|Δ|/max|ref| = {err_rel:.3e}")
    if not torch.equal(got, K.stage3_attention_core(qkv, **kw)):
        raise AssertionError("stage3_attention_core B=32: a second call gave other bits")
    del want
    ms = event_ms(lambda: K.stage3_attention_core(qkv, **kw), TIMED_ITERS)
    flops = 4 * (d // H) * band_pairs(B, L, W, NL) + 4 * B * (H - NL) * L * (d // H) ** 2
    bound_ms = max(flops / PEAK_FLOPS, (nbytes(qkv) + B * L * d * 2) / PEAK_BYTES) * 1e3
    entry = results["stage3_attention_core"]
    entry.update(ms_b32=ms, bound_ms_b32=bound_ms)
    entry["max_abs_err"] = max(entry["max_abs_err"], err_abs)
    say("kernels", f"stage3_attention_core, Stage-3 B=32: max|Δ| {err_abs:.3e} rel {err_rel:.3e} "
                   f"kernel {ms:.4f} ms bound {bound_ms:.4f} ms ({bound_ms / ms:.0%})")


def stage3_core_i8_b32(results: dict, g) -> None:
    """``stage3_attention_core_i8`` at Stage-3 B=32 (L 1024, d 512, 8 + 8
    heads, W 128): its q, k, v codes and scales bit-equal to the plain
    version's, the output per 32-column head group, the same bits on a
    second call; timed beside its bound and beside ``stage3_attention_core``
    (bf16) on the same qkv."""
    import torch

    from biom3_tpu_torch.cli.measure_pencl import event_ms
    from biom3_tpu_torch.ops import kernels as K

    B, L, d, H, NL, W = 32, 1024, 512, 16, 8, 128
    qkv = torch.randn(B, L, 3 * d, generator=g, device=g.device).bfloat16()
    kw = dict(heads=H, local_heads=NL, window=W)
    got, codes = K.stage3_attention_core_i8(qkv, **kw, codes=True)
    want, want_codes = K.stage3_attention_core_i8_plain(qkv, **kw, codes=True)
    for a, b in zip(codes, want_codes):
        if not torch.equal(a, b):
            raise AssertionError(f"stage3_attention_core_i8 B=32: {int((a != b).sum())} of "
                                 f"{a.numel()} codes or scales differ from the plain version's")
    err_abs, err_rel = rel_err(got, want, group=d // H)
    if err_rel > REL_TOL:
        raise AssertionError(f"stage3_attention_core_i8 B=32: max|Δ|/max|ref| = {err_rel:.3e}")
    if not torch.equal(got, K.stage3_attention_core_i8(qkv, **kw)):
        raise AssertionError("stage3_attention_core_i8 B=32: a second call gave other bits")
    del want, want_codes, codes
    ms = event_ms(lambda: K.stage3_attention_core_i8(qkv, **kw), TIMED_ITERS)
    bf16_ms = event_ms(lambda: K.stage3_attention_core(qkv, **kw), TIMED_ITERS)
    ops = (4 * (d // H) * band_pairs(B, L, W, NL) / PEAK_INT8
           + 4 * B * (H - NL) * L * (d // H) ** 2 / PEAK_FLOPS)
    bound_ms = max(ops, (nbytes(qkv) + B * L * d * 2) / PEAK_BYTES) * 1e3
    entry = results["stage3_attention_core_i8"]
    entry.update(ms_b32=ms, bound_ms_b32=bound_ms, bf16_core_ms_b32=bf16_ms)
    entry["max_abs_err"] = max(entry["max_abs_err"], err_abs)
    departures = {f"B={b}": i8_pq_departures(x, **kw)
                  for b, x in ((4, qkv[:4].contiguous()), (32, qkv))}
    entry["pq_departures"] = departures
    say("kernels", f"stage3_attention_core_i8, Stage-3 B=32: codes and scales bit-equal, max|Δ| "
                   f"{err_abs:.3e} rel {err_rel:.3e} kernel {ms:.4f} ms (B=4 {entry['ms']:.4f}) "
                   f"bound {bound_ms:.4f} ms ({bound_ms / ms:.0%}); stage3_attention_core (bf16) "
                   f"on the same qkv {bf16_ms:.4f} ms; p codes off the plain version's by one "
                   f"step: " + ", ".join(f"{k} {n} of {t}" for k, (n, t) in departures.items()))


def i8_pq_departures(qkv, **kw) -> tuple[int, int]:
    """The band kernel's p codes (``stage3_attention_core_i8(pq=True)``)
    against the plain version's from the same q, k, v codes: each may move
    by one step at most (its rounding, ``stage3_i8_band_plain``) → (codes
    that differ, codes in the bands)."""
    import torch

    from biom3_tpu_torch.ops import kernels as K

    _, codes, got = K.stage3_attention_core_i8(qkv, **kw, codes=True, pq=True)
    _, want = K.stage3_i8_band_plain(*codes, window=kw["window"])
    step = (got.int() - want.int()).abs()
    if int(step.max()) > 1:
        raise AssertionError(f"stage3_attention_core_i8: a p code {int(step.max())} steps off "
                             f"the plain version's")
    B, L, W = qkv.shape[0], qkv.shape[1], kw["window"]
    nw = L // W
    keys = sum(min(nw, w + 2) - max(0, w - 1) for w in range(nw)) * W * W   # band pairs a head
    return int((step > 0).sum()), B * kw["local_heads"] * keys


def stage3_bwd_b32(results: dict, g) -> None:
    """``stage3_attention_bwd`` at Stage-3 B=32 (L 1024, d 512, 8 + 8
    heads, W 128; the linear heads in the larger chunks that batch gets):
    against its plain version per 32-column head group, the same bits on a
    second call, timed beside its bound."""
    import torch

    from biom3_tpu_torch.cli.measure_pencl import event_ms
    from biom3_tpu_torch.ops import kernels as K

    B, L, d, H, NL, W = 32, 1024, 512, 16, 8, 128
    qkv = torch.randn(B, L, 3 * d, generator=g, device=g.device).bfloat16()
    da = torch.randn(B, L, d, generator=g, device=g.device).bfloat16()
    kw = dict(heads=H, local_heads=NL, window=W)
    got = K.stage3_attention_bwd(qkv, da, **kw)
    want = K.stage3_attention_bwd_plain(qkv, da, **kw)
    err_abs, err_rel = rel_err(got, want, group=d // H)
    if err_rel > REL_TOL:
        raise AssertionError(f"stage3_attention_bwd B=32: max|Δ|/max|ref| = {err_rel:.3e}")
    if not torch.equal(got, K.stage3_attention_bwd(qkv, da, **kw)):
        raise AssertionError("stage3_attention_bwd B=32: a second call gave other bits")
    del want
    ms = event_ms(lambda: K.stage3_attention_bwd(qkv, da, **kw), TIMED_ITERS)
    flops = 10 * (d // H) * band_pairs(B, L, W, NL) + 10 * B * (H - NL) * L * (d // H) ** 2
    bound_ms = max(flops / PEAK_FLOPS, (2 * nbytes(qkv) + nbytes(da)) / PEAK_BYTES) * 1e3
    entry = results["stage3_attention_bwd"]
    entry.update(ms_b32=ms, bound_ms_b32=bound_ms)
    entry["max_abs_err"] = max(entry["max_abs_err"], err_abs)
    say("kernels", f"stage3_attention_bwd, Stage-3 B=32: max|Δ| {err_abs:.3e} rel {err_rel:.3e} "
                   f"kernel {ms:.4f} ms bound {bound_ms:.4f} ms ({bound_ms / ms:.0%})")


def bias_layernorm_b32(results: dict, g) -> None:
    """``bias_layernorm`` at Stage-3 B=32 (32768 rows of 512): xb equal to
    the plain version's, xn within the gate, the same bits on a second
    call, timed beside its bound (8 bytes an element)."""
    import torch

    from biom3_tpu_torch.cli.measure_pencl import event_ms
    from biom3_tpu_torch.ops import kernels as K

    B, L, d = 32, 1024, 512
    h = (torch.randn(B, L, d, generator=g, device=g.device) * 3.0).bfloat16()
    bias = torch.randn(B, d, generator=g, device=g.device).bfloat16()
    s = 1.0 + 0.1 * torch.randn(d, generator=g, device=g.device)
    t = 0.1 * torch.randn(d, generator=g, device=g.device)
    got, want = K.bias_layernorm(h, bias, s, t), K.bias_layernorm_plain(h, bias, s, t)
    if not torch.equal(got[0], want[0]):
        raise AssertionError("bias_layernorm B=32: xb differs from h + bias")
    err_abs, err_rel = rel_err(got[1], want[1])
    if err_rel > REL_TOL:
        raise AssertionError(f"bias_layernorm B=32: max|Δ|/max|ref| = {err_rel:.3e}")
    if not all(map(torch.equal, got, K.bias_layernorm(h, bias, s, t))):
        raise AssertionError("bias_layernorm B=32: a second call gave other bits")
    del want
    ms = event_ms(lambda: K.bias_layernorm(h, bias, s, t), TIMED_ITERS)
    bound_ms = (nbytes(h, bias, s, t) + B * L * d * 6) / PEAK_BYTES * 1e3
    entry = results["bias_layernorm"]
    entry.update(ms_b32=ms, bound_ms_b32=bound_ms)
    entry["max_abs_err"] = max(entry["max_abs_err"], err_abs)
    say("kernels", f"bias_layernorm, Stage-3 B=32: max|Δ| {err_abs:.3e} rel {err_rel:.3e} "
                   f"kernel {ms:.4f} ms bound {bound_ms:.4f} ms ({bound_ms / ms:.0%})")


def gather_head_full_grid(results: dict, g) -> None:
    """``gather_head`` at Stage-3 B=32 on the full grid (k = L = 1024: the
    head of every forward in confidence order and MaskGIT; 32768 rows of
    512, the (512, 29) head packed to 32 columns): within the gate of its
    plain version, the same bits on a second call, timed beside its bound
    (h read once, the logits written once)."""
    import torch

    from biom3_tpu_torch.cli.measure_pencl import event_ms
    from biom3_tpu_torch.ops import kernels as K

    B, L, d, C = 32, 1024, 512, 29
    h = (torch.randn(B, L, d, generator=g, device=g.device) * 3.0).bfloat16()
    pos = torch.arange(L, device=g.device, dtype=torch.int32).expand(B, L).contiguous()
    s = 1.0 + 0.1 * torch.randn(d, generator=g, device=g.device)
    t = 0.1 * torch.randn(d, generator=g, device=g.device)
    w = K.pad_head((torch.randn(d, C, generator=g, device=g.device) * d ** -0.5).bfloat16())
    hb = 0.1 * torch.randn(C, generator=g, device=g.device)
    got, want = K.gather_head(h, pos, s, t, w, hb), K.gather_head_plain(h, pos, s, t, w, hb)
    err_abs, err_rel = rel_err(got, want)
    if err_rel > REL_TOL:
        raise AssertionError(f"gather_head B=32 k=L: max|Δ|/max|ref| = {err_rel:.3e}")
    if not torch.equal(got, K.gather_head(h, pos, s, t, w, hb)):
        raise AssertionError("gather_head B=32 k=L: a second call gave other bits")
    del want
    ms = event_ms(lambda: K.gather_head(h, pos, s, t, w, hb), TIMED_ITERS)
    plain_ms = event_ms(lambda: K.gather_head_plain(h, pos, s, t, w, hb), TIMED_ITERS)
    bound_ms = (nbytes(h, pos, s, t, w, hb) + B * L * C * 4) / PEAK_BYTES * 1e3
    entry = results["gather_head"]
    entry.update(ms_kL_b32=ms, plain_ms_kL_b32=plain_ms, bound_ms_kL_b32=bound_ms)
    entry["max_abs_err"] = max(entry["max_abs_err"], err_abs)
    say("kernels", f"gather_head, Stage-3 B=32 k=L (32768 rows): max|Δ| {err_abs:.3e} rel "
                   f"{err_rel:.3e} kernel {ms:.4f} ms plain {plain_ms:.4f} ms bound "
                   f"{bound_ms:.4f} ms ({bound_ms / ms:.0%})")


# --------------------------------------------------------------------------
# phase 4: full-width forwards on the kernels vs the plain f32 modules
# --------------------------------------------------------------------------

def phase_models(pencl) -> dict:
    """``pencl``: the seeded full-width f32 PenCL (tanh GELU) on the host;
    it is back there when this returns.  Returns the ``stage3_graph``
    path's launch counts."""
    import torch

    from biom3_tpu_torch.cli.measure_pencl import event_ms
    from biom3_tpu_torch.config import BertConfig, ProteoScribeConfig
    from biom3_tpu_torch.io.state_dict import seeded_init_
    from biom3_tpu_torch.models.bert import BertEncoder
    from biom3_tpu_torch.models.fused_forward import make_stack_apply
    from biom3_tpu_torch.models.pencl import PenCL
    from biom3_tpu_torch.models.proteoscribe import ProteoScribe
    from biom3_tpu_torch.ops import kernels as K
    from biom3_tpu_torch.ops.bert_stack import bert_embed, bert_stack_arrays, fused_bert_cls
    from biom3_tpu_torch.ops.esm2_stack import esm2_stack_arrays, fused_esm2_cls

    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    int8 = dict(ff_quant="int8", proj_quant="int8")

    def gate(what: str, cos: float) -> None:
        if cos < COS_MIN:
            raise AssertionError(f"{what}: min cosine {cos} < {COS_MIN}")

    def inputs(B, k):
        ids = torch.randint(0, cfg.num_classes, (B, cfg.max_seq_len), generator=g, device=dev)
        ids = ids * (torch.rand(ids.shape, generator=g, device=dev) < 0.5)   # half absorbing
        t = torch.randint(0, cfg.num_timesteps, (B,), generator=g, device=dev)
        z = torch.randn((B, cfg.cond_dim), generator=g, device=dev)
        pos = torch.randint(0, cfg.max_seq_len, (B, k), generator=g, device=dev)
        return ids, t, z, pos

    cfg = ProteoScribeConfig()
    model = seeded_init_(ProteoScribe(cfg), SEED).to(dev).eval()
    B, k = 4, 8
    ids, t, z, pos = inputs(B, k)
    bf16_apply = make_stack_apply(model, dtype=torch.bfloat16, gelu="tanh")
    int8_apply = make_stack_apply(model, dtype=torch.bfloat16, gelu="tanh", **int8)
    with torch.no_grad():
        ref = model(ids, t, z)
        want = torch.gather(ref, 1, pos[..., None].expand(-1, -1, ref.shape[-1]))
        got = bf16_apply(ids, t, z, pos)
        got8 = int8_apply(ids, t, z, pos)
    torch.cuda.synchronize()
    cos, cos8, cos8b = min_cosine(got, want), min_cosine(got8, want), min_cosine(got8, got)
    say("models", f"fused_stack_logits (B={B}, k={k}, bf16, tanh) vs plain f32: "
                  f"min logit cosine {cos:.6f}, max|Δ| {float((got - want).abs().max()):.3e}; "
                  f"int8 FF + projections vs plain f32 {cos8:.6f}, vs bf16 {cos8b:.6f}")
    gate("stack logits bf16", cos)
    gate("stack logits int8 vs f32", cos8)
    gate("stack logits int8 vs bf16", cos8b)
    times = {}
    for Bt in (2, 32):
        args = inputs(Bt, 1)
        with torch.no_grad():
            times[Bt] = {name: event_ms(lambda fn=fn: fn(*args), 5)
                         for name, fn in (("bf16", bf16_apply), ("int8", int8_apply))}
    say("models", "stack forward ms (k=1, CUDA events, 5 calls): " + "; ".join(
        f"B={Bt} bf16 {v['bf16']:.3f} int8 {v['int8']:.3f}" for Bt, v in times.items()))

    # the graph path: the plain module with the band-local heads on the
    # local_window_attention kernel, bf16, full logits
    graph = ProteoScribe(cfg, attn_impl="kernel", dtype=torch.bfloat16).to(dev).eval()
    graph.load_state_dict(model.state_dict())
    K.reset_launches()
    with torch.no_grad():
        full = graph(ids, t, z)
    torch.cuda.synchronize()
    counts = K.launch_counts()
    check_path("stage3_graph", counts)
    if counts["local_window_attention"] != cfg.depth:
        raise AssertionError(f"local_window_attention launched {counts['local_window_attention']}"
                             f" times, expected {cfg.depth}")
    cos = min_cosine(full.reshape(-1, full.shape[-1]), ref.reshape(-1, ref.shape[-1]))
    say("models", f"ProteoScribe(attn_impl=kernel) (B={B}, bf16, every position) vs plain f32: "
                  f"min logit cosine {cos:.6f}; launches {counts}")
    gate("graph-path logits", cos)
    del model, graph, bf16_apply, int8_apply

    # BERT at its own initializer (N(0, 0.02²) matrices and tables, zero
    # biases, unit LayerNorms; HF BertPreTrainedModel._init_weights), where
    # the int8 gate applies; the port's generic seeding (N(0, 1/fan_in),
    # perturbed norms and biases) is reported beside it: at that weight
    # scale the post-LN tower's int8 recipe drifts past 0.999 in f32 too
    bcfg = BertConfig(vocab_size=30522)
    bert = BertEncoder(bcfg).to(dev).eval()
    x_ids = torch.randint(0, bcfg.vocab_size, (2, 512), generator=g, device=dev)
    for seeding in ("seeded_init_", "bert_init"):
        with torch.no_grad():
            if seeding == "seeded_init_":
                seeded_init_(bert.cpu(), SEED).to(dev)
            else:
                for name, prm in bert.named_parameters():
                    if prm.dim() >= 2:
                        prm.normal_(0.0, 0.02, generator=g)
                    elif name.endswith("weight"):
                        prm.fill_(1.0)
                    else:
                        prm.zero_()
        arrays = {q: bert_stack_arrays(bert, torch.bfloat16, **(int8 if q == "int8" else {}))
                  for q in ("bf16", "int8")}
        with torch.no_grad():
            want = bert(x_ids)["hidden"][:, 0]
            x0 = bert_embed(bert, x_ids, dtype=torch.bfloat16)
            run = {q: (lambda a=a: fused_bert_cls(x0, **a, heads=bcfg.num_heads, gelu="tanh"))
                   for q, a in arrays.items()}
            got, got8 = run["bf16"](), run["int8"]()
            bert_ms = {q: event_ms(fn, 5) for q, fn in run.items()}
        torch.cuda.synchronize()
        cos, cos8, cos8b = min_cosine(got, want), min_cosine(got8, want), min_cosine(got8, got)
        say("models", f"fused_bert_cls ({seeding}, B=2, L=512, bf16, tanh) vs plain f32 tower: "
                      f"min CLS cosine {cos:.6f}; int8 vs f32 {cos8:.6f}, vs bf16 {cos8b:.6f}; "
                      f"ms per call bf16 {bert_ms['bf16']:.3f} int8 {bert_ms['int8']:.3f}")
        gate("BERT CLS bf16", cos)
        if seeding == "bert_init":
            gate("BERT CLS int8 vs f32", cos8)
            gate("BERT CLS int8 vs bf16", cos8b)
        else:
            # the recipe's own drift at this seeding: the int8 chain's plain
            # versions in f32 on the host, against the f32 tower there
            cpu = copy.deepcopy(bert).cpu()
            ids_cpu = x_ids.cpu()
            with torch.no_grad():
                ref_cpu = cpu(ids_cpu)["hidden"][:, 0]
                out_cpu = fused_bert_cls(bert_embed(cpu, ids_cpu, dtype=torch.float32),
                                         **bert_stack_arrays(cpu, torch.float32, **int8),
                                         heads=bcfg.num_heads, gelu="tanh")
            say("models", f"fused_bert_cls ({seeding}): the int8 recipe in f32 (plain "
                          f"versions, host) vs the f32 tower: min CLS cosine "
                          f"{min_cosine(out_cpu, ref_cpu):.6f}")
            del cpu
    del bert, arrays, run

    ref = pencl.to(dev)
    ecfg = ref.config.esm
    x_p = esm_ids([1024, 400], 1024, g)
    arrays = {q: esm2_stack_arrays(ref.esm, torch.bfloat16, **(int8 if q == "int8" else {}))
              for q in ("bf16", "int8")}
    with torch.no_grad():
        want = ref.esm(x_p)["hidden"][:, 0]
        run = {q: (lambda a=a: fused_esm2_cls(x_p, **a, heads=ecfg.attention_heads, gelu="tanh"))
               for q, a in arrays.items()}
        got, got8 = run["bf16"](), run["int8"]()
        esm_ms = {q: event_ms(fn, 3) for q, fn in run.items()}
    torch.cuda.synchronize()
    cos, cos8, cos8b = min_cosine(got, want), min_cosine(got8, want), min_cosine(got8, got)
    say("models", f"fused_esm2_cls (B=2, L=1024, lengths 1024/400, bf16, tanh) vs plain f32 "
                  f"tower: min CLS cosine {cos:.6f}; int8 vs f32 {cos8:.6f}, vs bf16 "
                  f"{cos8b:.6f}; ms per call bf16 {esm_ms['bf16']:.3f} int8 {esm_ms['int8']:.3f}")
    gate("ESM2 CLS bf16", cos)
    gate("ESM2 CLS int8 vs f32", cos8)
    gate("ESM2 CLS int8 vs bf16", cos8b)
    del arrays, run

    with torch.device(dev):
        graph = PenCL(ref.config, attn_impl="kernel", gelu="tanh")
    graph.load_state_dict(ref.state_dict())
    graph = graph.to(torch.bfloat16).eval()
    x_t = torch.randint(0, ref.config.bert.vocab_size, (2, 512), generator=g, device=dev)
    with torch.no_grad():
        want, got = ref(x_t, x_p), graph(x_t, x_p)
    torch.cuda.synchronize()
    cos = min(min_cosine(got[key], want[key]) for key in want)
    say("models", f"PenCL graph path (B=2, attn_impl=kernel, bf16) vs plain f32 PenCL: "
                  f"min latent cosine {cos:.6f}")
    gate("PenCL graph latents", cos)
    del graph, want, got
    pencl.cpu()
    torch.cuda.empty_cache()
    return {"stage3_graph": counts}


def check_path(path: str, counts: dict) -> None:
    """The path launched every kernel of its own and no other."""
    launched = {name for name, n in counts.items() if n}
    if launched != PATH_KERNELS[path]:
        raise AssertionError(f"{path}: launched {sorted(launched)}, expected "
                             f"{sorted(PATH_KERNELS[path])} ({counts})")


# --------------------------------------------------------------------------
# phase 5: the text→protein CLI at full width
# --------------------------------------------------------------------------

VALID = set("ACDEFGHIKLMNPQRSTVWY" "XUZBO" "-")


def write_stage_files(root: pathlib.Path) -> dict:
    """Seeded random full-width weights in the reference .bin layouts, the
    three stage configs and a synthetic wordpiece vocab → CLI flags."""
    import torch

    from biom3_tpu_torch.cli.measure_pencl import stage1_config

    from biom3_tpu_torch.config import Config, FacilitatorConfig, PenCLConfig, ProteoScribeConfig
    from biom3_tpu_torch.io.state_dict import seeded_init_
    from biom3_tpu_torch.models.facilitator import Facilitator
    from biom3_tpu_torch.models.pencl import PenCLText
    from biom3_tpu_torch.models.proteoscribe import ProteoScribe

    stage = {
        1: stage1_config(root),
        2: {"emb_dim": 512, "hid_dim": 1024, "dropout": 0.0},
        3: {"num_replicas": 2, "batch_size_sample": 32, "diffusion_steps": 1024,
            "num_classes": 29, "text_emb_dim": 512, "transformer_dim": 512,
            "transformer_heads": 16, "transformer_depth": 16, "transformer_blocks": 1,
            "transformer_local_heads": 8, "transformer_local_size": 128},
    }
    models = {
        1: PenCLText(PenCLConfig.from_stage_config(Config(stage[1]))),
        2: Facilitator(FacilitatorConfig.from_stage_config(Config(stage[2]))),
        3: ProteoScribe(ProteoScribeConfig.from_stage_config(Config(stage[3]))),
    }
    flags = []
    for n in (1, 2, 3):
        (root / f"stage{n}.json").write_text(json.dumps(stage[n]))
        torch.save(seeded_init_(models[n], SEED + n).state_dict(), root / f"stage{n}.bin")
        flags += [f"--stage{n}_json", str(root / f"stage{n}.json"),
                  f"--stage{n}_model", str(root / f"stage{n}.bin")]
    return {"flags": flags, "depth": stage[3]["transformer_depth"],
            "steps": stage[3]["diffusion_steps"]}


INPAINT_UNKNOWNS = 40   # '?' in the 200-residue partial design


def partial_design(seed: int, n: int = 200) -> str:
    """A seeded n-residue design with ``INPAINT_UNKNOWNS`` residues as '?'."""
    rng = np.random.default_rng(seed)
    seq = rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n)
    seq[rng.choice(n, INPAINT_UNKNOWNS, replace=False)] = "?"
    return "".join(seq)


def check_inpainted(template: str, seqs) -> int:
    """Every committed residue of ``template`` in place and every '?'
    replaced by a decode-table token (a marker token is stripped by the
    decode, so a fill may be empty) → the number of fills that are
    residues."""
    fill = "([" + re.escape("".join(sorted(VALID))) + "]?)"
    pattern = re.compile("^" + "".join(fill if c == "?" else re.escape(c) for c in template)
                         + "$")
    residues = 0
    for s in seqs:
        m = pattern.match(s)
        if "?" in s or m is None:
            raise AssertionError(f"inpainted design does not keep its template: {s[:80]!r}")
        residues += sum(1 for g in m.groups() if g and g != "-")
    return residues


def phase_e2e(root: pathlib.Path, files: dict) -> dict:
    """``run_e2e`` at its default (Stage 3 and the text tower in int8), then
    with Stage 3 in bf16 (``--ff-quant none --proj-quant none``), then the
    fast modes at the default: MaskGIT in 16 steps and confidence order at
    k = 8 (the stack forward on the full grid), then ``--inpaint_sequence``
    (a 200-residue design with 40 '?': the confidence-order inpainter at
    the engine's chunk of 128 positions, early exit after the first chunk)
    → each path's launch counts.  Every run: 1 prompt x 2 replicas at
    temperature 1, distinct replicas, ``stage3_attention_core`` depth times
    a forward and ``gather_head`` once a forward."""
    import torch

    from biom3_tpu_torch.cli import run_e2e
    from biom3_tpu_torch.ops import kernels as K

    (root / "prompts.txt").write_text(
        "PROTEIN NAME: kinase. FUNCTION: catalyzes transport with atp binding activity\n")
    steps = files["steps"]
    runs = (("e2e", [], steps),
            ("e2e_bf16", ["--ff-quant", "none", "--proj-quant", "none"], steps),
            ("e2e_maskgit", ["--sampler", "maskgit", "--maskgit_steps", "16"], 16),
            ("e2e_confidence", ["--decode_order", "confidence", "--positions_per_step", "8"],
             steps // 8),
            # chunk_steps 128 (the engine's default, in positions) divides L:
            # one chunk fills the 40 unknowns, the exit check ends the run
            ("e2e_inpaint", ["--inpaint_sequence", partial_design(SEED)], 128))
    counts, walls = {}, {}
    for path, extra, forwards in runs:
        out = root / f"{path}.pt"
        K.reset_launches()
        t0 = time.perf_counter()
        run_e2e.main([*files["flags"], "--prompts", str(root / "prompts.txt"),
                      "--output_path", str(out), "--device", "cuda", "--num_replicas", "2",
                      "--seed", str(SEED), *extra])
        torch.cuda.synchronize()
        walls[path] = time.perf_counter() - t0
        counts[path] = K.launch_counts()
        saved = torch.load(out, weights_only=False)
        z_t, z_c = np.asarray(saved["z_t"]), np.asarray(saved["z_c"])
        if z_t.shape != (1, 512) or z_c.shape != (1, 512):
            raise AssertionError(f"z_t {z_t.shape}, z_c {z_c.shape}: expected (1, 512)")
        if not (np.isfinite(z_t).all() and np.isfinite(z_c).all()):
            raise AssertionError("non-finite z_t / z_c")
        seqs = [s for rep in saved["sequences"].values() for s in rep]
        if len(seqs) != 2:
            raise AssertionError(f"expected 2 sequences, got {len(seqs)}")
        check_sequences(seqs)
        note = ""
        if path == "e2e_inpaint":
            residues = check_inpainted(extra[1], seqs)
            note = f" ({residues} of {2 * INPAINT_UNKNOWNS} fills are residues)"
        if seqs[0] == seqs[1]:
            raise AssertionError(f"{path}: the two replicas are identical")
        check_path(path, counts[path])
        # one batch of the two replicas: a stack forward is `depth` attention
        # launches and one head launch
        for name, want in (("stage3_attention_core", files["depth"] * forwards),
                           ("gather_head", forwards)):
            if counts[path][name] != want:
                raise AssertionError(f"{path}: {name} launched {counts[path][name]} times, "
                                     f"expected {want} ({forwards} forwards)")
        flags = " ".join(extra) if path != "e2e_inpaint" else "--inpaint_sequence (200, 40 ?)"
        say("e2e", f"{path}: 1 prompt x 2 replicas, {forwards} forwards {flags}: "
                   f"{walls[path]:.2f} s wall; lengths {[len(s) for s in seqs]}{note}; "
                   f"launches {counts[path]}")
    say("e2e", "wall s, set-up included: " + " ".join(f"{p} {w:.2f}" for p, w in walls.items()))
    return counts


def phase_sample_clis(root: pathlib.Path, files: dict) -> dict:
    """The Stage-2 and Stage-3 sample CLIs on the card, on phase 5's files:
    ``run_facilitator_sample`` on seeded z_t / z_p of 3 prompts, then
    ``run_proteoscribe_sample --sampler maskgit`` on its z_c (2 replicas
    each) → each path's launch counts."""
    import torch

    from biom3_tpu_torch.cli import run_facilitator_sample, run_proteoscribe_sample
    from biom3_tpu_torch.ops import kernels as K

    flag = dict(zip(files["flags"][::2], files["flags"][1::2]))
    g = torch.Generator().manual_seed(SEED)
    torch.save({"z_t": torch.randn(3, 512, generator=g), "z_p": torch.randn(3, 512, generator=g)},
               root / "embeddings.pt")
    counts = {}
    t0 = time.perf_counter()
    K.reset_launches()
    run_facilitator_sample.main(["--input_data_path", str(root / "embeddings.pt"),
                                 "--output_data_path", str(root / "facilitated.pt"),
                                 "--model_path", flag["--stage2_model"],
                                 "--json_path", flag["--stage2_json"], "--device", "cuda"])
    counts["facilitator_sample"] = K.launch_counts()
    check_path("facilitator_sample", counts["facilitator_sample"])
    z_c = np.asarray(torch.load(root / "facilitated.pt", weights_only=False)["z_c"])
    if z_c.shape != (3, 512) or not np.isfinite(z_c).all():
        raise AssertionError(f"run_facilitator_sample: z_c {z_c.shape}, finite "
                             f"{np.isfinite(z_c).all()}")
    t1 = time.perf_counter()
    K.reset_launches()
    run_proteoscribe_sample.main(["--json_path", flag["--stage3_json"],
                                  "--model_path", flag["--stage3_model"],
                                  "--input_path", str(root / "facilitated.pt"),
                                  "--output_path", str(root / "designs.pt"), "--device", "cuda",
                                  "--sampler", "maskgit", "--seed", str(SEED)])
    torch.cuda.synchronize()
    counts["proteoscribe_sample"] = K.launch_counts()
    check_path("proteoscribe_sample", counts["proteoscribe_sample"])
    designs = torch.load(root / "designs.pt", weights_only=False)
    seqs = [s for rep in designs.values() for s in rep]
    if sorted(designs) != ["replica_0", "replica_1"] or len(seqs) != 6:
        raise AssertionError(f"run_proteoscribe_sample: {sorted(designs)}, {len(seqs)} designs")
    check_sequences(seqs)
    forwards = 16                        # one batch of 2 replicas a prompt
    want = 3 * forwards
    if counts["proteoscribe_sample"]["gather_head"] != want:
        raise AssertionError(f"run_proteoscribe_sample: gather_head launched "
                             f"{counts['proteoscribe_sample']['gather_head']} times, "
                             f"expected {want}")
    say("sample", f"run_facilitator_sample: 3 rows, {t1 - t0:.2f} s wall; "
                  f"run_proteoscribe_sample --sampler maskgit: 3 prompts x 2 replicas, "
                  f"{time.perf_counter() - t1:.2f} s wall; launches "
                  f"{counts['proteoscribe_sample']}")
    return counts


SWEEP_PROMPTS, SWEEP_REPLICAS, SWEEP_BATCH, SWEEP_K = 4, 8, 32, 8
SWEEP_ROWS_PER_S: dict[str, float] = {}   # path → rows/s of the sweep phase, for the mesh's


def phase_sweep(root: pathlib.Path, files: dict) -> dict:
    """The generation sweep (``pipeline/sweep.SweepRunner``) on phase 5's
    Stage-3 ``.bin``: 4 seeded z_c prompts x 8 replicas in one slab of 32
    rows, k = 8 (128 forwards on the bf16 stack forward), then the same
    with the band heads' products in int8 (``attn_quant="int8"``: one
    forward's logits within COS_MIN of the bf16-attention forward's), then
    ``cli/run_eval.py`` as a subprocess on the int8 sweep's designs against
    seeded references → each path's launch counts."""
    import torch

    from biom3_tpu_torch.config import load_json_config
    from biom3_tpu_torch.models.fused_forward import make_stack_apply
    from biom3_tpu_torch.ops import kernels as K
    from biom3_tpu_torch.pipeline.stage3 import ProteoScribeEngine
    from biom3_tpu_torch.pipeline.sweep import SweepRunner

    t_phase = time.perf_counter()
    flag = dict(zip(files["flags"][::2], files["flags"][1::2]))
    engine = ProteoScribeEngine(load_json_config(flag["--stage3_json"]), flag["--stage3_model"],
                                device="cuda", dtype=torch.bfloat16, ff_quant="none",
                                proj_quant="none")
    model, L, depth = engine.model, files["steps"], files["depth"]
    del engine
    g = torch.Generator().manual_seed(SEED + 20)
    z_c = torch.randn(SWEEP_PROMPTS, 512, generator=g).numpy()
    applies = {"sweep": make_stack_apply(model, dtype=torch.bfloat16, gelu="tanh"),
               "sweep_i8": make_stack_apply(model, dtype=torch.bfloat16, gelu="tanh",
                                            attn_quant="int8")}
    # the int8 attention's drift: one forward on a half-revealed grid
    dev = torch.device("cuda")
    x = torch.randint(1, 29, (SWEEP_PROMPTS, L), generator=g).int()
    x[torch.rand(SWEEP_PROMPTS, L, generator=g) < 0.5] = 0
    pos = torch.arange(L, dtype=torch.int32).expand(SWEEP_PROMPTS, L).contiguous()
    args = (x.to(dev), torch.full((SWEEP_PROMPTS,), L // 2, device=dev),
            torch.as_tensor(z_c, device=dev), pos.to(dev))
    cos = min_cosine(applies["sweep_i8"](*args).reshape(-1, 29),
                     applies["sweep"](*args).reshape(-1, 29))
    say("sweep", f"int8 band attention against bf16, one stack forward at B={SWEEP_PROMPTS} on "
                 f"the full grid: min logit cosine {cos:.6f}")
    if cos < COS_MIN:
        raise AssertionError(f"int8 vs bf16 attention logit cosine {cos} < {COS_MIN}")
    counts, walls, designs = {}, {}, {}
    rows, forwards = SWEEP_PROMPTS * SWEEP_REPLICAS, L // SWEEP_K
    smi = card()
    for path, apply in applies.items():
        runner = SweepRunner(apply, L, device="cuda", temperature=1.0, chunk_steps=128,
                             positions_per_step=SWEEP_K, apply_takes_positions=True)
        K.reset_launches()
        t0 = time.perf_counter()
        seqs = runner.run(z_c, num_replicas=SWEEP_REPLICAS, seed=SEED, device_batch=SWEEP_BATCH)
        torch.cuda.synchronize()
        walls[path] = time.perf_counter() - t0
        counts[path] = K.launch_counts()
        check_path(path, counts[path])
        core = "stage3_attention_core_i8" if path == "sweep_i8" else "stage3_attention_core"
        for name, want in ((core, depth * forwards), ("gather_head", forwards)):
            if counts[path][name] != want:
                raise AssertionError(f"{path}: {name} launched {counts[path][name]} times, "
                                     f"expected {want} ({forwards} forwards)")
        flat_seqs = [s for rep in seqs for s in rep]
        if [len(rep) for rep in seqs] != [SWEEP_REPLICAS] * SWEEP_PROMPTS:
            raise AssertionError(f"{path}: {[len(rep) for rep in seqs]} replicas a prompt")
        check_sequences(flat_seqs)
        if len(set(flat_seqs)) < 2:
            raise AssertionError(f"{path}: every design is the same")
        designs[path] = seqs
        SWEEP_ROWS_PER_S[path] = rows / walls[path]
        say("sweep", f"{path}: {SWEEP_PROMPTS} prompts x {SWEEP_REPLICAS} replicas, one slab of "
                     f"{SWEEP_BATCH}, k = {SWEEP_K} ({forwards} forwards): {walls[path]:.2f} s "
                     f"wall, {rows / walls[path]:.2f} rows/s ({smi}); launches {counts[path]}")
    del applies, model
    torch.cuda.empty_cache()

    refs = ["".join(np.random.default_rng(SEED + 21).choice(list("ACDEFGHIKLMNPQRSTVWY"), 200))
            for _ in range(SWEEP_PROMPTS)]
    torch.save({f"replica_{r}": [designs["sweep_i8"][p][r] for p in range(SWEEP_PROMPTS)]
                for r in range(SWEEP_REPLICAS)}, root / "sweep_designs.pt")
    torch.save({"sequence": refs}, root / "sweep_refs.pt")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "biom3_tpu_torch.cli.run_eval", "--designs_path",
                        str(root / "sweep_designs.pt"), "--reference_path",
                        str(root / "sweep_refs.pt"), "--output_path", str(root / "eval.pt")],
                       capture_output=True, text=True, timeout=300)
    wall = time.perf_counter() - t0
    if r.returncode != 0:
        raise AssertionError(f"run_eval exited {r.returncode}: {r.stderr[-2000:]}")
    report = json.loads(r.stdout)
    scores = report.get("vs_reference", {})
    if report["stats"]["n"] != rows or sorted(scores) != sorted(
            f"replica_{i}" for i in range(SWEEP_REPLICAS)):
        raise AssertionError(f"run_eval report: n {report['stats']['n']}, {sorted(scores)}")
    soft = [v["blosum_soft_acc"] for v in scores.values() if "blosum_soft_acc" in v]
    if not soft or not all(0.0 <= a <= 1.0 for a in soft):
        raise AssertionError(f"run_eval scores: {scores}")
    say("sweep", f"run_eval on the int8 sweep's {rows} designs against {SWEEP_PROMPTS} seeded "
                 f"references: {wall:.2f} s wall (a subprocess); BLOSUM soft accuracy "
                 f"{min(soft):.4f}-{max(soft):.4f} over {len(soft)} replicas, unique fraction "
                 f"{report['stats']['unique_fraction']:.3f}")
    say("sweep", f"the sweep phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


# --------------------------------------------------------------------------
# the device mesh: a sharded stack forward, the sweep and a server over
# positions that share the card, ring attention
# --------------------------------------------------------------------------

MESH_B = 32                     # the sharded forward's global batch
RING_B, RING_H, RING_D, RING_L, RING_TP = 1, 20, 64, 4096, 4   # ESM2-650M heads, long context
RING_PAD = 0.1                  # share of PAD keys
RING_ITERS = 5


def phase_mesh(root: pathlib.Path, files: dict, pencl) -> dict:
    """The mesh paths on phase 5's Stage-3 ``.bin`` and the seeded ESM2-650M
    of phase 4 → the ``sweep_mesh``, ``serve_mesh`` and
    ``serve_mesh_inpaint`` paths' launch counts.  ``make_mesh`` over the
    cards; then on (dp 2, fsdp 2) positions of one card: the sharded stack
    forward at B = 32 (k = 8), each shard's logits bit-equal to the
    one-device forward on its 8 rows, in bf16 and int8 band attention;
    ``SweepRunner`` on that mesh (the sweep phase's 4 × 8 rows, k = 8);
    an in-process ``BioM3Server`` on a dp-2 mesh (2 generate requests, one
    /v1/inpaint); ring attention at ESM2-650M's head shapes over tp = 4
    positions against ``flash_attention_plain``, and the 33-layer ESM2-650M
    with ``attn_impl="ring"`` against ``"plain"`` on a 1022-residue
    protein.  With two cards or more, ``run_server --mesh_dp 2`` as a
    subprocess."""
    import threading

    import torch

    from biom3_tpu_torch.cli import run_server
    from biom3_tpu_torch.cli.measure_pencl import event_ms
    from biom3_tpu_torch.config import load_json_config
    from biom3_tpu_torch.models.esm2 import ESM2
    from biom3_tpu_torch.models.fused_forward import make_sharded_stack_apply, make_stack_apply
    from biom3_tpu_torch.ops import kernels as K
    from biom3_tpu_torch.ops.ring_attention import ring_attention
    from biom3_tpu_torch.parallel import MeshConfig, make_mesh
    from biom3_tpu_torch.pipeline.stage3 import ProteoScribeEngine
    from biom3_tpu_torch.pipeline.sweep import SweepRunner

    t_phase = time.perf_counter()
    n_cards = torch.cuda.device_count()
    say("mesh", f"make_mesh(MeshConfig(dp={n_cards})): {make_mesh(MeshConfig(dp=n_cards))}")
    dev = torch.device("cuda", 0)
    mesh = make_mesh(MeshConfig(dp=2, fsdp=2), [dev] * 4)
    shards, smi = mesh.batch_shards, card()
    flag = dict(zip(files["flags"][::2], files["flags"][1::2]))
    engine = ProteoScribeEngine(load_json_config(flag["--stage3_json"]), flag["--stage3_model"],
                                device="cuda", dtype=torch.bfloat16, ff_quant="none",
                                proj_quant="none")
    model, L, depth = engine.model, files["steps"], files["depth"]
    del engine

    # the sharded stack forward against the one-device forward, shard by shard
    g = torch.Generator().manual_seed(SEED + 30)
    x = torch.randint(1, 29, (MESH_B, L), generator=g).int()
    x[torch.rand(MESH_B, L, generator=g) < 0.5] = 0
    args = [a.to(dev) for a in (x, torch.randint(0, L, (MESH_B,), generator=g),
                                torch.randn(MESH_B, 512, generator=g),
                                torch.argsort(torch.rand(MESH_B, L, generator=g))[:, :SWEEP_K]
                                .int().contiguous())]
    rows = MESH_B // shards
    for attn_quant in ("none", "int8"):
        kw = dict(dtype=torch.bfloat16, gelu="tanh", attn_quant=attn_quant)
        got = make_sharded_stack_apply(model, mesh, **kw)(*args)
        one = make_stack_apply(model, **kw)
        for s in range(shards):
            part = slice(s * rows, (s + 1) * rows)
            if not torch.equal(got[part], one(*(a[part] for a in args))):
                raise AssertionError(f"sharded stack forward ({attn_quant} attention): shard {s} "
                                     f"differs from the one-device forward on its {rows} rows")
        if got.shape != (MESH_B, SWEEP_K, 29) or not got.isfinite().all():
            raise AssertionError(f"sharded stack forward: {tuple(got.shape)}, finite "
                                 f"{bool(got.isfinite().all())}")
        say("mesh", f"sharded stack forward on {mesh}, B={MESH_B}, k={SWEEP_K}, "
                    f"{'int8' if attn_quant == 'int8' else 'bf16'} band attention: every shard's "
                    f"logits bit-equal to the one-device forward on its {rows} rows")

    # the sweep on the mesh
    g = torch.Generator().manual_seed(SEED + 20)   # the sweep phase's prompts
    z_c = torch.randn(SWEEP_PROMPTS, 512, generator=g).numpy()
    runner = SweepRunner(make_sharded_stack_apply(model, mesh, dtype=torch.bfloat16, gelu="tanh"),
                         L, mesh=mesh, temperature=1.0, chunk_steps=128,
                         positions_per_step=SWEEP_K, apply_takes_positions=True)
    n_rows, forwards = SWEEP_PROMPTS * SWEEP_REPLICAS, L // SWEEP_K
    K.reset_launches()
    t0 = time.perf_counter()
    seqs = runner.run(z_c, num_replicas=SWEEP_REPLICAS, seed=SEED, device_batch=SWEEP_BATCH)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"sweep_mesh": K.launch_counts()}
    check_path("sweep_mesh", counts["sweep_mesh"])
    for name, want in (("stage3_attention_core", shards * depth * forwards),
                       ("gather_head", shards * forwards)):
        if counts["sweep_mesh"][name] != want:
            raise AssertionError(f"sweep_mesh: {name} launched {counts['sweep_mesh'][name]} "
                                 f"times, expected {want} ({forwards} forwards on {shards} shards)")
    flat_seqs = [s for rep in seqs for s in rep]
    if [len(rep) for rep in seqs] != [SWEEP_REPLICAS] * SWEEP_PROMPTS:
        raise AssertionError(f"sweep_mesh: {[len(rep) for rep in seqs]} replicas a prompt")
    check_sequences(flat_seqs)
    if len(set(flat_seqs)) < 2:
        raise AssertionError("sweep_mesh: every design is the same")
    say("mesh", f"sweep_mesh: SweepRunner on {mesh}, {SWEEP_PROMPTS} prompts x "
                f"{SWEEP_REPLICAS} replicas, one slab of {SWEEP_BATCH}, k = {SWEEP_K} ({forwards} "
                f"forwards, {rows} rows a shard): {wall:.2f} s wall, {n_rows / wall:.2f} rows/s "
                f"against the one-device sweep's {SWEEP_ROWS_PER_S['sweep']:.2f} ({smi}); "
                f"launches {counts['sweep_mesh']}")
    del runner, model
    torch.cuda.empty_cache()

    # an in-process server on a dp-2 mesh: exact mode, continuous inpaint rows
    serve_mesh = make_mesh(MeshConfig(dp=2), [dev] * 2)
    server = run_server.build_server(run_server.parse_arguments(
        [*files["flags"], "--device", "cuda", "--port", "0", "--rows_per_dispatch", "4",
         "--continuous_inpaint"]), mesh=serve_mesh)
    server.start()
    base = f"http://{server.host}:{server.port}"
    try:
        out = [None, None]

        def client(i):
            out[i] = http_json(f"{base}/v1/generate", {"prompt": SERVE_PROMPTS[i],
                                                        "num_replicas": 2, "seed": 7 + i})
        K.reset_launches()
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,)) for i in range(2)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
        wall = time.perf_counter() - t0
        torch.cuda.synchronize()
        counts["serve_mesh"] = K.launch_counts()
        inp = serve_inpaint(base, 64, depth, shards=2, path="serve_mesh_inpaint")
        counts["serve_mesh_inpaint"] = inp["counts"]
        metrics = http_json(f"{base}/v1/metrics")
    finally:
        server.close()
    if any(o is None for o in out):
        raise AssertionError("a mesh server request did not answer")
    check_sequences([s for o in out for s in o["results"][0]["sequences"]])
    check_path("serve_mesh", counts["serve_mesh"])
    core, heads = (counts["serve_mesh"][n] for n in ("stage3_attention_core", "gather_head"))
    if heads % 2 or core != depth * heads:
        raise AssertionError(f"serve_mesh: stage3_attention_core {core}, gather_head {heads}: "
                             f"not {depth} cores and 2 shards a forward")
    say("mesh", f"BioM3Server on {serve_mesh} (continuous, exact, int8, rows_per_dispatch 4): "
                f"2 requests x 2 replicas in {wall:.2f} s wall ({heads // 2} forwards on 2 shards); "
                f"/v1/inpaint {inp['wall_s']:.3f} s, template kept, {inp['residues']} of 80 fills "
                f"residues; device {metrics['device']}")
    if n_cards >= 2:
        up, total = run_server_cli([*files["flags"], "--device", "cuda", "--port", "0",
                                    "--rows_per_dispatch", "4", "--num_replicas", "1",
                                    "--mesh_dp", "2"])
        say("mesh", f"run_server --mesh_dp 2 over 2 cards: up in {up:.2f} s, 1 request "
                    f"answered, SIGTERM → exit 0 ({total:.2f} s in all)")
    else:
        say("mesh", "run_server --mesh_dp 2 as a subprocess: skipped, one card")

    # ring attention at ESM2-650M's head shapes, L = 4096, over tp = 4 positions
    ring_mesh = make_mesh(MeshConfig(tp=RING_TP), [dev] * RING_TP)
    g = torch.Generator().manual_seed(SEED + 31)
    q, k, v = (torch.randn(RING_B, RING_H, RING_L, RING_D, generator=g).to(dev, torch.bfloat16)
               for _ in range(3))
    pad = (torch.rand(RING_B, RING_L, generator=g) < RING_PAD).to(dev)
    got = ring_attention(q, k, v, ring_mesh, padding_mask=pad)
    want = K.flash_attention_plain(q, k, v, pad.int())
    err, rel = rel_err(got, want)
    ring_ms = event_ms(lambda: ring_attention(q, k, v, ring_mesh, padding_mask=pad), RING_ITERS)
    plain_ms = event_ms(lambda: K.flash_attention_plain(q, k, v, pad.int()), RING_ITERS)
    say("mesh", f"ring_attention over {ring_mesh} (B {RING_B}, H {RING_H}, D {RING_D}, L "
                f"{RING_L}, {int(pad.sum())} PAD keys, bf16): max|Δ| {err:.3e} (rel {rel:.3e}) "
                f"against flash_attention_plain; {ring_ms:.3f} ms against {plain_ms:.3f} ms "
                f"({smi})")
    if rel > REL_TOL:
        raise AssertionError(f"ring_attention vs flash_attention_plain rel {rel} > {REL_TOL}")
    del q, k, v, got, want

    # the 33-layer ESM2-650M, ring against plain attention, on a 1022-residue protein
    esm_cfg = pencl.esm.config
    tokens = torch.cat([torch.zeros(1, 1, dtype=torch.long),
                        torch.randint(4, 24, (1, 1022), generator=g),
                        torch.full((1, 1), 2, dtype=torch.long)], dim=1).to(dev)
    hidden, ms = {}, {}
    for impl in ("ring", "plain"):
        with dev:   # initialised on the card, then given the seeded weights
            tower = ESM2(esm_cfg, attn_impl=impl, gelu="tanh",
                         mesh=ring_mesh if impl == "ring" else None)
        tower.load_state_dict(pencl.esm.state_dict())
        tower.eval()
        with torch.no_grad():
            hidden[impl] = tower(tokens)["hidden"]
            ms[impl] = event_ms(lambda: tower(tokens), 2)
        del tower
        torch.cuda.empty_cache()
    cos = min_cosine(hidden["ring"][0], hidden["plain"][0])
    say("mesh", f"ESM2-650M ({ESM_LAYERS} layers, f32) on a 1022-residue protein, "
                f"attn_impl=ring over tp = {RING_TP} against plain: min cosine {cos:.6f}; "
                f"{ms['ring']:.1f} ms against {ms['plain']:.1f} ms a forward ({smi})")
    if cos < COS_MIN:
        raise AssertionError(f"ESM2 ring vs plain cosine {cos} < {COS_MIN}")
    say("mesh", f"the mesh phase took {time.perf_counter() - t_phase:.1f} s")
    return counts


STAGE2_PAIRS, STAGE2_B, STAGE2_EPOCHS = 4096, 64, 2


def phase_train_stage2(root: pathlib.Path) -> dict:
    """Stage-2 training on the card: ``run_train_stage2`` on 4096 seeded
    synthetic (z_t, z_p) pairs of width 512 (z_p a fixed seeded map of
    z_t, so that the loss can fall), the published Facilitator widths
    (512 → 1024 → 512), MMD, batch 64, 2 epochs, ``--export_bin``, then
    ``run_facilitator_sample`` on the exported .bin; the validation loss
    must be finite and fall.  Then ms a step of the same train step
    (``training/stage2_task``) at B=64 by CUDA events → the path's launch
    counts (none: the Facilitator runs no kernel of the port's)."""
    import contextlib
    import io

    import torch

    from biom3_tpu_torch.cli import run_facilitator_sample, run_train_stage2
    from biom3_tpu_torch.config import Config, FacilitatorConfig
    from biom3_tpu_torch.io.state_dict import seeded_init_
    from biom3_tpu_torch.models.facilitator import Facilitator
    from biom3_tpu_torch.ops import kernels as K
    from biom3_tpu_torch.training.optim import make_optimizer
    from biom3_tpu_torch.training.stage2_task import make_stage2_train_step
    from biom3_tpu_torch.training.state import TrainState

    rng = np.random.default_rng(SEED)
    z_t = rng.standard_normal((STAGE2_PAIRS, 512)).astype(np.float32)
    mix = (rng.standard_normal((512, 512)) / np.sqrt(512)).astype(np.float32)
    torch.save({"text_embedding": torch.from_numpy(z_t),
                "protein_embedding": torch.from_numpy(np.tanh(z_t @ mix))}, root / "pairs.pt")
    cfg = {"emb_dim": 512, "hid_dim": 1024, "dropout": 0.0, "batch_size": STAGE2_B,
           "valid_size": 0.2, "seed": SEED, "loss_type": "MMD"}
    (root / "stage2_train.json").write_text(json.dumps(cfg))
    buf = io.StringIO()
    K.reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        run_train_stage2.main(["--json_path", str(root / "stage2_train.json"),
                               "--output_dir", str(root / "stage2_out"),
                               "--swissprot_data_path", str(root / "pairs.pt"),
                               "--epochs", str(STAGE2_EPOCHS), "--lr", "1e-3",
                               "--export_bin", str(root / "facilitator.bin"),
                               "--device", "cuda"])
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.save({"z_t": torch.from_numpy(z_t[:8]), "z_p": torch.from_numpy(np.tanh(
            z_t[:8] @ mix))}, root / "stage2_in.pt")
        run_facilitator_sample.main(["--input_data_path", str(root / "stage2_in.pt"),
                                     "--output_data_path", str(root / "stage2_out.pt"),
                                     "--model_path", str(root / "facilitator.bin"),
                                     "--json_path", str(root / "stage2_train.json"),
                                     "--device", "cuda"])
    counts = K.launch_counts()
    out = buf.getvalue()
    print(out, end="", flush=True)
    check_path("train_stage2", counts)
    val = [float(line.split("val_loss=")[1]) for line in out.splitlines()
           if line.startswith("epoch ")]
    steps = STAGE2_EPOCHS * (STAGE2_PAIRS - round(STAGE2_PAIRS * 0.2)) // STAGE2_B
    if len(val) != STAGE2_EPOCHS or not np.isfinite(val).all() or not val[-1] < val[0]:
        raise AssertionError(f"run_train_stage2: validation losses {val} (finite, falling)")
    if f"saved final checkpoint at step {steps}" not in out:
        raise AssertionError(f"run_train_stage2: expected {steps} steps")
    z_c = np.asarray(torch.load(root / "stage2_out.pt", weights_only=False)["z_c"])
    if z_c.shape != (8, 512) or not np.isfinite(z_c).all():
        raise AssertionError(f"run_facilitator_sample on the trained .bin: z_c {z_c.shape}")

    # ms a step of the same step function, at the CLI's batch
    dev = torch.device("cuda")
    model = seeded_init_(Facilitator(FacilitatorConfig.from_stage_config(Config(cfg))),
                         SEED).to(dev)
    step = make_stage2_train_step(TrainState(model, make_optimizer(
        "AdamW", model.parameters(), 1e-3)), loss_type="MMD")
    batch = {"z_t": torch.from_numpy(z_t[:STAGE2_B]).to(dev),
             "z_p": torch.from_numpy(np.tanh(z_t[:STAGE2_B] @ mix)).to(dev)}
    for _ in range(5):
        step(batch)
    n = 50
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(n):
        step(batch)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / n
    say("train2", f"run_train_stage2: {STAGE2_PAIRS} pairs x 512, MMD, batch {STAGE2_B}, "
                  f"{STAGE2_EPOCHS} epochs = {steps} steps: {wall:.2f} s wall (set-up "
                  f"included); val_loss {val[0]:.6f} → {val[-1]:.6f}; the exported .bin "
                  f"serves run_facilitator_sample; launches {counts}")
    say("train2", f"Stage-2 train step at B={STAGE2_B} (512→1024→512, MMD, AdamW): "
                  f"{ms:.4f} ms/step (CUDA events, {n} steps)")
    return {"train_stage2": counts}


def check_sequences(seqs) -> None:
    for s in seqs:
        if not 0 < len(s) <= 1024 or set(s) - VALID:
            raise AssertionError(f"invalid sequence (len {len(s)}): {s[:80]!r}")


# --------------------------------------------------------------------------
# serving: BioM3Server in process (continuous, then --preset latency), then
# the run_server CLI as a subprocess
# --------------------------------------------------------------------------

SERVE_PROMPTS = ("PROTEIN NAME: kinase. FUNCTION: catalyzes transport with atp binding activity",
                 "membrane transport protein")


def http_json(url: str, payload: dict | None = None, timeout: float = 600.0) -> dict:
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as resp:
        return json.loads(resp.read())


def serve_requests(base: str) -> dict:
    """3 concurrent requests x 2 replicas: one prompt twice (an embed-cache
    hit) with the same seed (identical sequences), another prompt unseeded
    → seqs/s, p50 request latency, the sequences."""
    import threading

    reqs = [{"prompt": SERVE_PROMPTS[0], "num_replicas": 2, "seed": 7},
            {"prompt": SERVE_PROMPTS[0], "num_replicas": 2, "seed": 7},
            {"prompt": SERVE_PROMPTS[1], "num_replicas": 2}]
    out, lat = [None] * 3, [0.0] * 3

    def client(i):
        t0 = time.perf_counter()
        out[i] = http_json(f"{base}/v1/generate", reqs[i])["results"][0]["sequences"]
        lat[i] = time.perf_counter() - t0

    t0 = time.perf_counter()
    threads = [threading.Thread(target=client, args=(i,)) for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    wall = time.perf_counter() - t0
    if any(o is None for o in out):
        raise AssertionError("a serving request did not answer")
    check_sequences([s for o in out for s in o])
    if out[0] != out[1]:
        raise AssertionError("the seeded request sent twice gave different sequences")
    return {"seqs_per_s": 6 / wall, "p50_s": float(np.median(lat)), "wall_s": wall}


INPAINT_PROMPT = "zinc finger domain protein that binds dna"


def serve_inpaint(base: str, forwards: int, depth: int, *, shards: int = 1,
                  path: str = "serve_inpaint") -> dict:
    """One /v1/inpaint request (2 replicas of a 200-residue design with 40
    '?', a prompt not cached yet) and one bad request (a 'J' → 400), with
    the launch counts set to 0 just before → wall s, launch counts.  Each
    forward launches once on each of ``shards`` mesh positions."""
    import urllib.error

    import torch

    from biom3_tpu_torch.ops import kernels as K

    template = partial_design(SEED + 1)
    K.reset_launches()
    t0 = time.perf_counter()
    res = http_json(f"{base}/v1/inpaint", {"prompt": INPAINT_PROMPT, "sequence": template,
                                           "num_replicas": 2, "seed": 3})["results"][0]
    wall = time.perf_counter() - t0
    try:
        http_json(f"{base}/v1/inpaint", {"prompt": INPAINT_PROMPT, "sequence": "MKJ??"})
        raise AssertionError("/v1/inpaint took a sequence with 'J'")
    except urllib.error.HTTPError as exc:
        if exc.code != 400:
            raise AssertionError(f"/v1/inpaint answered {exc.code} to a bad sequence") from exc
    torch.cuda.synchronize()
    counts = K.launch_counts()
    check_path(path, counts)
    seqs = res["sequences"]
    if len(seqs) != 2:
        raise AssertionError(f"/v1/inpaint: {len(seqs)} sequences, expected 2")
    residues = check_inpainted(template, seqs)
    for name, want in (("stage3_attention_core", shards * depth * forwards),
                       ("gather_head", shards * forwards)):
        if counts[name] != want:
            raise AssertionError(f"/v1/inpaint: {name} launched {counts[name]} times, "
                                 f"expected {want} ({forwards} forwards on {shards} shards)")
    return {"wall_s": wall, "counts": counts, "residues": residues}


def phase_serve(root: pathlib.Path, files: dict) -> dict:
    """The serving slice at full width on seeded weights → the ``serve``
    path's launch counts (the three in-process servers: continuous exact
    mode with ``--continuous_inpaint``, then ``--preset latency`` and
    ``--preset throughput`` on the trajectory scheduler), and after each
    server's timed window one /v1/inpaint request on its route (the
    ``serve_inpaint`` path): continuous inpaint rows (one 64-step chunk
    from t0 = 1024 − 40), the packed confidence inpainter (chunk 16, early
    exit after 3 chunks) and MaskGIT rows in generate dispatches (16
    forwards)."""
    import torch

    from biom3_tpu_torch.cli import run_server
    from biom3_tpu_torch.ops import kernels as K

    counts: dict = {}
    inpaint_counts: dict = {}
    base_flags = [*files["flags"], "--device", "cuda", "--port", "0", "--rows_per_dispatch", "4"]
    # (label, flags, the inpaint route's Stage-3 forwards, its inpaint_mode)
    for label, extra, forwards, mode in (
            ("continuous, exact, int8", ["--continuous_inpaint"], 64, "continuous"),
            ("--preset latency", ["--preset", "latency"], 48, "packed"),
            ("--preset throughput", ["--preset", "throughput"], 16, "trajectory")):
        server = run_server.build_server(run_server.parse_arguments(base_flags + extra))
        # --dtype auto on cuda: the published configs take the kernel paths
        s1, s3 = server.pipeline.s1, server.pipeline.s3
        if not (s3.use_stack and s1.use_fused_stack):
            raise AssertionError(f"published configs fell back from the kernels: "
                                 f"{s3.gate_reason or s1.gate_reason}")
        server.start()
        base = f"http://{server.host}:{server.port}"
        try:
            health = http_json(f"{base}/healthz")
            if health["platform"] != "gpu" or health["continuous"] != (mode == "continuous"):
                raise AssertionError(f"healthz: {health}")
            K.reset_launches()
            res = serve_requests(base)
            torch.cuda.synchronize()
            run_counts = K.launch_counts()
            m = http_json(f"{base}/v1/metrics")
            inp = serve_inpaint(base, forwards, files["depth"])
            m_inp = http_json(f"{base}/v1/metrics")
        finally:
            server.close()
        if m_inp["inpaint_mode"] != mode:
            raise AssertionError(f"inpaint_mode {m_inp['inpaint_mode']!r}, expected {mode!r}")
        for name, c in inp["counts"].items():
            inpaint_counts[name] = inpaint_counts.get(name, 0) + c
        check_path("serve", run_counts)
        for name, c in run_counts.items():
            counts[name] = counts.get(name, 0) + c
        occ, cache = m["device"]["row_occupancy"], m["embed_cache"]
        if not 0 < occ <= 1 or cache["hits"] < 1 or m["generate"]["errors"]:
            raise AssertionError(f"metrics: {m}")
        say("serve", f"{label}: 3 requests x 2 replicas at rows_per_dispatch 4: "
                     f"{res['wall_s']:.2f} s wall; embed cache {cache}; device "
                     f"{m['device']}; device memory {m['memory'].get('device_mb')}")
        say("serve", f"{label}: seqs/s {res['seqs_per_s']:.4f} p50 request latency "
                     f"{res['p50_s']:.3f} s row occupancy {occ}")
        say("serve", f"{label}: /v1/inpaint (inpaint_mode {m_inp['inpaint_mode']}, 2 replicas, "
                     f"40 unknowns, {forwards} forwards, the prompt's embed included): "
                     f"{inp['wall_s']:.3f} s wall; {inp['residues']} of 80 fills are residues; "
                     f"bad sequence → 400")

    up, total = run_server_cli([*base_flags, "--num_replicas", "1"])
    say("serve", f"run_server CLI: up in {up:.2f} s, 1 request answered, SIGTERM → exit 0 "
                 f"({total:.2f} s in all)")
    return {"serve": counts, "serve_inpaint": inpaint_counts}


def run_server_cli(flags: list) -> tuple[float, float]:
    """``run_server`` as a subprocess: one request, SIGTERM, exit code 0 →
    (s until it serves, s in all)."""
    import signal

    t0 = time.perf_counter()
    proc = subprocess.Popen([sys.executable, "-m", "biom3_tpu_torch.cli.run_server", *flags],
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        base = None
        while base is None:
            line = proc.stdout.readline()
            if not line:
                raise AssertionError(f"run_server exited: {proc.stderr.read()[-3000:]}")
            if line.startswith("serving on "):
                base = line.split()[-1]
        up = time.perf_counter() - t0
        seqs = http_json(f"{base}/v1/generate", {"prompt": SERVE_PROMPTS[1]})["results"][0]
        check_sequences(seqs["sequences"])
        proc.send_signal(signal.SIGTERM)
        rc = proc.wait(timeout=120)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    if rc != 0:
        raise AssertionError(f"run_server exited {rc} on SIGTERM: {proc.stderr.read()[-3000:]}")
    return up, time.perf_counter() - t0


# --------------------------------------------------------------------------
# phase 6: the PenCL CLI at full width, then the graph path
# --------------------------------------------------------------------------

def seeded_pencl(stage1: dict):
    """The full-width PenCL of ``stage1`` with seeded random weights, f32 on
    the host, plain attention and tanh GELU (the reference of phase 4)."""
    from biom3_tpu_torch.config import Config, PenCLConfig
    from biom3_tpu_torch.io.state_dict import seeded_init_
    from biom3_tpu_torch.models.pencl import PenCL

    cfg = PenCLConfig.from_stage_config(Config(stage1))
    return seeded_init_(PenCL(cfg, gelu="tanh"), SEED + 4).eval()


def reference_only_keys(sd: dict, cfg) -> dict:
    """What a published PenCL ``.bin`` holds beyond the inference model, at
    its shapes: fair-esm's LM head (weight tied to embed_tokens), contact
    head and rotary buffers, BERT's MLM head and HF's position_ids."""
    import torch

    esm, bert = cfg.esm, cfg.bert
    E, Eb, Vb = esm.embed_dim, bert.hidden_size, bert.vocab_size
    pe, te = "protein_encoder.model.", "text_encoder.model."
    z = torch.zeros
    out = {pe + "lm_head.weight": sd[pe + "embed_tokens.weight"],
           pe + "lm_head.bias": z(esm.vocab_size),
           pe + "lm_head.dense.weight": z(E, E), pe + "lm_head.dense.bias": z(E),
           pe + "lm_head.layer_norm.weight": torch.ones(E), pe + "lm_head.layer_norm.bias": z(E),
           pe + "contact_head.regression.weight": z(1, esm.num_layers * esm.attention_heads),
           pe + "contact_head.regression.bias": z(1),
           te + "cls.predictions.bias": z(Vb),
           te + "cls.predictions.transform.dense.weight": z(Eb, Eb),
           te + "cls.predictions.transform.dense.bias": z(Eb),
           te + "cls.predictions.transform.LayerNorm.weight": torch.ones(Eb),
           te + "cls.predictions.transform.LayerNorm.bias": z(Eb),
           te + "cls.predictions.decoder.weight": z(Vb, Eb),
           te + "cls.predictions.decoder.bias": z(Vb),
           te + "bert.embeddings.position_ids": torch.arange(bert.max_position_embeddings)[None]}
    inv_freq = 1.0 / 10000 ** (torch.arange(0, esm.head_dim, 2).float() / esm.head_dim)
    out.update({f"{pe}layers.{i}.self_attn.rot_emb.inv_freq": inv_freq
                for i in range(esm.num_layers)})
    return out


SWEEP_PAIRS, SWEEP_PAIR_BATCH = 32, 16


def stage1_sweep(engine, captions, sequences) -> dict:
    """``Stage1SweepRunner`` on a fused-stack engine: 32 pairs (the demo
    pairs over and over) in slabs of 16, against ``engine.embed`` on the
    same pairs → the sweep's launch counts."""
    import torch

    from biom3_tpu_torch.ops import kernels as K
    from biom3_tpu_torch.pipeline.sweep import Stage1SweepRunner

    t_phase = time.perf_counter()
    caps = [captions[i % len(captions)] for i in range(SWEEP_PAIRS)]
    seqs = [sequences[i % len(sequences)] for i in range(SWEEP_PAIRS)]
    want_t, want_p = engine.embed(caps, seqs, batch_size=SWEEP_PAIR_BATCH)
    x_t, x_p = engine.tokenize(caps, seqs)
    runner = Stage1SweepRunner(engine, device_batch=SWEEP_PAIR_BATCH)
    K.reset_launches()
    t0 = time.perf_counter()
    z_t, z_p = runner.run(x_t, x_p)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = K.launch_counts()
    check_path("sweep_stage1", counts)
    slabs = -(-SWEEP_PAIRS // SWEEP_PAIR_BATCH)
    for name, want in (("esm2_attention", ESM_LAYERS * slabs),
                       ("dense_attention", BERT_LAYERS * slabs)):
        if counts[name] != want:
            raise AssertionError(f"sweep_stage1: {name} launched {counts[name]} times, "
                                 f"expected {want}")
    if z_t.shape != (SWEEP_PAIRS, 512) or z_p.shape != (SWEEP_PAIRS, 512):
        raise AssertionError(f"Stage1SweepRunner: z_t {z_t.shape}, z_p {z_p.shape}")
    cos = min(min_cosine(torch.as_tensor(z_t), torch.as_tensor(want_t)),
              min_cosine(torch.as_tensor(z_p), torch.as_tensor(want_p)))
    say("sweep", f"sweep_stage1: Stage1SweepRunner, {SWEEP_PAIRS} pairs in slabs of "
                 f"{SWEEP_PAIR_BATCH}: {wall:.2f} s wall, {SWEEP_PAIRS / wall:.1f} pairs/s "
                 f"({card()}); min "
                 f"cosine vs PenCLEngine.embed {cos:.6f}; launches {counts}; with the "
                 f"embed beside it {time.perf_counter() - t_phase:.1f} s")
    if cos < COS_MIN:
        raise AssertionError(f"Stage1SweepRunner vs PenCLEngine.embed cosine {cos} < {COS_MIN}")
    return counts


def phase_pencl(root: pathlib.Path, stage1: dict, pencl) -> dict:
    """The 5 demo pairs through ``run_pencl_inference`` (fused-stack path),
    then through ``PenCLEngine(tower_impl="graph")``, on one seeded
    full-width ``.bin`` → each path's launch counts."""
    import torch

    from biom3_tpu_torch.cli import run_pencl_inference as cli
    from biom3_tpu_torch.config import Config
    from biom3_tpu_torch.ops import kernels as K
    from biom3_tpu_torch.pipeline.stage1 import PenCLEngine, compute_scores

    sd = pencl.state_dict()
    torch.save({**sd, **reference_only_keys(sd, pencl.config)}, root / "pencl.bin")
    out = root / "pencl.pt"
    K.reset_launches()
    t0 = time.perf_counter()
    cli.main(["--json_path", str(root / "stage1.json"), "--model_path", str(root / "pencl.bin"),
              "--output_path", str(out), "--device", "cuda"])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = {"pencl": K.launch_counts()}
    saved = torch.load(out, weights_only=False)

    n = len(cli.DEMO_SEQUENCES)
    batches = -(-n // 16)                       # PenCLEngine.embed's batch_size
    z_t, z_p = (torch.as_tensor(np.asarray(saved[key])) for key in ("z_t", "z_p"))
    if z_t.shape != (n, 512) or z_p.shape != (n, 512):
        raise AssertionError(f"z_t {tuple(z_t.shape)}, z_p {tuple(z_p.shape)}: "
                             f"expected ({n}, 512)")
    if not (z_t.isfinite().all() and z_p.isfinite().all()):
        raise AssertionError("non-finite z_t / z_p")
    scores = compute_scores(z_p, z_t)
    ones = torch.ones(n)
    for key, dim in (("protein_given_text_probs", 0), ("text_given_protein_probs", 1)):
        if not torch.allclose(scores[key].sum(dim), ones, atol=1e-5):
            raise AssertionError(f"{key} does not sum to 1 along axis {dim}")
    if not torch.allclose(scores["homology_matrix"].diagonal(), ones, atol=1e-5):
        raise AssertionError("the homology diagonal is not 1")
    check_path("pencl", counts["pencl"])
    expected = {"esm2_attention": ESM_LAYERS * batches, "dense_attention": BERT_LAYERS * batches,
                "esm2_embed": batches}
    for name, want in expected.items():
        if counts["pencl"][name] != want:
            raise AssertionError(f"{name} launched {counts['pencl'][name]} times, expected {want}")
    say("pencl", f"run_pencl_inference, {n} demo pairs: {wall:.2f} s wall (set-up included); "
                 f"launches {counts['pencl']}")

    engine = PenCLEngine(Config(stage1), str(root / "pencl.bin"), device="cuda",
                         dtype=torch.bfloat16, ff_quant="none", proj_quant="none",
                         bert_ff_quant="none", bert_proj_quant="none")
    if not engine.use_fused_stack:
        raise AssertionError(f"the published PenCL config fell back: {engine.gate_reason}")
    K.reset_launches()
    t0 = time.perf_counter()
    b_t, b_p = engine.embed(cli.DEMO_CAPTIONS, cli.DEMO_SEQUENCES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["pencl_bf16"] = K.launch_counts()
    check_path("pencl_bf16", counts["pencl_bf16"])
    counts["sweep_stage1"] = stage1_sweep(engine, cli.DEMO_CAPTIONS, cli.DEMO_SEQUENCES)
    del engine
    torch.cuda.empty_cache()
    cos_t, cos = min_cosine(torch.as_tensor(b_t), z_t), min_cosine(torch.as_tensor(b_p), z_p)
    say("pencl", f"bf16 towers (PenCLEngine, the four quant knobs none), {n} demo pairs: "
                 f"{wall:.2f} s wall; min cosine vs the CLI's int8 latents: z_p {cos:.6f}, z_t "
                 f"{cos_t:.6f} (BERT's int8 gate is phase 4's, at its own initializer)")
    if cos < COS_MIN:
        raise AssertionError(f"bf16 vs int8 protein latent cosine {cos} < {COS_MIN}")

    engine = PenCLEngine(Config(stage1), str(root / "pencl.bin"), device="cuda",
                         dtype=torch.bfloat16, tower_impl="graph")
    K.reset_launches()
    t0 = time.perf_counter()
    g_t, g_p = engine.embed(cli.DEMO_CAPTIONS, cli.DEMO_SEQUENCES)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts["pencl_graph"] = K.launch_counts()
    del engine
    torch.cuda.empty_cache()
    check_path("pencl_graph", counts["pencl_graph"])
    want = (ESM_LAYERS + BERT_LAYERS) * batches
    if counts["pencl_graph"]["flash_attention"] != want:
        raise AssertionError(f"flash_attention launched {counts['pencl_graph']['flash_attention']} "
                             f"times, expected {want}")
    cos = min(min_cosine(torch.as_tensor(g_t), torch.as_tensor(b_t)),
              min_cosine(torch.as_tensor(g_p), torch.as_tensor(b_p)))
    say("pencl", f"graph path (PenCLEngine tower_impl=graph), {n} demo pairs: {wall:.2f} s wall; "
                 f"min latent cosine vs the bf16 fused-stack latents {cos:.6f}")
    if cos < COS_MIN:
        raise AssertionError(f"graph vs fused-stack latent cosine {cos} < {COS_MIN}")
    return counts


# --------------------------------------------------------------------------
# phase 7: Stage-3 training at full width
# --------------------------------------------------------------------------

def train_batch(cfg, B: int, g):
    """(tokens, z_c): shifted training ids — <START>, random residues,
    <END>, then a PAD tail (ids 1, 2..21, 22, 23) — and a random
    condition."""
    import torch

    L, dev = cfg.max_seq_len, g.device
    tokens = torch.full((B, L), 23, dtype=torch.long, device=dev)
    for b, n in enumerate(torch.randint(L // 4, L - 2, (B,), generator=g, device=dev).tolist()):
        tokens[b, 0], tokens[b, n + 1] = 1, 22
        tokens[b, 1:n + 1] = torch.randint(2, 22, (n,), generator=g, device=dev)
    return tokens, torch.randn((B, cfg.cond_dim), generator=g, device=dev)


def phase_train_grads() -> None:
    """Loss and every parameter gradient of the kernel modes (bf16) against
    the plain f32 module, same parameters, paths and timesteps; the same
    module in bf16 on torch ops is the yardstick of the per-tensor gate."""
    import torch

    from biom3_tpu_torch.config import ProteoScribeConfig
    from biom3_tpu_torch.io.state_dict import seeded_init_
    from biom3_tpu_torch.models.proteoscribe import ProteoScribe
    from biom3_tpu_torch.training.stage3_task import stage3_loss_fn

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    cfg = ProteoScribeConfig()
    B, L = 4, cfg.max_seq_len
    tokens, z = train_batch(cfg, B, g)
    path = torch.stack([torch.randperm(L, generator=g, device=dev) for _ in range(B)])
    t = torch.randint(0, L + 1, (B,), generator=g, device=dev)
    cos = torch.nn.functional.cosine_similarity
    ref = seeded_init_(ProteoScribe(cfg), SEED + 7).to(dev)

    def loss_and_grads(model):
        model.train()
        loss, _ = stage3_loss_fn(model, tokens, z, path=path, t=t)
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), {n: q.grad.float().flatten()
                                      for n, q in model.named_parameters()}

    def compare(impl):
        model = ProteoScribe(cfg, attn_impl=impl, dtype=torch.bfloat16).to(dev)
        model.load_state_dict(ref.state_dict())
        loss, grads = loss_and_grads(model)
        total = float(cos(torch.cat(list(grads.values())), torch.cat(list(g_ref.values())),
                          dim=0))
        return loss, total, {n: float(cos(grads[n], g_ref[n], dim=0)) for n in grads}

    loss_ref, g_ref = loss_and_grads(ref)
    _, _, torch_ops = compare("plain")
    for impl in ("layer-block", "block"):
        loss, total, per = compare(impl)
        rel = abs(loss - loss_ref) / abs(loss_ref)
        worst = min(per, key=per.get)
        bad = [n for n, c in per.items()
               if c < TENSOR_COS_MIN and c < torch_ops[n] - TENSOR_COS_SLACK]
        under = sum(c < TENSOR_COS_MIN for c in per.values())
        say("train", f"{impl} (bf16, kernels) vs plain f32, B={B}: loss {loss:.6f} vs "
                     f"{loss_ref:.6f} (rel {rel:.3e}); gradient cosine {total:.6f}; worst "
                     f"tensor {worst} {per[worst]:.6f} (bf16 torch ops: "
                     f"{torch_ops[worst]:.6f}); {under} of {len(per)} tensors under "
                     f"{TENSOR_COS_MIN} (torch ops: "
                     f"{sum(c < TENSOR_COS_MIN for c in torch_ops.values())})")
        if rel > LOSS_REL_TOL or total < GRAD_COS_MIN or bad:
            raise AssertionError(f"{impl}: loss rel {rel}, gradient cosine {total}, tensors "
                                 f"off the bf16 yardstick {[(n, per[n], torch_ops[n]) for n in bad]}")
    del ref
    torch.cuda.empty_cache()


def phase_train_steps() -> None:
    """40 train steps on one fixed batch of 32 per layer mode: the loss
    must fall in ``layer_block`` mode; ms per step (steps 6-40, CUDA
    events) for each mode; a profile of ``layer_block`` steps."""
    import torch

    from biom3_tpu_torch.cli.measure_pencl import profile_ms
    from biom3_tpu_torch.cli.run_train_stage3 import LAYER_MODES
    from biom3_tpu_torch.config import ProteoScribeConfig
    from biom3_tpu_torch.io.state_dict import seeded_init_
    from biom3_tpu_torch.models.proteoscribe import ProteoScribe
    from biom3_tpu_torch.training.optim import make_optimizer
    from biom3_tpu_torch.training.stage3_task import make_stage3_train_step
    from biom3_tpu_torch.training.state import TrainState

    dev = torch.device("cuda")
    cfg = ProteoScribeConfig()
    tokens, z = train_batch(cfg, TRAIN_B, torch.Generator(device=dev).manual_seed(SEED + 8))
    batch = {"tokens": tokens, "z_c": z}
    for mode in ("layer_block", "block", "unrolled"):
        model = ProteoScribe(cfg, dtype=torch.bfloat16, **LAYER_MODES[mode])
        model = seeded_init_(model, SEED + 8).to(dev)
        state = TrainState(model, make_optimizer("AdamW", model.parameters(), TRAIN_LR),
                           with_ema=True)
        step = make_stage3_train_step(state)
        gen = torch.Generator(device=dev).manual_seed(SEED)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.reset_peak_memory_stats()
        losses = []
        for i in range(TRAIN_STEPS):
            if i == 5:
                start.record()
            losses.append(step(batch, gen)["loss"])
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / (TRAIN_STEPS - 5)
        losses = [float(x) for x in losses]
        first, last = np.mean(losses[:5]), np.mean(losses[-5:])
        say("train", f"{mode}: {ms:.3f} ms/step at B={TRAIN_B} (steps 6-{TRAIN_STEPS}, CUDA "
                     f"events); loss mean of steps 1-5 {first:.4f}, of steps "
                     f"{TRAIN_STEPS - 4}-{TRAIN_STEPS} {last:.4f}; peak memory "
                     f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not np.isfinite(losses).all():
            raise AssertionError(f"{mode}: non-finite loss {losses}")
        if mode == "layer_block":
            if last > 0.8 * first:
                raise AssertionError(f"layer_block: loss {first:.4f} → {last:.4f}, "
                                     f"not below 0.8x")
            prof = profile_ms(lambda: step(batch, gen))
            say("train", "layer_block profile, device ms per step: " + json.dumps(
                {k: round(v, 3) for k, v in prof.items()}))
        del model, state, step
        torch.cuda.empty_cache()


def phase_train_cli() -> dict:
    """The training CLI at full width on a seeded synthetic Stage-2 output:
    ``layer_block`` 4 steps with ``--export_bin``, ``--resume`` to 6,
    ``block`` 2 steps → each mode's launch counts."""
    import contextlib
    import io

    import torch

    from biom3_tpu_torch.cli import run_train_stage3 as cli
    from biom3_tpu_torch.config import Config, ProteoScribeConfig
    from biom3_tpu_torch.io.state_dict import seeded_init_
    from biom3_tpu_torch.models.proteoscribe import ProteoScribe
    from biom3_tpu_torch.ops import kernels as K

    rng = np.random.default_rng(SEED)
    residues = np.array(list("ACDEFGHIKLMNPQRSTVWY"))
    n = 40
    stage3 = {"diffusion_steps": 1024, "image_size": 32, "num_classes": 29,
              "text_emb_dim": 512, "transformer_dim": 512, "transformer_heads": 16,
              "transformer_depth": 16, "transformer_blocks": 1, "transformer_local_heads": 8,
              "transformer_local_size": 128, "batch_size": TRAIN_B, "epochs": 1,
              "valid_size": 0.1, "enter_eval": 2, "learning_rate": 1e-4, "seed": SEED,
              "facilitator": "MMD"}
    counts = {"train_layer_block": {}, "train_block": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = pathlib.Path(tmp)
        seqs = ["".join(rng.choice(residues, int(k))) for k in rng.integers(50, 1000, n)]
        torch.save({"sequence": seqs, "text_to_protein_embedding": torch.from_numpy(
            rng.standard_normal((n, 512)).astype(np.float32))}, root / "data.pt")
        (root / "s3.json").write_text(json.dumps(stage3))
        common = ["--json_path", str(root / "s3.json"), "--output_dir", str(root / "out"),
                  "--swissprot_data_root", str(root / "data.pt"), "--device", "cuda"]
        runs = [("train_layer_block", ["--max_steps", "4", "--export_bin",
                                       str(root / "trained.bin")]),
                ("train_layer_block", ["--max_steps", "6", "--resume"]),
                ("train_block", ["--max_steps", "2", "--layer-mode", "block", "--output_dir",
                                 str(root / "out_block")])]
        for path, extra in runs:
            buf = io.StringIO()
            K.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli.main(common + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run_counts = K.launch_counts()
            out = buf.getvalue()
            print(out, end="", flush=True)
            check_path(path, run_counts)
            for name, c in run_counts.items():
                counts[path][name] = counts[path].get(name, 0) + c
            want = {"--resume": "resumed from step 4"}.get(extra[-1], "finished at step")
            if want not in out or "finished at step" not in out:
                raise AssertionError(f"{path} {extra}: expected {want!r} in the output")
            say("train", f"CLI {' '.join(extra[:4])}: {wall:.2f} s wall (set-up included); "
                         f"launches {run_counts}")
        sd = torch.load(root / "trained.bin", weights_only=True)
        cfg = ProteoScribeConfig.from_stage_config(Config(stage3))
        ProteoScribe(cfg).load_state_dict(sd, strict=True)
        init = seeded_init_(ProteoScribe(cfg), SEED).state_dict()
        moved = sum(not torch.equal(sd[k], init[k]) for k in sd)
        if not moved:
            raise AssertionError("the exported .bin equals the initial weights")
        say("train", f"exported .bin loads with strict=True; {moved} of {len(sd)} tensors "
                     f"differ from the initial weights")
    return counts


# --------------------------------------------------------------------------
# phase 8: Stage-1 (PenCL) training at full width
# --------------------------------------------------------------------------

def phase_stage1_grads(stage1: dict) -> None:
    """The ``pfam`` loss and every parameter gradient of ``layer-block`` in
    bf16 on the kernels against the plain f32 module, same parameters (the
    f32 module's rounded to bf16, so that both see the same weights; the
    projection heads' output LayerNorms seeded small) and batch,
    dropout off; the same module in bf16 on torch ops is the yardstick of
    the per-tensor gate (phase 7's rule).  A tensor whose f32 gradient is
    zero up to rounding (a BERT key bias: softmax is shift-invariant along a
    row) has no direction to compare; its norm is held under
    ``ZERO_GRAD_MAX`` of the whole gradient's instead.  The f32 and torch-op
    modules rematerialise each layer (no change to their numbers) to keep
    their (L, L) attention maps out of memory."""
    import torch

    from biom3_tpu_torch.cli.measure_stage1 import (
        PROTEIN_MASK_ID,
        TEXT_MASK_ID,
        seeded_stage1,
        stage1_batch,
    )
    from biom3_tpu_torch.config import Config, PenCLConfig
    from biom3_tpu_torch.models.pencl import PenCL
    from biom3_tpu_torch.training.stage1_task import stage1_loss_fn

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = PenCLConfig.from_stage_config(Config(stage1))
    batch = stage1_batch(cfg, ([1022, 398], [700, 1022]), np.random.default_rng(SEED + 9), dev)
    kw = dict(temperature=cfg.temperature, dataset_type="pfam", text_mask_id=TEXT_MASK_ID,
              protein_mask_id=PROTEIN_MASK_ID)
    cos = torch.nn.functional.cosine_similarity
    ref = seeded_stage1(cfg, SEED + 9, remat=True)
    with torch.no_grad():
        for p in ref.parameters():
            p.copy_(p.bfloat16())
    ref = ref.to(dev)

    def loss_and_grads(model):
        model.eval()
        loss, _ = stage1_loss_fn(model, batch, **kw)
        loss.backward()
        torch.cuda.synchronize()
        return float(loss.detach()), {n: q.grad.float().flatten()
                                      for n, q in model.named_parameters()}

    def compare(impl):
        model = PenCL(cfg, attn_impl=impl, dtype=torch.bfloat16, remat=impl == "plain",
                      mlm_heads=True).to(dev)
        model.load_state_dict(ref.state_dict())
        loss, grads = loss_and_grads(model)
        total = float(cos(torch.cat(list(grads.values())), torch.cat(list(g_ref.values())),
                          dim=0))
        per = {n: float(cos(grads[n], g_ref[n], dim=0)) for n in grads if n not in zero}
        return loss, total, per, {n: float(grads[n].norm()) / ref_norm for n in zero}

    t0 = time.perf_counter()
    loss_ref, g_ref = loss_and_grads(ref)
    ref_norm = float(torch.cat(list(g_ref.values())).norm())
    zero = {n for n, g in g_ref.items() if float(g.norm()) < ZERO_GRAD_REL * ref_norm}
    ops_loss, ops_total, torch_ops, ops_zero = compare("plain")
    loss, total, per, lb_zero = compare("layer-block")
    rel = abs(loss - loss_ref) / abs(loss_ref)
    worst = min(per, key=per.get)
    bad = [n for n, c in per.items() if c < TENSOR_COS_MIN and c < torch_ops[n] - TENSOR_COS_SLACK]
    bad += [n for n, r in lb_zero.items() if r > ZERO_GRAD_MAX]
    say("stage1", f"layer-block (bf16, kernels) vs plain f32 PenCL, pfam, B=2 pairs: loss "
                  f"{loss:.6f} vs {loss_ref:.6f} (rel {rel:.3e}; bf16 torch ops {ops_loss:.6f}); "
                  f"gradient cosine {total:.6f} (bf16 torch ops: {ops_total:.6f}); worst tensor "
                  f"{worst} {per[worst]:.6f} (bf16 torch ops: {torch_ops[worst]:.6f}); "
                  f"{sum(c < TENSOR_COS_MIN for c in per.values())} of {len(per)} tensors under "
                  f"{TENSOR_COS_MIN} (torch ops: "
                  f"{sum(c < TENSOR_COS_MIN for c in torch_ops.values())}); {len(zero)} with a "
                  f"zero f32 gradient (e.g. {sorted(zero)[:2]}), norm / whole ≤ "
                  f"{max(lb_zero.values(), default=0):.3e} (torch ops: "
                  f"{max(ops_zero.values(), default=0):.3e}); {time.perf_counter() - t0:.1f} s")
    if rel > LOSS_REL_TOL or total < GRAD_COS_MIN or bad:
        off = [(n, per.get(n), torch_ops.get(n), lb_zero.get(n)) for n in bad]
        raise AssertionError(f"layer-block: loss rel {rel}, gradient cosine {total}, tensors off "
                             f"the gates {off}")
    del ref, g_ref
    torch.cuda.empty_cache()


def phase_stage1_steps(stage1: dict) -> dict:
    """Train steps on one fixed batch of full-length pairs: the loss must
    fall, and its MLM terms to ``STAGE1_MLM_FALL`` of step 1's, in
    ``layer_block`` mode at B=4; ms per step (CUDA events, from the
    third step on) and peak memory of each mode; a profile of
    ``layer_block`` → the seeded weights (host), which phase 9 reuses."""
    import torch

    from biom3_tpu_torch.cli.measure_pencl import profile_ms
    from biom3_tpu_torch.cli.measure_stage1 import (
        PROTEIN_MASK_ID,
        TEXT_MASK_ID,
        seeded_stage1,
        stage1_batch,
    )
    from biom3_tpu_torch.config import Config, PenCLConfig
    from biom3_tpu_torch.models.pencl import PenCL
    from biom3_tpu_torch.training.optim import state_bytes
    from biom3_tpu_torch.training.stage1_task import make_stage1_optimizer, make_stage1_train_step
    from biom3_tpu_torch.training.state import TrainState

    dev = torch.device("cuda")
    cfg = PenCLConfig.from_stage_config(Config(stage1))
    init = seeded_stage1(cfg, SEED + 10).state_dict()
    rng = np.random.default_rng(SEED + 10)
    batches = {B: stage1_batch(cfg, ([1022] * B, [1022] * B), rng, dev) for B in (4, 1)}
    lrs = Config({"protein_encoder_lr": STAGE1_LR, "text_encoder_lr": STAGE1_LR,
                  "head_lr": STAGE1_LR})
    # (--layer-mode, pairs, --remat, steps): xla without remat keeps two
    # f32 (L, L) maps per head and layer, ~1.3 GB per sequence at full
    # width, so it runs at B=1 beside layer_block at B=1
    runs = [("layer_block", 4, False, STAGE1_STEPS), ("xla", 4, True, 6), ("xla", 1, False, 6),
            ("layer_block", 1, False, 6)]
    for mode, B, remat, steps in runs:
        with torch.device(dev):
            model = PenCL(cfg, attn_impl="layer-block" if mode == "layer_block" else "plain",
                          dtype=torch.bfloat16, remat=remat, mlm_heads=True)
        model.load_state_dict(init)
        state = TrainState(model, make_stage1_optimizer(lrs, model))
        step = make_stage1_train_step(state, temperature=cfg.temperature, dataset_type="pfam",
                                      text_mask_id=TEXT_MASK_ID, protein_mask_id=PROTEIN_MASK_ID)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.reset_peak_memory_stats()
        torch.manual_seed(SEED)   # dropout
        auxes = []
        for i in range(steps):
            if i == 2:
                start.record()
            auxes.append(step(batches[B]))
        end.record()
        torch.cuda.synchronize()
        ms = start.elapsed_time(end) / (steps - 2)
        losses = np.array([float(a["loss"]) for a in auxes])
        mlm = np.array([float(a["loss_text_mask"] + a["loss_seq_mask"]) for a in auxes])
        say("stage1", f"{mode}{' --remat' if remat else ''}: {ms:.3f} ms/step at B={B} pairs, "
                      f"pfam, full-length (steps 3-{steps}, CUDA events); loss at step 1 "
                      f"{losses[0]:.4f} (MLM terms {mlm[0]:.4f}), mean of steps {steps - 2}-"
                      f"{steps} {losses[-3:].mean():.4f} ({mlm[-3:].mean():.4f}); peak memory "
                      f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if not np.isfinite(losses).all():
            raise AssertionError(f"{mode}: non-finite loss {losses}")
        if steps == STAGE1_STEPS:
            if losses[-3:].mean() >= losses[0] or mlm[-3:].mean() > STAGE1_MLM_FALL * mlm[0]:
                raise AssertionError(f"{mode}: loss {losses.round(4).tolist()}, MLM terms "
                                     f"{mlm.round(4).tolist()}: the loss did not fall, or the "
                                     f"MLM terms not to {STAGE1_MLM_FALL}x")
            prof = profile_ms(lambda: step(batches[B]), calls=2)
            say("stage1", f"{mode} profile at B={B}, device ms per step: " + json.dumps(
                {k: round(v, 3) for k, v in prof.items()}))
            stage1_optimizer_steps(model, init, cfg, lrs, batches[B], losses,
                                   state_bytes(state.tx))
        del model, state, step
        torch.cuda.empty_cache()
    return init


STAGE1_OPT_STEPS = 3


def stage1_optimizer_steps(model, init: dict, cfg, lrs, batch, adamw_losses,
                           adamw_bytes: int) -> None:
    """``STAGE1_OPT_STEPS`` ``layer_block`` steps from the seeded weights
    with each compressed optimizer (the config keys ``"optimizer":
    "adafactor"``, ``"moment_dtype": "bfloat16"``), as the AdamW run
    started: finite losses beside AdamW's first ones, ms per step and the
    state's bytes beside AdamW's."""
    import torch

    from biom3_tpu_torch.cli.measure_stage1 import PROTEIN_MASK_ID, TEXT_MASK_ID
    from biom3_tpu_torch.config import Config
    from biom3_tpu_torch.training.optim import describe, state_bytes
    from biom3_tpu_torch.training.stage1_task import make_stage1_optimizer, make_stage1_train_step
    from biom3_tpu_torch.training.state import TrainState

    t_phase = time.perf_counter()
    for extra in ({"optimizer": "adafactor"}, {"moment_dtype": "bfloat16"}):
        model.load_state_dict(init)
        torch.manual_seed(SEED)   # dropout, as in the AdamW run
        state = TrainState(model, make_stage1_optimizer(Config({**lrs.to_dict(), **extra}),
                                                        model))
        step = make_stage1_train_step(state, temperature=cfg.temperature, dataset_type="pfam",
                                      text_mask_id=TEXT_MASK_ID, protein_mask_id=PROTEIN_MASK_ID)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = [float(step(batch)["loss"]) for _ in range(STAGE1_OPT_STEPS)]
        torch.cuda.synchronize()
        ms = (time.perf_counter() - t0) / STAGE1_OPT_STEPS * 1e3
        size = state_bytes(state.tx)
        say("stage1", f"layer_block with {describe(state.tx)} ({json.dumps(extra)}): "
                      f"{STAGE1_OPT_STEPS} steps at B={batch['protein_tokens'].shape[0]}, "
                      f"losses {[round(x, 4) for x in losses]} (AdamW's first "
                      f"{[round(float(x), 4) for x in adamw_losses[:STAGE1_OPT_STEPS]]}), "
                      f"{ms:.1f} ms/step wall (the "
                      f"first step allocates the state); optimizer state {size / 2**20:.1f} MiB "
                      f"against AdamW's {adamw_bytes / 2**20:.1f} MiB")
        if not np.isfinite(losses).all():
            raise AssertionError(f"{describe(state.tx)}: non-finite losses {losses}")
        del state, step
        torch.cuda.empty_cache()
    say("stage1", f"the compressed optimizers' steps took {time.perf_counter() - t_phase:.1f} s")


# --------------------------------------------------------------------------
# phase 9: sharded training on a one-rank NCCL group
# --------------------------------------------------------------------------

def timed_steps(step, steps: int, timed_from: int) -> tuple[list[dict], float]:
    """``steps`` calls of ``step()`` → (their aux, ms per step by CUDA
    events over the calls from ``timed_from`` on)."""
    import torch

    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    auxes = []
    for i in range(steps):
        if i == timed_from:
            start.record()
        auxes.append(step())
    end.record()
    torch.cuda.synchronize()
    return auxes, start.elapsed_time(end) / (steps - timed_from)


def first_gradients(state) -> dict:
    """The first optimizer step's gradients, gathered whole, kept on the
    card (``state.tx.step`` records them before it steps)."""
    from biom3_tpu_torch.training.state import full

    grads, step = {}, state.tx.step

    def step_and_record():
        if not grads:
            grads.update({n: full(q.grad).clone() for n, q in state.model.named_parameters()})
        step()

    state.tx.step = step_and_record
    return grads


def step_profile(fn, calls: int) -> dict[str, float]:
    """ms per call of ``fn`` (already warm) under ``torch.profiler``:
    ``wall``, ``device`` (every kernel), and the host ranges of the
    optimizer step and of FSDP2's hooks, each ``FSDP::<hook>`` summed over
    the modules."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {"wall": (time.perf_counter() - t0) / calls * 1e3, "device": 0.0}
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CPU:
            out["device"] += ev.self_device_time_total / calls / 1e3
        elif ev.key.startswith(("Optimizer.step", "FSDP::")):
            kind = re.sub(r" \(.*\)$| for .*$", "", ev.key)
            out[kind] = out.get(kind, 0.0) + ev.cpu_time_total / calls / 1e3
    return {k: round(v, 3) for k, v in out.items()}


def sharded_agreement(name: str, runs: dict, init: dict) -> None:
    """Gate and print one model's sharded run against its one-device run.
    ``runs``: "one", "sharded" → {aux (a list by step), grads (the first
    step's), params (after the last), ms, profile}."""
    import torch

    one, sh = runs["one"], runs["sharded"]
    loss_rel = max(abs(float(g[k]) - float(w[k])) / max(abs(float(w[k])), 1e-12)
                   for w, g in zip(one["aux"], sh["aux"]) for k in w if k.startswith("loss"))
    g_max = max(float(g.abs().max()) for g in one["grads"].values())
    g_worst = max(one["grads"], key=lambda k: float((sh["grads"][k] - one["grads"][k]).abs().max()))
    grad_rel = float((sh["grads"][g_worst] - one["grads"][g_worst]).abs().max()) / g_max
    diff2 = upd2 = 0.0
    p_worst, p_rel = "", 0.0
    for k, v in one["params"].items():
        diff = (sh["params"][k].float() - v.float())
        diff2 += float(diff.square().sum())
        upd2 += float((v.float() - init[k].to(v.device).float()).square().sum())
        rel = float(diff.abs().max() / v.float().abs().max())
        if rel >= p_rel:
            p_worst, p_rel = k, rel
    update_rel = (diff2 / upd2) ** 0.5
    say("sharded", f"{name}: losses {[round(float(a['loss']), 6) for a in sh['aux']]} (one "
                   f"device {[round(float(a['loss']), 6) for a in one['aux']]}), worst loss term "
                   f"rel diff {loss_rel:.3e}; first-step gradient max|Δg| / max|g| "
                   f"{grad_rel:.3e} ({g_worst}); update ||Δp − Δp_one|| / ||Δp_one|| "
                   f"{update_rel:.3e}, worst parameter max|Δ|/max|p| {p_rel:.3e} ({p_worst}); "
                   f"{sh['ms']:.3f} ms/step sharded against {one['ms']:.3f} one device (CUDA "
                   f"events); profile ms per step, sharded {json.dumps(sh['profile'])}, one "
                   f"device {json.dumps(one['profile'])}; {card()}")
    if not (loss_rel <= SHARDED_REL_TOL and grad_rel <= SHARDED_REL_TOL
            and update_rel <= SHARDED_UPDATE_TOL):
        raise AssertionError(f"{name}: the sharded step departs from the one-device step "
                             f"(loss {loss_rel}, gradient {grad_rel} at {g_worst}, update "
                             f"{update_rel})")
    del runs["one"], runs["sharded"]
    torch.cuda.empty_cache()


def phase_train_sharded(stage1: dict, init1: dict) -> dict:
    """The sharded Stage-3 and Stage-1 steps at full width on a one-rank
    NCCL group against the one-device steps (Stage 1 from phase 8b's
    seeded weights ``init1``) → each path's launch counts."""
    import socket

    import torch
    import torch.distributed as dist

    from biom3_tpu_torch.cli.measure_stage1 import PROTEIN_MASK_ID, TEXT_MASK_ID, stage1_batch
    from biom3_tpu_torch.cli.run_train_stage3 import LAYER_MODES
    from biom3_tpu_torch.config import Config, PenCLConfig, ProteoScribeConfig
    from biom3_tpu_torch.io.state_dict import seeded_init_
    from biom3_tpu_torch.models.pencl import PenCL
    from biom3_tpu_torch.models.proteoscribe import ProteoScribe
    from biom3_tpu_torch.ops import kernels as K
    from biom3_tpu_torch.parallel.distributed import initialize_distributed, make_hybrid_mesh
    from biom3_tpu_torch.parallel.mesh import MeshConfig
    from biom3_tpu_torch.training.optim import make_optimizer
    from biom3_tpu_torch.training.stage1_task import (
        make_sharded_stage1_train_step,
        make_stage1_optimizer,
        make_stage1_train_step,
    )
    from biom3_tpu_torch.training.stage3_task import (
        make_sharded_stage3_train_step,
        make_stage3_train_step,
    )
    from biom3_tpu_torch.training.state import TrainState, full

    def run(path, build, call, steps, reseed, profile_calls) -> dict:
        """``build()`` → (step, state); ``steps`` calls of ``call(step)``
        (the last ``steps − 1`` timed), with launch counts under ``path``
        unless None; then the parameters and a profile."""
        step, state = build()
        grads = first_gradients(state)
        reseed()
        K.reset_launches()
        aux, ms = timed_steps(lambda: call(step), steps, 1)
        if path is not None:
            counts[path] = K.launch_counts()
            check_path(path, counts[path])
        params = {k: v.clone() for k, v in full(state.model.state_dict()).items()}
        profile = step_profile(lambda: call(step), profile_calls)
        del step, state
        torch.cuda.empty_cache()
        return {"aux": aux, "grads": grads, "params": params, "ms": ms, "profile": profile}

    t0 = time.perf_counter()
    dev = torch.device("cuda")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    initialize_distributed(f"tcp://localhost:{port}", 1, 0)
    counts = {}
    try:
        mesh = make_hybrid_mesh(MeshConfig())
        # Stage 3: B=32, layer_block, bf16, AdamW, EMA; 3 steps
        cfg = ProteoScribeConfig()
        tokens, z = train_batch(cfg, TRAIN_B, torch.Generator(device=dev).manual_seed(SEED + 11))
        batch = {"tokens": tokens, "z_c": z}
        init = seeded_init_(ProteoScribe(cfg), SEED + 11).state_dict()

        def scribe():
            model = ProteoScribe(cfg, dtype=torch.bfloat16, **LAYER_MODES["layer_block"])
            model.load_state_dict(init)
            return model.to(dev)

        def make_tx(model):
            return make_optimizer("AdamW", model.parameters(), TRAIN_LR)

        def one_device():
            model = scribe()
            state = TrainState(model, make_tx(model), with_ema=True)
            return make_stage3_train_step(state), state

        gen = {}
        reseed = lambda: gen.update(g=torch.Generator(device=dev).manual_seed(SEED))  # noqa: E731
        call = lambda step: step(batch, gen["g"])  # noqa: E731
        runs = {"one": run(None, one_device, call, 3, reseed, 2),
                "sharded": run("train_sharded",
                               lambda: make_sharded_stage3_train_step(scribe(), make_tx, mesh),
                               call, 3, reseed, 2)}
        sharded_agreement(f"Stage 3 (d 512, 16 layers, B={TRAIN_B}, layer_block, bf16, AdamW, "
                          f"EMA)", runs, init)
        del init
        say("sharded", f"Stage 3 part {time.perf_counter() - t0:.1f} s")

        # Stage 1: ESM2-650M + PubMedBERT, B=4 pfam pairs of 1022 residues; 2 steps
        t1 = time.perf_counter()
        cfg = PenCLConfig.from_stage_config(Config(stage1))
        init = init1
        batch = stage1_batch(cfg, ([1022] * 4, [1022] * 4), np.random.default_rng(SEED + 12), dev)
        lrs = Config({"protein_encoder_lr": STAGE1_LR, "text_encoder_lr": STAGE1_LR,
                      "head_lr": STAGE1_LR})
        kw = dict(temperature=cfg.temperature, dataset_type="pfam", text_mask_id=TEXT_MASK_ID,
                  protein_mask_id=PROTEIN_MASK_ID)

        def pencl():
            with torch.device(dev):
                model = PenCL(cfg, attn_impl="layer-block", dtype=torch.bfloat16, mlm_heads=True)
            model.load_state_dict(init)
            return model

        def make_tx1(model):
            return make_stage1_optimizer(lrs, model)

        def one_device1():
            model = pencl()
            state = TrainState(model, make_tx1(model))
            return make_stage1_train_step(state, **kw), state

        reseed = lambda: torch.manual_seed(SEED)  # noqa: E731  (dropout)
        call = lambda step: step(batch)  # noqa: E731
        runs = {"one": run(None, one_device1, call, 2, reseed, 1),
                "sharded": run("train_stage1_sharded",
                               lambda: make_sharded_stage1_train_step(pencl(), make_tx1, mesh,
                                                                      **kw),
                               call, 2, reseed, 1)}
        sharded_agreement("Stage 1 (ESM2-650M + PubMedBERT, B=4 pfam pairs of 1022 residues, "
                          "layer_block, bf16, AdamW)", runs, init)
        del init, batch
        say("sharded", f"Stage 1 part {time.perf_counter() - t1:.1f} s")
    finally:
        dist.destroy_process_group()
    say("sharded", f"phase {time.perf_counter() - t0:.1f} s; launches {json.dumps(counts)}")
    return counts


# --------------------------------------------------------------------------
# phase 10: tensor parallelism (tp 2) on one card
# --------------------------------------------------------------------------

# the tp-2 step against the one-device step, both bf16 on the kernels: every
# loss term of every step within TP_LOSS_TOL (relative), the first step's
# gradients (max|Δg| over the model / its max|g|) within TP_GRAD_TOL.  The
# ranks sum their partial products in f32 and round to bf16 after the sum,
# the one-device GEMM rounds its whole product once: the two differ by bf16
# roundings of the same values, which grow through the layers
TP_LOSS_TOL, TP_GRAD_TOL = 1e-3, 1e-2
TP_WORKER = "--tp-worker"
TP_STEPS3, TP_STEPS1 = 3, 2


def tp_shard(qkv, r: int, tp: int):
    """Rank r's [q | k | v] columns of ``qkv`` (..., 3d): its contiguous
    heads, as the column shards of W_q, W_k, W_v give them."""
    import torch

    d = qkv.shape[-1] // 3
    n = d // tp
    return torch.cat([qkv[..., i * d + r * n:i * d + (r + 1) * n] for i in range(3)],
                     -1).contiguous()


def tp_kernel_shapes(dev=None, B: int = TRAIN_B, L: int = 1024) -> None:
    """``stage3_attention_core``/``_bwd`` at Stage-3 B=32 (16 heads of 32,
    8 band-local) on the two tp-2 ranks' heads — rank 0 all 8 band heads,
    rank 1 all 8 linear heads — and ``esm2_attention``/``_bwd`` at
    ESM2-650M B=2 on 10 of 20 heads: each against its plain version on the
    same shard (REL_TOL, per head group) and against the whole-head call's
    columns of that shard, with the ms of each call (CUDA events) beside
    the whole-head call's."""
    import torch

    from biom3_tpu_torch.cli.measure_pencl import event_ms
    from biom3_tpu_torch.ops import kernels as K
    from biom3_tpu_torch.ops.rotary import rotary_cos_sin
    from biom3_tpu_torch.parallel.tensor import TensorParallel

    dev, bf, tp = dev or torch.device("cuda"), torch.bfloat16, 2
    g = torch.Generator(device=dev).manual_seed(SEED + 20)
    rnd = lambda *shape: torch.randn(shape, generator=g, device=dev).to(bf)  # noqa: E731
    d, H, NL, W = 512, 16, 8, 128
    qkv, dattn = rnd(B, L, 3 * d), rnd(B, L, d)
    Be, E, He = 2, 1280, 20
    ids = esm_ids([L, L // 2 + 5], L, g)
    pad = (ids == 1).int()
    cos, sin = rotary_cos_sin(L, E // He, dtype=bf, device=dev)
    qkve, dae = rnd(Be, L, 3 * E), rnd(Be, L, E)
    kinds = {
        "stage3_attention_core": (qkv, None, lambda q, h, nl: K.stage3_attention_core(
            q, heads=h, local_heads=nl, window=W), lambda q, h, nl: K.stage3_attention_core_plain(
            q, heads=h, local_heads=nl, window=W), 32),
        "stage3_attention_bwd": (qkv, dattn, lambda q, h, nl, da: K.stage3_attention_bwd(
            q, da, heads=h, local_heads=nl, window=W), lambda q, h, nl, da:
            K.stage3_attention_bwd_plain(q, da, heads=h, local_heads=nl, window=W), 32),
        "esm2_attention": (qkve, None, lambda q, h, nl: K.esm2_attention(
            q, pad, cos, sin, heads=h), lambda q, h, nl: K.esm2_attention_plain(
            q, pad, cos, sin, heads=h), 64),
        "esm2_attention_bwd": (qkve, dae, lambda q, h, nl, da: K.esm2_attention_bwd(
            q, da, pad, cos, sin, heads=h), lambda q, h, nl, da: K.esm2_attention_bwd_plain(
            q, da, pad, cos, sin, heads=h), 64),
    }
    for name, (q, da, kernel, plain, group) in kinds.items():
        heads, local = (H, NL) if name.startswith("stage3") else (He, 0)
        extra = () if da is None else (da,)
        whole = kernel(q, heads, local, *extra)
        whole_ms = event_ms(lambda: kernel(q, heads, local, *extra), TIMED_ITERS)
        parts = []
        for r in range(tp):
            h_r, nl_r = TensorParallel(None, r, tp).heads(heads, local)
            q_r = tp_shard(q, r, tp)
            extra_r = () if da is None else (da[..., r * da.shape[-1] // tp:
                                                 (r + 1) * da.shape[-1] // tp].contiguous(),)
            got = kernel(q_r, h_r, nl_r, *extra_r)
            _, rel_plain = rel_err(got, plain(q_r, h_r, nl_r, *extra_r), group)
            n = got.shape[-1]
            want = whole[..., r * n:(r + 1) * n] if da is None else tp_shard(whole, r, tp)
            _, rel_whole = rel_err(got, want, group)
            ms = event_ms(lambda: kernel(q_r, h_r, nl_r, *extra_r), TIMED_ITERS)
            parts.append(f"rank {r} ({h_r} heads, {nl_r} band-local): {ms:.4f} ms, rel err "
                         f"{rel_plain:.2e} vs plain, {rel_whole:.2e} vs the whole call's heads")
            if not (rel_plain <= REL_TOL and rel_whole <= REL_TOL):
                raise AssertionError(f"{name} on tp rank {r}'s heads: rel err {rel_plain} vs "
                                     f"plain, {rel_whole} vs the whole-head call")
        say("tp", f"{name} B={q.shape[0]} L={L} at tp {tp}: whole ({heads} heads) "
                  f"{whole_ms:.4f} ms; " + "; ".join(parts) + f"; {card()}")
        del whole
    torch.cuda.empty_cache()


def tp_run(path, build, call, steps: int):
    """On a tp worker: ``build()`` → (step, state); ``steps`` calls of
    ``call(step)`` (the last ``steps − 1`` timed) with the launch counts
    read after → {aux, grads (the first step's, whole), ms, counts}."""
    import torch

    from biom3_tpu_torch.ops import kernels as K

    step, state = build()
    grads = first_gradients(state)
    torch.manual_seed(SEED)   # dropout (Stage 1)
    K.reset_launches()
    aux, ms = timed_steps(lambda: call(step), steps, 1)
    counts = K.launch_counts() if path else {}
    del step, state
    torch.cuda.empty_cache()
    return {"aux": [{k: float(v) for k, v in a.items() if k.startswith("loss")} for a in aux],
            "grads": grads, "ms": ms, "counts": counts}


def tp_all_reduce_ms(mesh, rows: int, cols: int, calls: int = 5) -> float:
    """ms of one all-reduce over the tp group of a (rows, cols) f32 tensor
    on the card, the size of each of ``ops/layer_block.py``'s (host clock
    around a synchronised call, after a warm-up)."""
    import torch
    import torch.distributed as dist

    x = torch.ones((rows, cols), device="cuda")
    group = mesh["tp"].get_group()
    dist.all_reduce(x, group=group)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        dist.all_reduce(x, group=group)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e3


def tp_agreement(tp: dict, one: dict) -> dict:
    """The tp run's losses and first-step gradients against the one-device
    run's → the worst relative differences."""
    loss_rel = max(abs(g[k] - w[k]) / max(abs(w[k]), 1e-12)
                   for w, g in zip(one["aux"], tp["aux"]) for k in w)
    g_max = max(float(g.abs().max()) for g in one["grads"].values())
    worst = max(one["grads"], key=lambda k: float((tp["grads"][k] - one["grads"][k]).abs().max()))
    return {"losses": [a["loss"] for a in tp["aux"]], "one_losses": [a["loss"] for a in one["aux"]],
            "loss_rel": loss_rel, "worst_grad": worst,
            "grad_rel": float((tp["grads"][worst] - one["grads"][worst]).abs().max()) / g_max,
            "ms": tp["ms"], "one_ms": one["ms"]}


# the per-rank ring body on the tp workers' gloo group: ESM2-650M's heads,
# the sequence split over the 2 ranks, a PAD tail; f32, held within
# RING_BODY_TOL of plain full attention and of the one-process ring
RING_BODY_B, RING_BODY_H, RING_BODY_L, RING_BODY_D, RING_BODY_TOL = 2, 20, 1024, 64, 2e-5


def tp_ring(rank: int, world: int) -> dict:
    """``ring_attention_sharded`` on this rank's block of L (B 2, H 20, L
    1024, D 64, f32 on the card, row b's last (b + 1)·RING_PAD·L keys PAD)
    over the whole group, against plain full attention and the one-process
    ``ring_attention`` over ``world`` positions of the card on the same
    tensors → max |Δ| of each, and ms a call of the body (host clock over
    RING_ITERS synchronised calls; gloo stages each hop through the host)
    beside the one-process ring's (CUDA events)."""
    import torch

    from biom3_tpu_torch.cli.measure_pencl import event_ms
    from biom3_tpu_torch.ops import full_attention, ring_attention, ring_attention_sharded
    from biom3_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    dev = torch.device("cuda")
    B, H, L, D = RING_BODY_B, RING_BODY_H, RING_BODY_L, RING_BODY_D
    g = torch.Generator(device=dev).manual_seed(SEED + 21)
    q, k, v = (torch.randn(B, H, L, D, generator=g, device=dev) for _ in range(3))
    pad = torch.zeros(B, L, dtype=torch.bool, device=dev)
    for b in range(B):
        pad[b, L - (b + 1) * int(RING_PAD * L):] = True
    block = slice(rank * L // world, (rank + 1) * L // world)
    mine = [t[:, :, block].contiguous() for t in (q, k, v)]

    def body():
        return ring_attention_sharded(*mine, padding_mask=pad[:, block].contiguous())

    got = body()
    torch.cuda.synchronize()
    mesh = make_mesh(MeshConfig(tp=world), [dev] * world)
    with torch.no_grad():
        full = full_attention(q, k, v, pad)[:, :, block]
        one = ring_attention(q, k, v, mesh, padding_mask=pad)[:, :, block]
    t0 = time.perf_counter()
    for _ in range(RING_ITERS):
        body()
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / RING_ITERS * 1e3
    one_ms = event_ms(lambda: ring_attention(q, k, v, mesh, padding_mask=pad), RING_ITERS)
    return {"err_full": float((got - full).abs().max()), "err_ring": float((got - one).abs().max()),
            "ms": ms, "one_ms": one_ms}


def tp_worker(rank: int, address: str, out: str) -> None:
    """One rank of the tp-2 group (gloo over CUDA tensors on the one card):
    the sharded Stage-3 ``layer_block`` step at full width (B=32, 16 layers,
    AdamW, EMA) and the sharded Stage-1 ``layer_block`` step (ESM2-650M,
    PubMedBERT, B=4 pfam pairs of 1022 residues) from phase 9's seeds; rank
    0 then runs each one-device step on the same weights and batch and
    compares.  Writes ``tp<rank>.json``: each path's launch counts, ms per
    step and (rank 0) the agreement."""
    import torch
    import torch.distributed as dist

    from biom3_tpu_torch.cli.measure_stage1 import (
        PROTEIN_MASK_ID,
        TEXT_MASK_ID,
        seeded_stage1,
        stage1_batch,
    )
    from biom3_tpu_torch.cli.run_train_stage3 import LAYER_MODES
    from biom3_tpu_torch.config import Config, PenCLConfig, ProteoScribeConfig
    from biom3_tpu_torch.io.state_dict import seeded_init_
    from biom3_tpu_torch.models.pencl import PenCL
    from biom3_tpu_torch.models.proteoscribe import ProteoScribe
    from biom3_tpu_torch.parallel.distributed import initialize_distributed, make_hybrid_mesh
    from biom3_tpu_torch.parallel.mesh import MeshConfig
    from biom3_tpu_torch.training.optim import make_optimizer
    from biom3_tpu_torch.training.stage1_task import (
        make_sharded_stage1_train_step,
        make_stage1_optimizer,
        make_stage1_train_step,
    )
    from biom3_tpu_torch.training.stage3_task import (
        make_sharded_stage3_train_step,
        make_stage3_train_step,
    )
    from biom3_tpu_torch.training.state import TrainState

    dev = initialize_distributed(address, 2, rank, device="cuda", backend="gloo")
    mesh = make_hybrid_mesh(MeshConfig(tp=2), device_type="cuda")
    result: dict = {"rank": rank}
    try:
        t0 = time.perf_counter()
        cfg = ProteoScribeConfig()
        tokens, z = train_batch(cfg, TRAIN_B, torch.Generator(device=dev).manual_seed(SEED + 11))
        batch = {"tokens": tokens, "z_c": z}
        init = seeded_init_(ProteoScribe(cfg), SEED + 11).state_dict()

        def scribe():
            model = ProteoScribe(cfg, dtype=torch.bfloat16, **LAYER_MODES["layer_block"])
            model.load_state_dict(init)
            return model.to(dev)

        def make_tx(model):
            return make_optimizer("AdamW", model.parameters(), TRAIN_LR)

        def one_device():
            model = scribe()
            state = TrainState(model, make_tx(model), with_ema=True)
            return make_stage3_train_step(state), state

        gen = {}

        def call(step):
            if "g" not in gen:
                gen["g"] = torch.Generator(device=dev).manual_seed(SEED)
            return step(batch, gen["g"])

        tp3 = tp_run("train_tp", lambda: make_sharded_stage3_train_step(scribe(), make_tx, mesh),
                     call, TP_STEPS3)
        result["train_tp"] = {"counts": tp3["counts"], "ms": tp3["ms"]}
        if rank == 0:
            gen.clear()
            result["train_tp"].update(tp_agreement(tp3, tp_run(None, one_device, call,
                                                               TP_STEPS3)))
        del tp3, init
        result["train_tp"]["s"] = time.perf_counter() - t0
        result["train_tp"]["all_reduce_ms"] = tp_all_reduce_ms(mesh, TRAIN_B * cfg.max_seq_len,
                                                               cfg.dim)
        dist.barrier()

        t1 = time.perf_counter()
        cfg = PenCLConfig.from_stage_config(Config(json.loads(pathlib.Path(out, "stage1.json")
                                                              .read_text())))
        init = seeded_stage1(cfg, SEED + 10).state_dict()
        batch = stage1_batch(cfg, ([1022] * 4, [1022] * 4), np.random.default_rng(SEED + 12), dev)
        lrs = Config({"protein_encoder_lr": STAGE1_LR, "text_encoder_lr": STAGE1_LR,
                      "head_lr": STAGE1_LR})
        kw = dict(temperature=cfg.temperature, dataset_type="pfam", text_mask_id=TEXT_MASK_ID,
                  protein_mask_id=PROTEIN_MASK_ID)

        def pencl():
            with torch.device(dev):
                model = PenCL(cfg, attn_impl="layer-block", dtype=torch.bfloat16, mlm_heads=True)
            model.load_state_dict(init)
            return model

        def one_device1():
            model = pencl()
            state = TrainState(model, make_stage1_optimizer(lrs, model))
            return make_stage1_train_step(state, **kw), state

        tp1 = tp_run("train_stage1_tp", lambda: make_sharded_stage1_train_step(
            pencl(), lambda m: make_stage1_optimizer(lrs, m), mesh, **kw),
            lambda step: step(batch), TP_STEPS1)
        result["train_stage1_tp"] = {"counts": tp1["counts"], "ms": tp1["ms"]}
        if rank == 0:
            result["train_stage1_tp"].update(tp_agreement(tp1, tp_run(
                None, one_device1, lambda step: step(batch), TP_STEPS1)))
        result["train_stage1_tp"]["s"] = time.perf_counter() - t1
        dist.barrier()
        result["ring"] = tp_ring(rank, 2)
        dist.barrier()
    finally:
        pathlib.Path(out, f"tp{rank}.json").write_text(json.dumps(result))
        dist.destroy_process_group()


def phase_train_tp(stage1: dict) -> dict:
    """Tensor parallelism on the one card: the attention kernels on the tp
    ranks' heads (``tp_kernel_shapes``), then the tp-2 steps in two worker
    processes (``tp_worker``; gloo over CUDA tensors: NCCL refuses two
    ranks on one card) → each path's launch counts, both ranks'.  ms per
    step there is no tp speed: the ranks share the card and sum over the
    host."""
    import socket

    t0 = time.perf_counter()
    tp_kernel_shapes()
    say("tp", f"kernels on the shard shapes {time.perf_counter() - t0:.1f} s")
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    counts = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_tp_") as tmp:
        pathlib.Path(tmp, "stage1.json").write_text(json.dumps(stage1))
        procs = [subprocess.Popen([sys.executable, __file__, TP_WORKER, str(r),
                                   f"tcp://localhost:{port}", tmp]) for r in range(2)]
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        if rcs != [0, 0]:
            raise AssertionError(f"tp workers exited {rcs}")
        ranks = [json.loads(pathlib.Path(tmp, f"tp{r}.json").read_text()) for r in range(2)]
    for path, what in (("train_tp", f"Stage 3 (d 512, 16 layers, B={TRAIN_B}, layer_block, "
                                     f"bf16, AdamW, EMA)"),
                       ("train_stage1_tp", "Stage 1 (ESM2-650M + PubMedBERT, B=4 pfam pairs of "
                                           "1022 residues, layer_block, bf16, AdamW)")):
        r0 = ranks[0][path]
        counts[path] = {k: sum(r[path]["counts"].get(k, 0) for r in ranks)
                        for k in set(ranks[0][path]["counts"]) | set(ranks[1][path]["counts"])}
        check_path(path, counts[path])
        say("tp", f"{what} at tp 2 on one card: losses {[round(x, 6) for x in r0['losses']]} "
                  f"(one device {[round(x, 6) for x in r0['one_losses']]}), worst loss term rel "
                  f"diff {r0['loss_rel']:.3e}; first-step gradient max|Δg| / max|g| "
                  f"{r0['grad_rel']:.3e} ({r0['worst_grad']}); {r0['ms']:.3f} ms/step (rank 0; "
                  f"rank 1 {ranks[1][path]['ms']:.3f}) against {r0['one_ms']:.3f} one device "
                  f"(CUDA events; the ranks share the card, gloo sums over the host: no tp "
                  f"speed); {r0['s']:.1f} s with the one-device run; {card()}")
        if "all_reduce_ms" in r0:
            say("tp", f"one all-reduce of a ({TRAIN_B}·1024, 512) f32 tensor over the two gloo "
                      f"ranks: {r0['all_reduce_ms']:.3f} ms (host clock; a layer_block layer "
                      f"runs 2 forward, 3 backward, the recompute's one of them); {card()}")
        if not (r0["loss_rel"] <= TP_LOSS_TOL and r0["grad_rel"] <= TP_GRAD_TOL):
            raise AssertionError(f"{path}: the tp-2 step departs from the one-device step (loss "
                                 f"{r0['loss_rel']}, gradient {r0['grad_rel']} at "
                                 f"{r0['worst_grad']})")
    for r, rank in enumerate(ranks):
        ring = rank["ring"]
        say("tp", f"ring_attention_sharded on tp rank {r} of 2 (gloo over CUDA tensors, hops "
                  f"through the host; B {RING_BODY_B}, H {RING_BODY_H}, L {RING_BODY_L}, D "
                  f"{RING_BODY_D}, f32, PAD tails): max|Δ| {ring['err_full']:.3e} vs plain full "
                  f"attention, {ring['err_ring']:.3e} vs the one-process ring (tol "
                  f"{RING_BODY_TOL}); {ring['ms']:.3f} ms a call (host clock) against "
                  f"{ring['one_ms']:.3f} ms for the one-process ring over 2 positions; {card()}")
        if not (ring["err_full"] <= RING_BODY_TOL and ring["err_ring"] <= RING_BODY_TOL):
            raise AssertionError(f"ring_attention_sharded on rank {r}: max|Δ| {ring['err_full']} "
                                 f"vs full attention, {ring['err_ring']} vs the one-process ring")
    say("tp", f"phase {time.perf_counter() - t0:.1f} s; launches {json.dumps(counts)}")
    return counts


def phase_esm2_3b_layer() -> None:
    """One ESM2-3B-width layer (E 2560, 40 heads of 64, FF 10240) at B=1,
    L=1024 with a PAD tail: ``ESM2Layer(attn_impl="layer-block")`` in bf16
    on the kernels — ``layernorm`` and ``layernorm_bwd`` past the 1280
    columns they hold in registers — against the plain f32 layer with the
    same (bf16-rounded) parameters, forward and backward through a fixed
    cotangent; phase 8a's gates: the output and the input gradient within
    ``REL_TOL`` of max|ref|, the whole parameter gradient at cosine
    ``GRAD_COS_MIN``, each tensor at ``TENSOR_COS_MIN`` (a tensor whose f32
    gradient is zero up to rounding, if any, under ``ZERO_GRAD_MAX`` of the
    whole's norm instead)."""
    import torch

    from biom3_tpu_torch.config import ESM2Config
    from biom3_tpu_torch.io.state_dict import seeded_init_
    from biom3_tpu_torch.models.esm2 import ESM2Layer

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.perf_counter()
    cfg = ESM2Config(embed_dim=2560, attention_heads=40)
    L = 1024
    ref = seeded_init_(ESM2Layer(cfg, "plain", "erf"), SEED + 11)
    with torch.no_grad():
        for p in ref.parameters():
            p.copy_(p.bfloat16())
    ref = ref.to(dev)
    g = torch.Generator(device=dev).manual_seed(SEED + 11)
    x = torch.randn(1, L, cfg.embed_dim, generator=g, device=dev).bfloat16().float()
    cot = torch.randn(1, L, cfg.embed_dim, generator=g, device=dev)
    pad = torch.zeros(1, L, dtype=torch.bool, device=dev)
    pad[0, 900:] = True

    def run(layer, dtype):
        xi = x.to(dtype, copy=True).requires_grad_()
        y = layer(xi, pad)
        y.float().backward(cot)
        torch.cuda.synchronize()
        return y.detach().float(), xi.grad.float(), {n: q.grad.float().flatten()
                                             for n, q in layer.named_parameters()}

    y_ref, dx_ref, g_ref = run(ref, torch.float32)
    layer = ESM2Layer(cfg, "layer-block", "erf", dtype=torch.bfloat16).to(dev)
    layer.load_state_dict(ref.state_dict())
    y, dx, grads = run(layer, torch.bfloat16)
    cos = torch.nn.functional.cosine_similarity
    ref_norm = float(torch.cat(list(g_ref.values())).norm())
    zero = {n for n, t in g_ref.items() if float(t.norm()) < ZERO_GRAD_REL * ref_norm}
    total = float(cos(torch.cat(list(grads.values())), torch.cat(list(g_ref.values())), dim=0))
    per = {n: float(cos(grads[n], g_ref[n], dim=0)) for n in grads if n not in zero}
    zero_norm = {n: float(grads[n].norm()) / ref_norm for n in zero}
    (_, y_rel), (_, dx_rel) = rel_err(y, y_ref), rel_err(dx, dx_ref)
    worst = min(per, key=per.get)
    say("stage1", f"ESM2-3B-width layer (E 2560, 40 heads, FF 10240, B=1, L={L}), bf16 kernels "
                  f"vs plain f32: output rel {y_rel:.3e}, dx rel {dx_rel:.3e}, gradient cosine "
                  f"{total:.6f}, worst tensor {worst} {per[worst]:.6f}, zero-gradient tensors "
                  f"{sorted(zero)} norm / whole <= {max(zero_norm.values(), default=0):.3e}; "
                  f"{time.perf_counter() - t0:.1f} s")
    bad = [n for n, c in per.items() if c < TENSOR_COS_MIN]
    bad += [n for n, r in zero_norm.items() if r > ZERO_GRAD_MAX]
    if y_rel > REL_TOL or dx_rel > REL_TOL or total < GRAD_COS_MIN or bad:
        raise AssertionError(f"ESM2-3B-width layer: output rel {y_rel}, dx rel {dx_rel}, "
                             f"gradient cosine {total}, tensors off the gates "
                             f"{[(n, per.get(n), zero_norm.get(n)) for n in bad]}")
    del ref, layer
    torch.cuda.empty_cache()


def phase_stage1_cli() -> dict:
    """The Stage-1 training CLI at full width on a seeded synthetic CSV:
    ``layer_block`` 3 steps with ``--export_bin``, ``--resume`` to 5; then
    ``run_pencl_inference --device cuda`` on the exported ``.bin`` → each
    path's launch counts."""
    import contextlib
    import csv
    import io

    import torch

    from biom3_tpu_torch.cli import run_pencl_inference
    from biom3_tpu_torch.cli import run_train_stage1 as cli
    from biom3_tpu_torch.cli.measure_pencl import stage1_config
    from biom3_tpu_torch.ops import kernels as K
    from biom3_tpu_torch.pipeline.stage1 import compute_scores

    rng = np.random.default_rng(SEED)
    words = ["protein", "enzyme", "binding", "membrane", "kinase", "the", "a", "of", "with",
             "activity", "catalyzes", "transport"]
    counts = {"train_stage1": {}}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = pathlib.Path(tmp)
        s1 = {**stage1_config(root), "batch_size": 2, "epochs": 1, "seed": SEED,
              "dataset_type": "pfam"}
        (root / "s1.json").write_text(json.dumps(s1))
        with open(root / "swissprot.csv", "w", newline="") as f:
            w = csv.writer(f)
            w.writerow(["primary_Accession", "protein_sequence", "[final]text_caption"])
            for i, n in enumerate(rng.integers(50, 1023, 10)):
                w.writerow([f"P{i:05d}", "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), n)),
                            " ".join(rng.choice(words, int(rng.integers(5, 30))))])
        common = ["--json_path", str(root / "s1.json"), "--output_dir", str(root / "out"),
                  "--data_path", str(root / "swissprot.csv"), "--device", "cuda",
                  "--layer-mode", "layer_block"]
        runs = [["--max_steps", "3", "--export_bin", str(root / "trained.bin")],
                ["--max_steps", "5", "--resume"]]
        for extra, want in zip(runs, ("exported params to", "resumed from step 3")):
            buf = io.StringIO()
            K.reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                cli.main(common + extra)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            run_counts = K.launch_counts()
            out = buf.getvalue()
            print(out, end="", flush=True)
            check_path("train_stage1", run_counts)
            for name, c in run_counts.items():
                counts["train_stage1"][name] = counts["train_stage1"].get(name, 0) + c
            if want not in out or "finished at step" not in out:
                raise AssertionError(f"run_train_stage1 {extra}: expected {want!r} in the output")
            say("stage1", f"CLI {' '.join(extra[:3])}: {wall:.2f} s wall (set-up, checkpoint "
                          f"and export included); launches {run_counts}")

        K.reset_launches()
        run_pencl_inference.main(["--json_path", str(root / "s1.json"), "--model_path",
                                  str(root / "trained.bin"), "--output_path",
                                  str(root / "latents.pt"), "--device", "cuda"])
        torch.cuda.synchronize()
        counts["pencl_trained"] = K.launch_counts()
        saved = torch.load(root / "latents.pt", weights_only=False)
    check_path("pencl", counts["pencl_trained"])
    n = len(run_pencl_inference.DEMO_SEQUENCES)
    z_t, z_p = (torch.as_tensor(np.asarray(saved[key])) for key in ("z_t", "z_p"))
    if z_t.shape != (n, 512) or z_p.shape != (n, 512):
        raise AssertionError(f"z_t {tuple(z_t.shape)}, z_p {tuple(z_p.shape)}: expected ({n}, 512)")
    if not (z_t.isfinite().all() and z_p.isfinite().all()):
        raise AssertionError("non-finite latents from the trained .bin")
    scores = compute_scores(z_p, z_t)
    for key, dim in (("protein_given_text_probs", 0), ("text_given_protein_probs", 1)):
        if not torch.allclose(scores[key].sum(dim), torch.ones(n), atol=1e-5):
            raise AssertionError(f"{key} does not sum to 1 along axis {dim}")
    say("stage1", f"run_pencl_inference on the trained .bin: {n} demo pairs, finite latents, "
                  f"valid scores; launches {counts['pencl_trained']}")
    return counts


# --------------------------------------------------------------------------
# phase 11: the certification, parity and sweep tools (biom3_tpu_torch/tools)
# --------------------------------------------------------------------------

# the copy-task toy (``tools/certify_task``): trained once, then shared by
# the three certify tools through its state file.  It sits on the ln 4
# plateau (choosing the class's mode) until it learns to copy, between
# steps 300 and 400 on the card (PERF.md); 600 is the JAX tool's default
CERTIFY_STEPS, CERTIFY_B, CERTIFY_L = 600, 64, 256
# the gates: the trained loss, every int8 mode's class accuracy, and the
# int8-ff+proj logits' min cosine against bf16 (the JAX package's toy read
# 0.999291 after 2000 steps, PARITY.md:150-172)
CERTIFY_LOSS_MAX, CERTIFY_CLASS_ACC_MIN, CERTIFY_COS_MIN = 0.1, 0.99, 0.999
PATH_KERNELS.update({
    "certify_train": PATH_KERNELS["train_layer_block"],
    # the stack forward in bf16, int8-ff and int8-ff+proj
    "certify_int8": STAGE3_BF16 | INT8,
    # the samplers over the f32 module forward, and the parity gates' f32
    # engines: torch ops, no kernel
    "certify_blocked": set(),
    "certify_inpaint": set(),
    "parity_check": set(),
    # the text tower and MaskGIT Stage 3 at their int8 default
    "run_sweep": E2E_INT8,
})
PARITY_GATES = ("z_p norms", "z_t norms", "dot diag", "homology[0,3]", "homology[1,4]",
                "norm_z_t", "norm_z_p", "norm_z_c", "mse_zc_zp", "mse_zt_zp", "mmd_zc_zp",
                "mmd_zp_zt", "stage3 temp-0 sequences")
SWEEP_QC_KEYS = {"n", "marker_valid_frac", "absorbing_leftover_frac", "aa_token_frac",
                 "class_entropy_nats", "mean_positional_entropy_nats", "len_mean", "len_p5",
                 "len_p95", "unique_frac", "mean_pairwise_identity"}


def parity_files(root: pathlib.Path) -> list[str]:
    """Small seeded checkpoints in the published .bin layouts (``seeded_init_``,
    as ``write_stage_files`` makes its files): the whole PenCL (both towers
    and heads: gate 1 needs z_p), the Facilitator and a small ProteoScribe,
    with their configs and a synthetic wordpiece vocab → ``parity_check``'s
    flags."""
    import torch

    from biom3_tpu_torch.config import Config, FacilitatorConfig, PenCLConfig, ProteoScribeConfig
    from biom3_tpu_torch.io.state_dict import seeded_init_
    from biom3_tpu_torch.models.facilitator import Facilitator
    from biom3_tpu_torch.models.pencl import PenCL
    from biom3_tpu_torch.models.proteoscribe import ProteoScribe
    from biom3_tpu_torch.tokenizers import write_synthetic_wordpiece

    vocab = write_synthetic_wordpiece(root / "vocab")
    stage = {
        1: {"protein_encoder_embedding": 64, "text_encoder_embedding": 64, "esm_num_layers": 2,
            "esm_attention_heads": 2, "rep_layer": 2, "bert_num_layers": 2, "bert_num_heads": 2,
            "bert_intermediate_size": 128, "bert_vocab_size": vocab,
            "bert_max_position_embeddings": 128, "proj_embedding_dim": 32, "temperature": 0.8,
            "text_max_length": 128, "text_model_path": str(root / "vocab")},
        2: {"emb_dim": 32, "hid_dim": 64, "dropout": 0.0, "loss_type": "MMD"},
        3: {"diffusion_steps": 64, "num_classes": 29, "text_emb_dim": 16, "transformer_dim": 64,
            "transformer_heads": 2, "transformer_depth": 2, "transformer_blocks": 1,
            "transformer_local_heads": 1, "transformer_local_size": 16},
    }
    models = {
        1: PenCL(PenCLConfig.from_stage_config(Config(stage[1]))),
        2: Facilitator(FacilitatorConfig.from_stage_config(Config(stage[2]))),
        3: ProteoScribe(ProteoScribeConfig.from_stage_config(Config(stage[3]))),
    }
    flags = []
    for n, name in ((1, "pencl"), (2, "facilitator"), (3, "proteoscribe")):
        (root / f"stage{n}.json").write_text(json.dumps(stage[n]))
        torch.save(seeded_init_(models[n], SEED + 30 + n).state_dict(), root / f"{name}.bin")
        flags += [f"--{name}", str(root / f"{name}.bin"), f"--stage{n}_json",
                  str(root / f"stage{n}.json")]
    return flags


def phase_certify() -> dict:
    """The port's tools on the card, in this process (the kernels built):
    ``certify_task.build_and_train`` (the copy-task toy, CERTIFY_STEPS steps
    at B=CERTIFY_B, L=CERTIFY_L, bf16 ``layer_block`` on the kernels; path
    ``certify_train``) saving its state file, ``certify_int8`` on its three
    modes with sampling at sample batch 64 (the stack forward's kernels;
    path ``certify_int8``), ``certify_blocked`` at k 1 and 8 and
    temperatures 1.0 and 0.0, ``certify_inpaint`` at revealed fraction 0.25,
    temperature 0.0 and MaskGIT 16 (both over the f32 module forward, from
    the state file), then ``parity_check`` on small seeded checkpoints
    (``parity_files``; every gate's verdict line, exit code 1) and
    ``run_sweep --prompts 4 --replicas 2 --batch 8 --mode fast`` (its QC
    keys) → each path's launch counts.  Fails on the trained loss, an int8
    mode's class accuracy, the int8-ff+proj logit cosine or a moved
    committed position (CERTIFY_* gates)."""
    import contextlib
    import io

    import torch

    from biom3_tpu_torch.ops import kernels as K
    from biom3_tpu_torch.tools import (
        certify_blocked,
        certify_inpaint,
        certify_int8,
        certify_task,
        parity_check,
        run_sweep,
    )

    t_phase = time.perf_counter()
    smi = card()
    counts = {}

    def run(path, fn):
        K.reset_launches()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        counts[path] = K.launch_counts()
        check_path(path, counts[path])
        return out, time.perf_counter() - t0

    with tempfile.TemporaryDirectory(prefix="chip_smoke_certify_") as tmp:
        root = pathlib.Path(tmp)
        state = str(root / "toy" / "state.pt")   # the trainer makes the directory
        common = ["--steps", str(CERTIFY_STEPS), "--batch", str(CERTIFY_B), "--seq-len",
                  str(CERTIFY_L), "--state-path", state, "--device", "cuda"]
        (cfg, _, losses), wall = run("certify_train", lambda: certify_task.build_and_train(
            CERTIFY_STEPS, CERTIFY_B, CERTIFY_L, state_path=state, device="cuda"))
        say("certify", f"copy-task toy (dim {cfg.dim}, depth {cfg.depth}, {cfg.heads} heads of "
                       f"{cfg.dim // cfg.heads}, {cfg.local_heads} band-local, W "
                       f"{cfg.local_window}, L {cfg.max_seq_len}) trained {CERTIFY_STEPS} steps "
                       f"at B={CERTIFY_B} (bf16 layer_block): loss by {len(losses)} chunks "
                       f"{[round(x, 4) for x in losses]}; {wall:.1f} s; {smi}")
        if not losses[-1] < CERTIFY_LOSS_MAX:
            raise AssertionError(f"the copy-task toy's loss {losses[-1]} is not below "
                                 f"{CERTIFY_LOSS_MAX} after {CERTIFY_STEPS} steps")
        rows, wall = run("certify_int8", lambda: certify_int8.main(common + ["--sample-batch",
                                                                            "64"]))
        say("certify", f"certify_int8: {wall:.1f} s; launches {counts['certify_int8']}; {smi}")
        bad = [r for r in rows if r["class_acc"] < CERTIFY_CLASS_ACC_MIN]
        cos = rows[-1]["logit_min_cosine"]
        if bad or rows[-1]["mode"] != "int8-ff+proj" or cos < CERTIFY_COS_MIN:
            raise AssertionError(f"certify_int8: class accuracy under {CERTIFY_CLASS_ACC_MIN} in "
                                 f"{bad}, int8-ff+proj logit min cosine {cos} (gate "
                                 f"{CERTIFY_COS_MIN})")
        _, wall = run("certify_blocked", lambda: certify_blocked.main(
            common + ["--ks", "1", "8", "--temps", "1.0", "0.0"]))
        say("certify", f"certify_blocked: {wall:.1f} s; {smi}")
        inpaint, wall = run("certify_inpaint", lambda: certify_inpaint.main(
            common + ["--fracs", "0.25", "--temps", "0.0", "--maskgit-steps", "16"]))
        say("certify", f"certify_inpaint: {wall:.1f} s; {smi}")
        moved = [r for r in inpaint if r["committed_ok"] != 1.0]
        if moved:
            raise AssertionError(f"certify_inpaint moved committed positions: {moved}")

        flags = parity_files(root)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc, wall = run("parity_check", lambda: parity_check.main(flags + ["--device",
                                                                               "cuda"]))
        out = buf.getvalue()
        print(out, end="", flush=True)
        missing = [g for g in PARITY_GATES if not re.search(r"\[(PASS|FAIL)\] " + re.escape(g),
                                                            out)]
        if rc != 1 or missing or "OVERALL: FAIL" not in out:
            raise AssertionError(f"parity_check on seeded checkpoints: exit {rc} (expected 1), "
                                 f"no verdict line for {missing}")
        say("certify", f"parity_check on seeded checkpoints: {len(PARITY_GATES)} verdict lines, "
                       f"exit {rc}; {wall:.1f} s")

        report, wall = run("run_sweep", lambda: run_sweep.main(
            ["--prompts", "4", "--replicas", "2", "--batch", "8", "--mode", "fast", "--device",
             "cuda"]))
    qc, probe = report["qc"], report["inpaint_recovery"]
    if set(qc) != SWEEP_QC_KEYS or qc["n"] != 8 or not 0 <= qc["marker_valid_frac"] <= 1 \
            or not 0 <= probe["masked_blosum_soft_acc"] <= 1 or not report["config"]["stack_path"]:
        raise AssertionError(f"run_sweep report: {json.dumps(report)}")
    say("certify", f"run_sweep (4 prompts x 2 replicas, MaskGIT 16, int8): {wall:.1f} s; "
                   f"{report['rates']['seqs_per_s_steady']} seqs/s steady, QC {json.dumps(qc)}, "
                   f"recovery {json.dumps(probe)}; launches {counts['run_sweep']}; {smi}")
    say("certify", f"phase {time.perf_counter() - t_phase:.1f} s; {smi}")
    return counts


def main() -> None:
    t0 = time.perf_counter()
    device = phase_device()
    phase_build()
    measured = phase_kernels()
    from biom3_tpu_torch.cli.measure_pencl import stage1_config

    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        root = pathlib.Path(tmp)
        stage1 = stage1_config(root)
        pencl = seeded_pencl(stage1)
        counts = phase_models(pencl)
        (root / "e2e").mkdir()
        files = write_stage_files(root / "e2e")
        counts.update(phase_e2e(root / "e2e", files))
        counts.update(phase_serve(root / "e2e", files))
        counts.update(phase_sample_clis(root / "e2e", files))
        counts.update(phase_sweep(root / "e2e", files))
        counts.update(phase_mesh(root / "e2e", files, pencl))
        counts.update(phase_train_stage2(root / "e2e"))
        counts.update(phase_pencl(root, stage1, pencl))
        del pencl
    phase_train_grads()
    phase_train_steps()
    counts.update(phase_train_cli())
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as tmp:
        stage1 = stage1_config(pathlib.Path(tmp))
        phase_stage1_grads(stage1)
        init1 = phase_stage1_steps(stage1)
        counts.update(phase_train_sharded(stage1, init1))
        del init1
        counts.update(phase_train_tp(stage1))
    counts.update(phase_stage1_cli())
    phase_esm2_3b_layer()
    counts.update(phase_certify())
    say("done", f"{time.perf_counter() - t0:.1f} s of wall time")
    record = {"kernels": [
        {"name": name, "route": "cuda", "source": KERNEL_SOURCES[name][0],
         "replaces": KERNEL_SOURCES[name][1],
         "launches": sum(c.get(name, 0) for c in counts.values()), **measured[name]}
        for name in KERNEL_SOURCES
    ]}
    print(json.dumps(record))
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    if sys.argv[1:2] == [TP_WORKER]:
        tp_worker(int(sys.argv[2]), sys.argv[3], sys.argv[4])
    else:
        main()

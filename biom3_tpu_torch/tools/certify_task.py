"""Shared machinery for the sampler-quality certification tools.

Port of the JAX package's ``tools/certify_task.py``.  The class-conditioned
copy task: every sequence is ONE token repeated across all L positions,
drawn from the 4-token mode set of its z_c-encoded class.  Trivially
learnable, yet it carries exactly the inter-position dependence that
blocked / parallel / inpainting decoders must respect — and it makes
inpainting *restoration* exactly scorable: any single revealed position
determines every other one.

The toy differs from the JAX package's in its heads.  JAX's toy is dim 128
with 8 heads (4 band-local), a head dim of 16; the port's stack forward
takes head dims 32 and 64 only (``models/fused_forward.HEAD_DIMS``,
``stack_supported``).  So this toy keeps dim 128, depth 4, one block, 29
classes, ``cond_dim`` 32, ``local_window = min(64, L // 2)`` and
``num_timesteps = L``, but has 4 heads with 2 band-local (head dim 32): the
int8 modes of ``certify_int8`` then run on the kernels.

``build_and_train`` trains it with the port's ``make_stage3_train_step``,
AdamW at rate 1e-3 and weight decay 1e-6, in the train mode
``cli/run_train_stage3`` takes on the card (bf16, ``layer_block`` on the
kernels; f32 on the kernels' plain versions on the CPU), one step a call:
the JAX trainer scans 100 steps a dispatch for its TPU, which a Python loop
on the card does not need.  It prints the loss every ``chunk`` steps.
Randomness: the batches from a numpy generator seeded ``seed`` (the same
batches as the JAX trainer's), the paths and timesteps from a
``torch.Generator`` seeded ``1000 + chunk index``.
"""

from __future__ import annotations

import os
import time

import numpy as np
import torch

from biom3_tpu_torch.cli.run_train_stage3 import LAYER_MODES
from biom3_tpu_torch.config import ProteoScribeConfig
from biom3_tpu_torch.io.state_dict import seeded_init_
from biom3_tpu_torch.models.proteoscribe import ProteoScribe
from biom3_tpu_torch.pipeline import require_device
from biom3_tpu_torch.training.optim import make_optimizer
from biom3_tpu_torch.training.stage3_task import make_stage3_train_step
from biom3_tpu_torch.training.state import TrainState

MODES = np.array([
    [3, 7, 11, 15],   # class 0 mode set
    [4, 8, 12, 16],   # class 1 mode set
])


def batch_arrays(rng, B, L, cond_dim):
    """The batch as numpy: tokens (B, L) int32, z_c (B, cond_dim) f32 and
    the classes (B,) — the JAX ``make_batch``'s draws."""
    cls = rng.integers(0, 2, B)
    tok = MODES[cls, rng.integers(0, MODES.shape[1], B)]
    tokens = np.repeat(tok[:, None], L, axis=1).astype(np.int32)
    z_c = np.where(cls[:, None] == 0, 1.0, -1.0) * np.ones((B, cond_dim))
    return tokens, z_c.astype(np.float32), cls


def make_batch(rng, B, L, cond_dim, device="cpu"):
    """→ (tokens, z_c) tensors on ``device`` and the classes (numpy)."""
    tokens, z_c, cls = batch_arrays(rng, B, L, cond_dim)
    return torch.from_numpy(tokens).to(device), torch.from_numpy(z_c).to(device), cls


def coherence_stats(seqs: np.ndarray, cls: np.ndarray):
    """Per-row (majority-token fraction, majority-token-in-class-set), plus
    mode diversity: normalized entropy of the majority-token distribution
    within each class (1.0 = samples spread uniformly over the class's
    4-token mode set, 0.0 = every sample picked the same mode).  Guards the
    confidence-ordering A/B against trading diversity for coherence —
    easy-first commits to a mode via its most-certain position, which could
    collapse the mode distribution even while coherence improves."""
    B, L = seqs.shape
    coh = np.zeros(B)
    class_ok = np.zeros(B, bool)
    tops = np.zeros(B, seqs.dtype)
    for b in range(B):
        toks, counts = np.unique(seqs[b], return_counts=True)
        top = toks[np.argmax(counts)]
        coh[b] = counts.max() / L
        class_ok[b] = top in MODES[cls[b]]
        tops[b] = top
    ents = []
    for c in np.unique(cls):
        _, counts = np.unique(tops[cls == c], return_counts=True)
        p = counts / counts.sum()
        ents.append(-(p * np.log(p)).sum() / np.log(MODES.shape[1]))
    return coh, class_ok, float(np.mean(ents))


def toy_config(seq_len: int) -> ProteoScribeConfig:
    """The toy ProteoScribe at length ``seq_len`` (module docstring)."""
    return ProteoScribeConfig(
        num_classes=29, dim=128, depth=4, n_blocks=1, heads=4, local_heads=2,
        local_window=min(64, seq_len // 2), max_seq_len=seq_len, num_timesteps=seq_len,
        cond_dim=32)


def make_trainer(model: ProteoScribe):
    """The toy's optimizer and step over ``model`` → (state, step)."""
    tx = make_optimizer("AdamW", model.parameters(), 1e-3, weight_decay=1e-6)
    state = TrainState(model, tx)
    return state, make_stage3_train_step(state)


def serving_model(cfg: ProteoScribeConfig, params: dict, device) -> ProteoScribe:
    """The f32 ``ProteoScribe`` module (torch attention) with ``params``,
    on ``device`` in eval mode: the tools' module forward, and the weights
    ``make_stack_apply`` packs."""
    model = ProteoScribe(cfg)
    model.load_state_dict({k: v.float() for k, v in params.items()})
    return model.to(device).eval()


def build_and_train(steps: int, batch: int, seq_len: int, *, chunk: int = 100, seed: int = 0,
                    state_path: str | None = None, device="cuda"):
    """Train the toy ProteoScribe on the copy task → (cfg, model, losses):
    ``model`` the trained weights in ``serving_model``'s form, ``losses``
    the last step's loss of each chunk (empty when loaded).

    ``state_path``: a torch file of the trained parameters and the training
    key ``(steps, batch, seq_len, seed)`` — loaded instead of training when
    it exists (a different key raises ``ValueError``), written after
    training otherwise (missing parent directories made), so the
    certification tools share ONE training run."""
    dev = torch.device(device)
    require_device(dev, "certify_task")
    cfg = toy_config(seq_len)
    key = (steps, batch, seq_len, seed)
    if state_path and os.path.exists(state_path):
        loaded = torch.load(state_path, weights_only=True)
        if tuple(loaded["key"]) != key:
            raise ValueError(f"saved state {state_path} was trained with "
                             f"{tuple(loaded['key'])}, requested {key}")
        print(f"loaded trained params from {state_path}", flush=True)
        return cfg, serving_model(cfg, loaded["params"], dev), []
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    model = ProteoScribe(cfg, dtype=dtype, **LAYER_MODES["layer_block"])
    model = seeded_init_(model, 0).to(dev)
    _, step = make_trainer(model)

    rng = np.random.default_rng(seed)
    chunk = min(chunk, steps)
    n_chunks = max(1, steps // chunk)
    losses = []
    t0 = time.time()
    for c in range(n_chunks):
        gen = torch.Generator(device=dev).manual_seed(1000 + c)
        for _ in range(chunk):
            tokens, z_c, _ = make_batch(rng, batch, cfg.max_seq_len, cfg.cond_dim, dev)
            aux = step({"tokens": tokens.long(), "z_c": z_c}, gen)
        losses.append(float(aux["loss"]))
        print(f"chunk {c + 1}/{n_chunks} (step {(c + 1) * chunk}): loss {losses[-1]:.4f}",
              flush=True)
    print(f"trained {n_chunks * chunk} steps in {time.time() - t0:.0f}s", flush=True)
    params = {k: v.detach().float().cpu() for k, v in model.state_dict().items()}
    if state_path:
        os.makedirs(os.path.dirname(os.path.abspath(state_path)), exist_ok=True)
        torch.save({"key": key, "params": params}, state_path)
        print(f"saved trained params to {state_path}", flush=True)
    return cfg, serving_model(cfg, params, dev), losses

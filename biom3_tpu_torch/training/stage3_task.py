"""Stage-3 (ProteoScribe) training task: the OA-ARDM train and eval steps.

Port of ``biom3_tpu/training/stage3_task.py:32-129`` (the reference's
``PL_ProtARDM``, ``Stage3_source/PL_wrapper.py:40-333``): the conditional
ELBO, optional microbatch gradient accumulation (``acc_grad_batches``),
the EMA, and the eval step's metric suite on a cadence.  The step draws
its paths and timesteps from an explicit ``torch.Generator`` (or takes
them as arguments); the model's dropout draws from torch's default
generator.  ``make_sharded_stage3_train_step`` (JAX ``:132-157``) is the
same step on a ``torch.distributed`` mesh: FSDP2-sharded parameters, each
rank on its rows of the global batch, the draws made on the global batch.
Under a profiler window the one-device step keeps the spans ``train.step``
and, within it, ``train.forward_backward``, then ``TrainState``'s
``train.optimizer`` and ``train.ema`` (``utils/profiling.py``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from biom3_tpu_torch.diffusion.oa_ardm import (
    mask_realizations,
    oa_ardm_loss,
    sample_random_paths,
    sample_timesteps,
)
from biom3_tpu_torch.parallel.sharding import data_group, put_global
from biom3_tpu_torch.training.metrics import positional_entropy, time_split_metrics
from biom3_tpu_torch.training.state import TrainState
from biom3_tpu_torch.utils import profiling


def _loss_and_counts(model, tokens, z_c, path, t):
    """The microbatch's loss, and its count of unsampled positions the
    argmax gets right and of unsampled positions (``acc_unsampled``'s
    numerator and denominator)."""
    masked = mask_realizations(tokens, path, t)
    logits = model(masked, t, z_c)
    loss = oa_ardm_loss(logits, tokens, masked, t)
    with torch.no_grad():
        unsampled = masked == 0
        counts = ((logits.argmax(-1) == tokens) & unsampled).sum(), unsampled.sum()
    return loss, counts


def stage3_loss_fn(model, tokens: torch.Tensor, z_c: torch.Tensor, *,
                   generator: torch.Generator | None = None, path: torch.Tensor | None = None,
                   t: torch.Tensor | None = None):
    """Loss and diagnostics of one microbatch; tokens (B, L) shifted train
    ids.  ``path``/``t`` are drawn from ``generator`` unless given."""
    B, L = tokens.shape
    if path is None:
        path = sample_random_paths(generator, B, L, device=tokens.device)
    if t is None:
        t = sample_timesteps(generator, B, L, device=tokens.device)
    loss, (correct, unsampled) = _loss_and_counts(model, tokens, z_c, path, t)
    return loss, {"loss": loss.detach(), "acc_unsampled": correct / unsampled.clamp(min=1)}


def draw_paths(generator: torch.Generator, batch: int, length: int, accum_steps: int = 1,
               device=None) -> tuple[torch.Tensor, torch.Tensor]:
    """The global batch's (path (B, L), t (B,)), drawn microbatch by
    microbatch, path then timesteps, as ``stage3_loss_fn`` draws them."""
    mb = batch // accum_steps
    draws = [(sample_random_paths(generator, mb, length, device=device),
              sample_timesteps(generator, mb, length, device=device))
             for _ in range(accum_steps)]
    return torch.cat([d[0] for d in draws]), torch.cat([d[1] for d in draws])


def _given_or_drawn(tokens, generator, accum_steps, path, t):
    if (path is None) != (t is None):
        raise ValueError("pass both path and t, or neither")
    if path is None:
        return draw_paths(generator, *tokens.shape, accum_steps, device=tokens.device)
    return path, t


def make_stage3_train_step(state: TrainState, *, accum_steps: int = 1, ema_beta: float = 0.9999):
    """→ ``step(batch, generator, *, path=None, t=None) -> aux``: one
    optimizer step on ``batch = {"tokens": (B, L), "z_c": (B, cond_dim)}``,
    the paths and timesteps drawn from ``generator`` (``draw_paths``)
    unless given for the whole batch.  With ``accum_steps`` > 1 the batch
    splits into microbatches whose gradients are averaged (the mean of the
    microbatch losses is differentiated)."""
    model = state.model

    def step(batch: dict, generator: torch.Generator | None = None, *,
             path: torch.Tensor | None = None, t: torch.Tensor | None = None) -> dict:
        with profiling.span("train.step", step=state.step):
            model.train()
            tokens, z_c = batch["tokens"], batch["z_c"]
            path, t = _given_or_drawn(tokens, generator, accum_steps, path, t)
            mb = tokens.shape[0] // accum_steps
            auxes = []
            with profiling.span("train.forward_backward"):
                for i in range(accum_steps):
                    sl = slice(i * mb, (i + 1) * mb)
                    loss, aux = stage3_loss_fn(model, tokens[sl], z_c[sl], path=path[sl],
                                               t=t[sl])
                    (loss / accum_steps).backward()
                    auxes.append(aux)
            state.apply_gradients(ema_beta)
            return {k: torch.stack([a[k] for a in auxes]).float().mean() for k in auxes[0]}

    return step


def make_sharded_stage3_train_step(model: torch.nn.Module, make_tx, mesh, *,
                                   with_ema: bool = True, accum_steps: int = 1,
                                   ema_beta: float = 0.9999):
    """The train step on ``mesh`` (a ``make_hybrid_mesh`` ``DeviceMesh``)
    → ``(step, state)``: ``model`` sharded by ``shard_params``, the
    optimizer (``make_tx(model)``) and the EMA built on its shards
    (``training/sharded.py``).

    ``step(batch, generator, *, path=None, t=None)`` takes the global
    batch, the same on every rank, and draws its paths and timesteps on it
    from ``generator`` (seeded alike on every rank), as the one-device step
    draws them.  Each microbatch (global rows ``[i·B/A, (i+1)·B/A)``)
    splits into the ranks' row blocks (``put_global``); only the last
    microbatch's backward reduces the gradients.  The returned aux is the
    global batch's, the same bits on every rank: each microbatch's loss
    the mean of the row blocks' (equal blocks, so the global mean) and
    ``acc_unsampled`` the ratio of the summed counts, then the mean over
    microbatches, as the one-device step; the sums run over the (dp,
    fsdp) ranks (``data_group``), since the tp ranks of a block hold the
    same rows."""
    from biom3_tpu_torch.training.sharded import make_sharded_train_step

    def build(state: TrainState):
        group = data_group(mesh)
        world = dist.get_world_size(group)

        def step(batch: dict, generator: torch.Generator | None = None, *,
                 path: torch.Tensor | None = None, t: torch.Tensor | None = None) -> dict:
            model.train()
            tokens, z_c = batch["tokens"], batch["z_c"]
            path, t = _given_or_drawn(tokens, generator, accum_steps, path, t)
            mb = tokens.shape[0] // accum_steps
            sums = []
            for i in range(accum_steps):
                sl = slice(i * mb, (i + 1) * mb)
                rows = [put_global(x[sl], mesh) for x in (tokens, z_c, path, t)]
                model.set_requires_gradient_sync(i == accum_steps - 1)
                loss, (correct, unsampled) = _loss_and_counts(model, *rows)
                (loss / accum_steps).backward()
                sums.append(torch.stack([loss.detach(), correct.float(), unsampled.float()]))
            state.apply_gradients(ema_beta)
            sums = torch.stack(sums)
            dist.all_reduce(sums, group=group)
            return {"loss": (sums[:, 0] / world).mean(),
                    "acc_unsampled": (sums[:, 1] / sums[:, 2].clamp(min=1)).mean()}

        return step

    return make_sharded_train_step(build, model, make_tx, mesh, with_ema=with_ema)


def make_stage3_eval_step(model):
    """→ ``eval_step(batch, generator) -> metrics``: the ELBO plus the
    time-split hard accuracy / entropy-perplexity and positional entropy of
    a sampled reconstruction (the reference's validation_step)."""

    @torch.no_grad()
    def eval_step(batch: dict, generator: torch.Generator) -> dict:
        model.eval()
        tokens, z_c = batch["tokens"], batch["z_c"]
        B, L = tokens.shape
        path = sample_random_paths(generator, B, L, device=tokens.device)
        t = sample_timesteps(generator, B, L, device=tokens.device)
        masked = mask_realizations(tokens, path, t)
        logits = model(masked, t, z_c).float()
        probs = torch.softmax(logits, dim=-1)
        sample = torch.multinomial(probs.reshape(B * L, -1), 1, generator=generator).view(B, L)
        metrics = {"loss": oa_ardm_loss(logits, tokens, masked, t),
                   "pos_entropy": positional_entropy(probs)}
        metrics.update(time_split_metrics(sample, tokens, probs, path, t))
        return metrics

    return eval_step

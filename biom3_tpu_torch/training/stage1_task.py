"""Stage-1 (PenCL) training task: the contrastive + MLM step.

Port of ``biom3_tpu/training/stage1_task.py`` (the reference's
``pfam_PL_PEN_CL.training_step``, ``Stage1_source/PL_wrapper.py:931-1114``):
the loss over the whole batch — inter-modal InfoNCE, intra-modal InfoNCE
(tracked but left out of the total for ``"pfam_ablated"``), text MLM and
protein MLM — one optimizer step, and the per-tower AdamW groups.
``make_stage1_train_step`` holds the whole global batch in one process;
``make_sharded_stage1_train_step`` is the JAX package's SPMD step over a
device mesh (``biom3_tpu/training/sharded.py``): each rank runs its rows,
the contrastive terms see the latents of every row block (gathered over
the (dp, fsdp) ranks) and the MLM terms sum over them.

Dropout follows the model's mode: the train step puts the model in train
mode, where the projection heads' and the BERT tower's dropout fire, as the
JAX step's dropout key does; eval mode is the deterministic forward (a
``None`` key there).  Dropout draws from torch's default generator.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from biom3_tpu_torch.models.pencl import (
    compute_inter_loss,
    compute_intra_loss,
    compute_masked_lang_loss,
    masked_lang_loss_sums,
)
from biom3_tpu_torch.parallel.sharding import data_group, put_global
from biom3_tpu_torch.training.metrics import contrastive_metrics
from biom3_tpu_torch.training.optim import Optimizer, make_grouped_optimizer
from biom3_tpu_torch.training.state import TrainState

DATASET_TYPES = ("default", "masked", "pfam", "pfam_ablated")


class _GatherRows(torch.autograd.Function):
    """The ranks' equal row blocks concatenated in rank order; the gradient
    of a rank's block is the sum over the ranks of theirs (each rank's loss
    sees every row)."""

    @staticmethod
    def forward(ctx, z, group):
        n, k = z.shape[0], dist.get_world_size(group)
        ctx.group, ctx.rows = group, slice(dist.get_rank(group) * n, (dist.get_rank(group) + 1) * n)
        out = z.new_empty((k * n, *z.shape[1:]))
        dist.all_gather_into_tensor(out, z.contiguous(), group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g[ctx.rows], None


def _gathered(z: torch.Tensor, group) -> torch.Tensor:
    """The rows of ``z`` of every rank of ``group`` (the (dp, fsdp) ranks,
    ``data_group``), in rank order (the global batch's row order,
    ``put_global``), with gradients to each rank's own rows."""
    return z if dist.get_world_size(group) == 1 else _GatherRows.apply(z, group)


def _global_mlm_loss(logits, targets, targets_masked, mask_id: int, group) -> torch.Tensor:
    """``compute_masked_lang_loss`` over the rows of ``group``'s ranks
    together: the numerators summed with their gradient, the counts
    without."""
    from torch.distributed.nn.functional import all_reduce

    total, count = masked_lang_loss_sums(logits, targets, targets_masked, mask_id)
    if dist.get_world_size(group) > 1:
        dist.all_reduce(count, group=group)
        total = all_reduce(total, group=group)
    return total / count.clamp(min=1)


def stage1_loss_fn(model, batch: dict, *, temperature: float, dataset_type: str = "pfam",
                   text_mask_id: int, protein_mask_id: int, sharded: bool = False, group=None):
    """batch: ``{text,protein}_tokens`` (and ``_masked``), optionally the
    ``pfam_*`` equivalents.  ``dataset_type`` selects the loss terms, the
    reference's three Lightning wrappers:

    * ``"default"``: the inter-modal loss only;
    * ``"masked"``: inter + text and protein MLM;
    * ``"pfam"``: SwissProt + Pfam batch, inter + intra + both MLM;
    * ``"pfam_ablated"``: pfam without the intra loss in the total.

    With ``sharded``, ``batch`` holds this rank's rows of the global batch
    and the loss is the global batch's (module docstring); ``group`` holds
    the ranks of the other row blocks (None: the world group).

    Returns (loss, aux) with every term and the contrastive logits."""
    if dataset_type not in DATASET_TYPES:
        raise ValueError(f"Unexpected dataset_type {dataset_type!r}")
    has_pfam = "pfam_text_tokens" in batch
    gather = (lambda z: _gathered(z, group)) if sharded else (lambda z: z)
    out = model(batch["text_tokens"], batch["protein_tokens"])
    z_t_all, z_p_all = gather(out["text_joint_latent"]), gather(out["seq_joint_latent"])
    if has_pfam:
        # each half gathered before the two are joined: [SwissProt, Pfam] rows
        pf = model(batch["pfam_text_tokens"], batch["pfam_protein_tokens"])
        z_t_all = torch.cat([z_t_all, gather(pf["text_joint_latent"])])
        z_p_all = torch.cat([z_p_all, gather(pf["seq_joint_latent"])])
    loss_align, logits = compute_inter_loss(z_p_all, z_t_all, z_p_all.shape[0] // 2,
                                            temperature)
    aux = {"loss_align": loss_align, "logits": logits}
    loss = loss_align
    if dataset_type in ("pfam", "pfam_ablated"):
        aux["loss_intra"], _ = compute_intra_loss(z_p_all, temperature)
        if dataset_type == "pfam":
            loss = loss + aux["loss_intra"]
    if dataset_type != "default":
        def cat(key):
            return torch.cat([batch[key], batch["pfam_" + key]]) if has_pfam else batch[key]

        mlm_loss = ((lambda *a: _global_mlm_loss(*a, group)) if sharded
                    else compute_masked_lang_loss)
        mlm = model(cat("text_tokens_masked"), cat("protein_tokens_masked"),
                    compute_masked_logits=True)
        aux["loss_text_mask"] = mlm_loss(
            mlm["text_masked_logits"], cat("text_tokens"), cat("text_tokens_masked"),
            text_mask_id)
        aux["loss_seq_mask"] = mlm_loss(
            mlm["protein_masked_logits"], cat("protein_tokens"), cat("protein_tokens_masked"),
            protein_mask_id)
        loss = loss + aux["loss_text_mask"] + aux["loss_seq_mask"]
    aux["loss"] = loss
    return loss, aux


def _train_step(state: TrainState, loss_kw: dict, sharded: bool = False, mesh=None):
    model = state.model
    if sharded:
        loss_kw = dict(loss_kw, group=data_group(mesh))

    def step(batch: dict) -> dict:
        model.train()
        if sharded:
            batch = {k: put_global(v, mesh) for k, v in batch.items()}
        loss, aux = stage1_loss_fn(model, batch, sharded=sharded, **loss_kw)
        loss.backward()
        state.apply_gradients()
        logits = aux.pop("logits").detach()
        return {**{k: v.detach() for k, v in aux.items()}, **contrastive_metrics(logits)}

    return step


def make_stage1_train_step(state: TrainState, *, temperature: float, dataset_type: str = "pfam",
                           text_mask_id: int, protein_mask_id: int):
    """→ ``step(batch) -> aux``: one optimizer step on ``batch`` (token
    tensors on the model's device) in train mode; aux holds the detached
    loss terms and the contrastive metrics."""
    return _train_step(state, dict(temperature=temperature, dataset_type=dataset_type,
                                   text_mask_id=text_mask_id, protein_mask_id=protein_mask_id))


def make_sharded_stage1_train_step(model: torch.nn.Module, make_tx, mesh, *, temperature: float,
                                   dataset_type: str = "pfam", text_mask_id: int,
                                   protein_mask_id: int):
    """The train step on ``mesh`` (a ``make_hybrid_mesh`` ``DeviceMesh``)
    → ``(step, state)``: ``model`` sharded by ``shard_params``, the
    optimizer ``make_tx(model)`` built on its shards
    (``training/sharded.py``).  ``step(batch)`` takes the global batch, the
    same on every rank, runs this rank's rows (``put_global``) and returns
    the global batch's aux, the same on every rank: the latents are
    gathered and the MLM sums reduced over the (dp, fsdp) ranks
    (``data_group``), whose row blocks differ."""
    from biom3_tpu_torch.training.sharded import make_sharded_train_step

    loss_kw = dict(temperature=temperature, dataset_type=dataset_type,
                   text_mask_id=text_mask_id, protein_mask_id=protein_mask_id)
    return make_sharded_train_step(lambda state: _train_step(state, loss_kw, True, mesh),
                                   model, make_tx, mesh)


def _group_of(name: str) -> str:
    tower = name.split(".", 1)[0]
    return {"protein_encoder": "protein", "text_encoder": "text"}.get(tower, "heads")


def make_stage1_optimizer(cfg, model: torch.nn.Module) -> Optimizer:
    """Per-group optimizer: protein tower, text tower and projection heads,
    each at its own rate (ref configure_optimizers, PL_wrapper.py:1309-1326),
    all three with the config's weight decay.  Beyond the reference's AdamW
    (JAX stage1_task.py:165-187): ``"optimizer": "adafactor"`` (factored
    second moments) and ``"moment_dtype": "bfloat16"`` (a bf16 Adam first
    moment) compress the optimizer state."""
    return make_grouped_optimizer(
        model.named_parameters(), _group_of,
        {"protein": cfg.float("protein_encoder_lr", 5e-4),
         "text": cfg.float("text_encoder_lr", 5e-4),
         "heads": cfg.float("head_lr", 5e-4)},
        weight_decay=cfg.float("weight_decay", 0.0), decay_groups=("protein", "text", "heads"),
        optimizer=cfg.get("optimizer", "adamw"), moment_dtype=cfg.get("moment_dtype"))

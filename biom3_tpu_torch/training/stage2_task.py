"""Stage-2 (Facilitator) training task.

Port of ``biom3_tpu/training/stage2_task.py`` (the reference's
``PL_Facilitator``, ``Stage1_source/PL_wrapper.py:1506-1613``): forward
z_t → z_c, the loss MSE or MMD per ``loss_type``, AdamW.

The JAX step applies the Facilitator with ``deterministic=True``, its
default (``biom3_tpu/models/facilitator.py:35,39``): it trains without
dropout.  The port's step runs the module in ``eval()`` mode to match it
(the reference's Lightning module trains with its dropout on; ``ROADMAP.md``
queue 3 keeps the difference).
"""

from __future__ import annotations

import torch

from biom3_tpu_torch.models.facilitator import mmd_loss, mse_loss
from biom3_tpu_torch.training.state import TrainState


def stage2_loss_fn(model, z_t: torch.Tensor, z_p: torch.Tensor, *, loss_type: str = "MMD"):
    """(loss, {"loss", "mse"}) of one batch."""
    z_c = model(z_t)
    if loss_type == "MSE":
        loss = mse_loss(z_c, z_p)
    elif loss_type == "MMD":
        loss = mmd_loss(z_c, z_p)
    else:
        raise ValueError(f"invalid loss option {loss_type!r}")
    return loss, {"loss": loss.detach(), "mse": mse_loss(z_c, z_p).detach()}


def make_stage2_train_step(state: TrainState, *, loss_type: str = "MMD"):
    """→ ``step(batch) -> aux``: one optimizer step on ``batch = {"z_t": (B,
    in_dim), "z_p": (B, out_dim)}``, dropout off as in the JAX step."""
    model = state.model

    def step(batch: dict) -> dict:
        model.eval()
        loss, aux = stage2_loss_fn(model, batch["z_t"], batch["z_p"], loss_type=loss_type)
        loss.backward()
        state.apply_gradients()
        return aux

    return step

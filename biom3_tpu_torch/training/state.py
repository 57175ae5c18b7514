"""Train state: the model's parameters, the optimizer and its schedule, the
step and the EMA copies.

Port of ``biom3_tpu/training/state.py:14-42``.  JAX's state is an immutable
pytree; here the model and optimizer are updated in place, and
``state_dict``/``load_state_dict`` carry what a checkpoint needs.
"""

from __future__ import annotations

import torch

from biom3_tpu_torch.training.ema import ema_init, ema_update
from biom3_tpu_torch.training.optim import Optimizer


class TrainState:
    def __init__(self, model: torch.nn.Module, tx: Optimizer, *, with_ema: bool = False):
        self.model, self.tx, self.step = model, tx, 0
        self.names = [n for n, _ in model.named_parameters()]
        self.params = [p for _, p in model.named_parameters()]
        self.ema_params = ema_init(self.params) if with_ema else None

    def apply_gradients(self, ema_beta: float = 0.9999) -> None:
        """One optimizer step from the gradients in ``.grad``, then the EMA."""
        self.tx.step()
        self.tx.zero_grad()
        if self.ema_params is not None:
            ema_update(self.ema_params, self.params, ema_beta)
        self.step += 1

    def ema_state_dict(self) -> dict[str, torch.Tensor]:
        """The model's state dict with the EMA values in place of the
        parameters."""
        sd = dict(self.model.state_dict())
        sd.update(zip(self.names, self.ema_params))
        return sd

    def state_dict(self) -> dict:
        return {"step": self.step, "params": self.model.state_dict(),
                "opt": self.tx.state_dict(), "ema": self.ema_params}

    def load_state_dict(self, sd: dict) -> None:
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["params"])
        self.tx.load_state_dict(sd["opt"])
        if self.ema_params is not None:
            with torch.no_grad():
                for e, v in zip(self.ema_params, sd["ema"]):
                    e.copy_(v)

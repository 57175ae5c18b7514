"""Train state: the model's parameters, the optimizer and its schedule, the
step and the EMA copies.

Port of ``biom3_tpu/training/state.py:14-42``.  JAX's state is an immutable
pytree; here the model and optimizer are updated in place, and
``state_dict``/``load_state_dict`` carry what a checkpoint needs.  On a
model that FSDP2 has sharded (``training/sharded.py``) ``state_dict`` and
``ema_state_dict`` gather every tensor whole on each rank, so checkpoints
and ``--export_bin`` keep the one-device format.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from biom3_tpu_torch.training.ema import ema_init, ema_update
from biom3_tpu_torch.training.optim import Optimizer


def full(tree):
    """``tree`` (tensors in dicts, lists and tuples) with every ``DTensor``
    gathered whole on this rank (a collective: every rank calls it)."""
    if isinstance(tree, DTensor):
        return tree.full_tensor()
    if isinstance(tree, dict):
        return {k: full(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(full(v) for v in tree)
    return tree


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
        return full(sd)

    def state_dict(self) -> dict:
        return full({"step": self.step, "params": self.model.state_dict(),
                     "opt": self.tx.state_dict(), "ema": self.ema_params})

    def load_state_dict(self, sd: dict) -> None:
        if any(isinstance(p, DTensor) for p in self.params):
            raise NotImplementedError("resuming a sharded state is not ported: load the "
                                      "checkpoint on one device")
        self.step = int(sd["step"])
        self.model.load_state_dict(sd["params"])
        self.tx.load_state_dict(sd["opt"])
        if self.ema_params is not None:
            with torch.no_grad():
                for e, v in zip(self.ema_params, sd["ema"]):
                    e.copy_(v)

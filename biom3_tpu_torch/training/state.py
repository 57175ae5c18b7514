"""Train state: the model's parameters, the optimizer and its schedule, the
step and the EMA copies.

Port of ``biom3_tpu/training/state.py:14-42``.  JAX's state is an immutable
pytree; here the model and optimizer are updated in place, and
``state_dict``/``load_state_dict`` carry what a checkpoint needs.  On a
model that FSDP2 has sharded (``training/sharded.py``) ``state_dict`` and
``ema_state_dict`` gather every tensor whole on each rank, so checkpoints
and ``--export_bin`` keep the one-device format, and ``load_state_dict``
lays such a whole state out again as this rank's shards: a sharded run
resumes from it on any (dp, fsdp, tp) mesh (the JAX package's orbax
restore of a sharded state).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Shard, distribute_tensor

from biom3_tpu_torch.training.ema import ema_init, ema_update
from biom3_tpu_torch.training.optim import Optimizer, _local, shard_state
from biom3_tpu_torch.utils import profiling


def _whole(t: DTensor) -> torch.Tensor:
    """``t`` gathered whole on this rank: one ``all_gather_into_tensor``
    over each mesh dim that shards it, uneven shards (FSDP2's dim 0)
    padded to the first's size.  ``torch.distributed`` collectives only:
    a gloo group over CUDA tensors runs these, where DTensor's own
    redistribution fails."""
    mesh, x = t.device_mesh, t.to_local()
    for m, pl in enumerate(t.placements):
        if not pl.is_shard() or mesh.size(m) == 1:
            continue
        if type(pl) is not Shard:   # interleaved (_StridedShard): DTensor's own gather
            return t.full_tensor()
        n, k = t.shape[pl.dim], mesh.size(m)
        rows = -(-n // k)
        x = x.movedim(pl.dim, 0)
        x = torch.cat([x, x.new_zeros((rows - x.shape[0], *x.shape[1:]))]).contiguous()
        out = x.new_empty((k * rows, *x.shape[1:]))
        dist.all_gather_into_tensor(out, x, group=mesh.get_group(m))
        x = out[:n].movedim(0, pl.dim)
    return x.contiguous()


def shard_like(value: torch.Tensor, like: DTensor) -> torch.Tensor:
    """This rank's shard of ``value``, a whole tensor every rank holds,
    laid out as ``like`` (its mesh and placements); no collective."""
    return distribute_tensor(value.to(like.device), like.device_mesh, like.placements,
                             src_data_rank=None).to_local()


def full(tree):
    """``tree`` (tensors in dicts, lists and tuples) with every ``DTensor``
    gathered whole on this rank (a collective: every rank calls it)."""
    if isinstance(tree, DTensor):
        return _whole(tree)
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
        """One optimizer step from the gradients in ``.grad``, then the EMA
        (the spans ``train.optimizer`` and ``train.ema``)."""
        with profiling.span("train.optimizer"):
            self.tx.step()
            self.tx.zero_grad()
        if self.ema_params is not None:
            with profiling.span("train.ema"):
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
        """Load a whole state (``state_dict``'s).  On a sharded model each
        parameter, optimizer moment and EMA copy takes this rank's shard of
        it, laid out as the tensor it replaces (``shard_like``)."""
        self.step = int(sd["step"])
        sharded = any(isinstance(p, DTensor) for p in self.params)
        with torch.no_grad():
            if sharded:
                for name, p in zip(self.names, self.params):
                    _local(p).copy_(shard_like(sd["params"][name], p))
            else:
                self.model.load_state_dict(sd["params"])
            self.tx.load_state_dict(sd["opt"])
            if sharded:
                shard_state(self.tx.opt)
            if self.ema_params is not None:
                for e, v in zip(self.ema_params, sd["ema"]):
                    _local(e).copy_(shard_like(v, e) if isinstance(e, DTensor) else v)

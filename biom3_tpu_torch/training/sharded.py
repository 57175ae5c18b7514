"""Sharded training on ``torch.distributed``: the generic train-step factory.

Port of ``biom3_tpu/training/sharded.py:19-47``.  JAX places the
parameters by the fsdp/tp rules, builds the optimizer state inside ``jit``
so that GSPMD puts each moment on its parameter's sharding, and splits the
batch's leading dim over (dp, fsdp).  Here each rank is a process:
``parallel/sharding.shard_params`` shards the model over tp (Megatron on
the kernels, ``parallel/tensor.py``) and with FSDP2 over (dp, fsdp), then
the optimizer and the EMA are built on the sharded parameters
(``DTensor``s), so their moments and copies are sharded alike.  The stage
tasks' step functions give each rank its rows of the global batch
(``parallel/sharding.put_global``) and reduce what they report over the
group: ``training/stage3_task.make_sharded_stage3_train_step``,
``training/stage1_task.make_sharded_stage1_train_step``.
"""

from __future__ import annotations

from typing import Callable

import torch

from biom3_tpu_torch.parallel.sharding import shard_params
from biom3_tpu_torch.training.optim import Optimizer
from biom3_tpu_torch.training.state import TrainState


def make_sharded_train_step(build_step: Callable[[TrainState], Callable],
                            model: torch.nn.Module,
                            make_tx: Callable[[torch.nn.Module], Optimizer], mesh, *,
                            with_ema: bool = False):
    """Shard ``model`` over ``mesh`` (in place), then build the optimizer
    ``make_tx(model)`` and the train state on its shards → ``(step,
    state)`` with ``step = build_step(state)``.  Every rank loads the same
    full weights into ``model`` before this call."""
    shard_params(model, mesh)
    state = TrainState(model, make_tx(model), with_ema=with_ema)
    return build_step(state), state

"""Optimizers and learning-rate schedules of the reference's training runtime.

Port of ``biom3_tpu/training/optim.py:22-75`` from optax to ``torch.optim``:

* ``coswarmup_schedule`` (linear warmup, then cosine; the reference's
  ``Stage3_source/PL_wrapper.py:113-126``) and ``exponential_epoch_schedule``
  return the multiplier of the base rate at an optimizer step, for
  ``torch.optim.lr_scheduler.LambdaLR``; the scheduler steps once per
  optimizer step, so the rate of step n is the schedule at n, as optax
  counts it.
* ``make_optimizer`` builds AdamW (also for ``DeepSpeedCPUAdam``) or Adam
  with optax's defaults: betas (0.9, 0.999), eps 1e-8 outside the square
  root, decoupled decay lr·wd·p.  torch's AdamW defaults to
  ``weight_decay=0.01``, optax's to 1e-4 and the JAX CLI passes the
  config's value (default 0): the value is always passed explicitly.
  ``grad_clip`` clips the global gradient norm first
  (``optax.clip_by_global_norm``).
* ``make_grouped_optimizer`` (``biom3_tpu/training/optim.py:78-132``,
  Stage-1's per-tower learning rates): optax's ``multi_transform`` of one
  AdamW per label becomes one ``torch.optim.AdamW`` with a parameter group
  per label, each with its own rate and weight decay.
* Adafactor is not ported: ``optax.adafactor`` and ``torch.optim.Adafactor``
  are different algorithms.  Nor are bf16 Adam first moments (optax
  ``mu_dtype``): ``torch.optim.AdamW`` keeps its moments in the
  parameters' dtype.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Mapping

import torch


def coswarmup_schedule(warmup_steps: int, total_steps: int,
                       num_cycles: float = 0.5) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        if step < warmup_steps:
            return step / max(1.0, warmup_steps)
        progress = (step - warmup_steps) / max(1.0, total_steps - warmup_steps)
        return max(0.0, 0.5 * (1.0 + math.cos(math.pi * num_cycles * 2.0 * progress)))

    return schedule


def exponential_epoch_schedule(gamma: float, steps_per_epoch: int) -> Callable[[int], float]:
    def schedule(step: int) -> float:
        return gamma ** (step // steps_per_epoch)

    return schedule


class Optimizer:
    """A ``torch.optim`` optimizer, its ``LambdaLR`` scheduler and the
    optional global-norm clip, stepped together."""

    def __init__(self, opt: torch.optim.Optimizer, schedule: Callable[[int], float] | None,
                 grad_clip: float | None):
        self.opt = opt
        self.sched = torch.optim.lr_scheduler.LambdaLR(opt, schedule or (lambda step: 1.0))
        self.grad_clip = grad_clip

    def step(self) -> None:
        if self.grad_clip is not None:
            params = [p for g in self.opt.param_groups for p in g["params"] if p.grad is not None]
            torch.nn.utils.clip_grad_norm_(params, self.grad_clip)
        self.opt.step()
        self.sched.step()

    def zero_grad(self) -> None:
        self.opt.zero_grad(set_to_none=True)

    def state_dict(self) -> dict:
        return {"opt": self.opt.state_dict(), "sched": self.sched.state_dict()}

    def load_state_dict(self, sd: dict) -> None:
        self.opt.load_state_dict(sd["opt"])
        self.sched.load_state_dict(sd["sched"])


def make_optimizer(name: str, params: Iterable[torch.Tensor], lr: float,
                   schedule: Callable[[int], float] | None = None, weight_decay: float = 0.0,
                   *, grad_clip: float | None = None) -> Optimizer:
    """The reference's optimizer choices; ``lr`` is the base rate that
    ``schedule`` multiplies."""
    name_l = name.lower()
    if name_l in ("adamw", "deepspeedcpuadam"):
        opt = torch.optim.AdamW(params, lr=lr, betas=(0.9, 0.999), eps=1e-8,
                                weight_decay=weight_decay)
    elif name_l == "adam":
        opt = torch.optim.Adam(params, lr=lr, betas=(0.9, 0.999), eps=1e-8, weight_decay=0.0)
    elif name_l == "adafactor":
        raise NotImplementedError("Adafactor is not ported: optax.adafactor and "
                                  "torch.optim.Adafactor are different algorithms")
    else:
        raise ValueError(f"unknown optimizer {name!r}; choose AdamW/Adam/DeepSpeedCPUAdam")
    return Optimizer(opt, schedule, grad_clip)


def make_grouped_optimizer(named_params: Iterable[tuple[str, torch.Tensor]],
                           group_fn: Callable[[str], str], group_lrs: Mapping[str, float],
                           weight_decay: float = 0.0, decay_groups: tuple = (),
                           optimizer: str = "adamw", moment_dtype: str | None = None) -> Optimizer:
    """AdamW with one parameter group per label: ``group_fn`` maps a
    parameter's name to its label, ``group_lrs`` a label to its rate, and
    the labels in ``decay_groups`` get ``weight_decay`` (the others 0)."""
    name = optimizer.lower()
    if name == "adafactor":
        raise NotImplementedError("Adafactor is not ported: optax.adafactor and "
                                  "torch.optim.Adafactor are different algorithms")
    if name not in ("adamw", "deepspeedcpuadam"):
        raise ValueError(f"unknown grouped optimizer {optimizer!r}; choose adamw")
    if moment_dtype not in (None, "None", "float32"):
        raise NotImplementedError(f"moment_dtype={moment_dtype!r} is not ported: "
                                  "torch.optim.AdamW keeps its moments in the parameters' dtype")
    groups: dict[str, list] = {}
    for pname, p in named_params:
        groups.setdefault(group_fn(pname), []).append(p)
    unknown = sorted(set(groups) - set(group_lrs))
    if unknown:
        raise ValueError(f"parameter groups {unknown} have no learning rate")
    opt = torch.optim.AdamW(
        [{"params": ps, "lr": group_lrs[label], "name": label,
          "weight_decay": weight_decay if label in decay_groups else 0.0}
         for label, ps in groups.items()],
        betas=(0.9, 0.999), eps=1e-8)
    return Optimizer(opt, None, None)

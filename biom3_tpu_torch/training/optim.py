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
  AdamW (or Adafactor) per label becomes one optimizer with a parameter
  group per label, each with its own rate and weight decay.
* ``Adafactor`` is ``optax.adafactor``'s algorithm written out in torch
  (``torch.optim.Adafactor`` is a different one), with its defaults: the
  second moment factored over the two largest dims when the smaller is at
  least 128, decay 1 − (step + 1)^−0.8, eps 1e-30 added to g², updates
  clipped to block RMS 1, scaled by the rate and by the parameter's RMS
  (at least 1e-3), no first moment, then ``weight_decay_rate · p`` added
  (not scaled by the rate, as optax adds it after the rate).  JAX runs
  optax here, not a kernel.
* ``AdamWMoments`` is ``optax.adamw`` with ``mu_dtype``: the first moment
  kept in bf16 (``b1 · mu`` in bf16 with b1 itself rounded to bf16, as
  jnp's weak typing does, then summed in f32), the second in the
  parameters' dtype (``moment_dtype="bfloat16"``, Stage 1's
  optimizer-state compression).

On parameters that FSDP2 has sharded (``DTensor``s, ``parallel/sharding.py``)
``torch.optim.AdamW`` runs as it is; ``Adafactor`` and ``AdamWMoments``
update each rank's shard in place and keep their state as ``DTensor``s
sharded as the parameter.  ``AdamWMoments`` is elementwise; Adafactor's
row and column means and its two RMS take their sums over the shard's
process group, so its factored statistics are those of the whole
parameter.
"""

from __future__ import annotations

import math
from typing import Callable, Iterable, Mapping

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard


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


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


# optax.adafactor's defaults
AF_DECAY_RATE, AF_MIN_DIM, AF_CLIP, AF_EPS, AF_MIN_SCALE = 0.8, 128, 1.0, 1e-30, 1e-3


def _factored_dims(shape):
    """optax ``_factored_dims``: (d1, d0), the second largest and the
    largest dim (numpy's argsort order), or None."""
    if len(shape) < 2:
        return None
    sorted_dims = np.argsort(shape)
    if shape[sorted_dims[-2]] < AF_MIN_DIM:
        return None
    return int(sorted_dims[-2]), int(sorted_dims[-1])


def _local(t: torch.Tensor) -> torch.Tensor:
    """A ``DTensor``'s shard on this rank (in-place ops on it reach the
    ``DTensor``), any other tensor itself."""
    return t.to_local() if isinstance(t, DTensor) else t


def _shard_groups(t: torch.Tensor) -> dict:
    """Tensor dim → the process group a ``DTensor`` shards it over, for
    groups of more than one rank (none for a plain tensor)."""
    if not isinstance(t, DTensor):
        return {}
    mesh = t.device_mesh
    return {pl.dim: mesh.get_group(m) for m, pl in enumerate(t.placements)
            if isinstance(pl, Shard) and mesh.size(m) > 1}


def _without(groups: dict, dim: int) -> dict:
    """``groups`` of a tensor reduced over ``dim``."""
    return {k - (k > dim): g for k, g in groups.items() if k != dim}


def _mean(x: torch.Tensor, dim: int, n: int, groups: dict, keepdim: bool = False):
    """The mean over ``dim`` (``n`` long in the whole tensor) of the shard
    ``x``, whose dims ``groups`` names are sharded."""
    if dim not in groups:
        return x.mean(dim, keepdim=keepdim)
    total = x.sum(dim, keepdim=keepdim)
    dist.all_reduce(total, group=groups[dim])
    return total / n


def _mean_all(x: torch.Tensor, numel: int, groups: dict) -> torch.Tensor:
    if not groups:
        return x.mean()
    total = x.sum()
    for group in groups.values():
        dist.all_reduce(total, group=group)
    return total / numel


def _placements_without(p: DTensor, dim: int) -> list:
    """``p``'s placements for a tensor of its shape without ``dim``."""
    return [pl if not isinstance(pl, Shard) else
            Replicate() if pl.dim == dim else Shard(pl.dim - (pl.dim > dim))
            for pl in p.placements]


def _zeros_without(p: torch.Tensor, dim: int) -> torch.Tensor:
    """Zeros of ``p``'s shape without ``dim``, sharded as ``p`` on the
    other dims."""
    shape = [n for i, n in enumerate(p.shape) if i != dim]
    if not isinstance(p, DTensor):
        return p.new_zeros(shape)
    from torch.distributed.tensor import zeros

    return zeros(shape, dtype=p.dtype, device_mesh=p.device_mesh,
                 placements=_placements_without(p, dim))


def shard_state(opt: torch.optim.Optimizer) -> None:
    """Lay out in place the whole state tensors that ``load_state_dict``
    put beside sharded parameters as the optimizers here keep them: a
    moment of the parameter's shape sharded as the parameter, Adafactor's
    factored row and column statistics as ``_zeros_without`` makes them.
    Every rank holds the whole state; no collective."""
    from torch.distributed.tensor import distribute_tensor

    for p, state in opt.state.items():
        if not isinstance(p, DTensor):
            continue
        dims = _factored_dims(tuple(p.shape))
        for key, v in state.items():
            if not isinstance(v, torch.Tensor) or isinstance(v, DTensor) or not v.dim():
                continue
            placements = (p.placements if tuple(v.shape) == tuple(p.shape) else
                          _placements_without(p, dims[1] if key == "v_row" else dims[0]))
            state[key] = distribute_tensor(v.to(p.device), p.device_mesh, placements,
                                           src_data_rank=None)


class Adafactor(torch.optim.Optimizer):
    """``optax.adafactor(lr, weight_decay_rate=weight_decay or None)``."""

    def __init__(self, params, lr: float, *, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is not None:
                    self._update(p, p.grad, self.state[p], group)

    def _update(self, p, g, state, group) -> None:
        shape = tuple(p.shape)
        dims = _factored_dims(shape)
        if not state:
            state["step"] = 0
            if dims is None:
                state["v"] = torch.zeros_like(p)
            else:
                d1, d0 = dims
                state["v_row"], state["v_col"] = _zeros_without(p, d0), _zeros_without(p, d1)
        groups, pl, g = _shard_groups(p), _local(p), _local(g)
        decay = 1.0 - _f32(state["step"] + 1, pl) ** -AF_DECAY_RATE
        grad_sqr = g * g + AF_EPS
        if dims is None:
            v = _local(state["v"])
            v.copy_(decay * v + (1.0 - decay) * grad_sqr)
            u = g * v ** -0.5
        else:
            d1, d0 = dims
            v_row, v_col = _local(state["v_row"]), _local(state["v_col"])
            v_row.copy_(decay * v_row + (1.0 - decay) * _mean(grad_sqr, d0, shape[d0], groups))
            v_col.copy_(decay * v_col + (1.0 - decay) * _mean(grad_sqr, d1, shape[d1], groups))
            row_col_mean = _mean(v_row, d1 - 1 if d1 > d0 else d1, shape[d1],
                                 _without(groups, d0), keepdim=True)
            u = g * ((v_row / row_col_mean) ** -0.5).unsqueeze(d0) * (v_col ** -0.5).unsqueeze(d1)
        state["step"] += 1
        numel = p.numel()
        u = u / torch.clamp(torch.sqrt(_mean_all(u * u, numel, groups)) / AF_CLIP, min=1.0)
        u = u * group["lr"]
        rms = torch.sqrt(_mean_all(pl * pl, numel, groups))
        u = u * torch.where(rms <= AF_MIN_SCALE, _f32(AF_MIN_SCALE, pl), rms)
        if group["weight_decay"]:
            u = u + group["weight_decay"] * pl
        pl.sub_(u)


class AdamWMoments(torch.optim.Optimizer):
    """``optax.adamw(lr, weight_decay=wd, mu_dtype=jnp.bfloat16)``: betas
    (0.9, 0.999), eps 1e-8 outside the root, the update lr · (m̂ / (√v̂ +
    eps) + wd · p)."""

    def __init__(self, params, lr: float, *, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=lr, weight_decay=weight_decay,
                                      moment_dtype=torch.bfloat16))

    @torch.no_grad()
    def step(self, closure=None):
        b1, b2, eps = 0.9, 0.999, 1e-8
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if not state:
                    state["step"] = 0
                    state["mu"] = torch.zeros_like(p, dtype=group["moment_dtype"])
                    state["nu"] = torch.zeros_like(p)
                state["step"] += 1
                g, pl = _local(p.grad), _local(p)
                mu_prev, nu_prev = _local(state["mu"]), _local(state["nu"])
                # jnp takes the Python b1 in mu's dtype (weak typing): bf16(b1) · mu
                mu = (1 - b1) * g + torch.tensor(b1, dtype=mu_prev.dtype) * mu_prev
                nu = (1 - b2) * (g * g) + b2 * nu_prev
                n = _f32(state["step"], pl)
                mu_hat = mu / (1 - _f32(b1, pl) ** n)
                nu_hat = nu / (1 - _f32(b2, pl) ** n)
                u = mu_hat / (torch.sqrt(nu_hat) + eps)
                if group["weight_decay"]:
                    u = u + group["weight_decay"] * pl
                pl.add_(u * -group["lr"])
                mu_prev.copy_(mu)
                nu_prev.copy_(nu)

    def load_state_dict(self, state_dict: dict) -> None:
        """torch casts every loaded moment to its parameter's dtype: the
        first moment goes back to ``moment_dtype``."""
        super().load_state_dict(state_dict)
        for group in self.param_groups:
            for p in group["params"]:
                if "mu" in self.state.get(p, {}):
                    self.state[p]["mu"] = self.state[p]["mu"].to(group["moment_dtype"])


def describe(tx: "Optimizer") -> str:
    """The optimizer's name, with a first moment kept in another dtype."""
    return "AdamW, moment_dtype bfloat16" if isinstance(tx.opt, AdamWMoments) else \
        type(tx.opt).__name__


def state_bytes(tx: "Optimizer") -> int:
    """Bytes of the optimizer's state tensors (moments, factored rows)."""
    return sum(v.numel() * v.element_size() for st in tx.opt.state.values()
               for v in st.values() if isinstance(v, torch.Tensor))


def _bf16_moments(moment_dtype) -> bool:
    if moment_dtype in (None, "None", "float32", torch.float32):
        return False
    if moment_dtype in ("bfloat16", torch.bfloat16):
        return True
    raise ValueError(f"moment_dtype must be float32/bfloat16, got {moment_dtype!r}")


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
        opt = Adafactor(params, lr=lr, weight_decay=weight_decay)
    else:
        raise ValueError(
            f"unknown optimizer {name!r}; choose AdamW/Adam/AdaFactor/DeepSpeedCPUAdam")
    return Optimizer(opt, schedule, grad_clip)


def make_grouped_optimizer(named_params: Iterable[tuple[str, torch.Tensor]],
                           group_fn: Callable[[str], str], group_lrs: Mapping[str, float],
                           weight_decay: float = 0.0, decay_groups: tuple = (),
                           optimizer: str = "adamw", moment_dtype: str | None = None) -> Optimizer:
    """One parameter group per label: ``group_fn`` maps a parameter's name
    to its label, ``group_lrs`` a label to its rate, and the labels in
    ``decay_groups`` get ``weight_decay`` (the others 0).  ``optimizer``:
    ``"adamw"`` (``torch.optim.AdamW``; with ``moment_dtype="bfloat16"``
    ``AdamWMoments``) or ``"adafactor"`` (``Adafactor``, which keeps no
    first moment)."""
    name = optimizer.lower()
    bf16_moments = _bf16_moments(moment_dtype)
    if name == "adafactor":
        if bf16_moments:
            raise ValueError("moment_dtype applies to adamw only "
                             "(adafactor keeps no first moment)")
    elif name not in ("adamw", "deepspeedcpuadam"):
        raise ValueError(f"unknown grouped optimizer {optimizer!r}; choose adamw/adafactor")
    groups: dict[str, list] = {}
    for pname, p in named_params:
        groups.setdefault(group_fn(pname), []).append(p)
    unknown = sorted(set(groups) - set(group_lrs))
    if unknown:
        raise ValueError(f"parameter groups {unknown} have no learning rate")
    param_groups = [{"params": ps, "lr": group_lrs[label], "name": label,
                     "weight_decay": weight_decay if label in decay_groups else 0.0}
                    for label, ps in groups.items()]
    if name == "adafactor":
        opt = Adafactor(param_groups, lr=0.0)
    elif bf16_moments:
        opt = AdamWMoments(param_groups, lr=0.0)
    else:
        opt = torch.optim.AdamW(param_groups, betas=(0.9, 0.999), eps=1e-8)
    return Optimizer(opt, None, None)

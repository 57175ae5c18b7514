"""Tensor parallelism of the training layers: Megatron over the mesh's tp dim.

The JAX package puts tp on parameters by name (``param_partition_spec``:
column-parallel q/k/v/FF-in, row-parallel out/FF-out) and lets GSPMD split
the step.  Here the layers that run on the kernels split themselves, on
the rank's local shards (``parallel/sharding.shard_params`` hands them the
shards):

* the q/k/v product on the rank's column shards, the attention kernels on
  the rank's heads (``TensorParallel.heads``), the out-projection on its
  row shard: the partial products are summed over tp in f32, and only tp
  rank 0 adds the bias and the residual;
* the FF the same way: W1 column-parallel, GELU, W2 row-parallel.

``ops/layer_block.py`` and ``ops/esm2_block.py`` all-reduce inside their
autograd Functions: the forward's row-parallel products (``row_parallel``)
and the backward's partial input gradients before each ``layernorm_bwd``.  The layers on torch ops
(the Stage-3 ``block`` mode's attention boundary and FF) use the two
Megatron Functions: ``copy_to_tp`` (identity forward, all-reduce of the
gradient) and ``reduce_from_tp`` (all-reduce forward, identity backward).
A parameter the layer takes whole but slices by head or column (a q/k/v or
FF-in bias, replicated by the spec) goes through ``scatter_to_tp``, whose
backward assembles the whole gradient on every rank; ``gather_from_tp``
gathers a tp-sharded parameter whole for a module without a tp plan (its
backward keeps the rank's block of a gradient every rank computed alike).

Every collective is an all-reduce or an all-gather over the tp group.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class TensorParallel:
    """This rank's place on the tp dim: its ``group``, ``rank`` in it and
    the dim's ``size``."""

    group: object
    rank: int
    size: int

    @property
    def first(self) -> bool:
        """Tp rank 0, which adds the row-parallel products' bias and
        residual."""
        return self.rank == 0

    def block(self, n: int) -> slice:
        """This rank's contiguous block of ``n`` (JAX's tp shard of a dim)."""
        if n % self.size:
            raise ValueError(f"{n} does not split over tp={self.size}")
        return slice(self.rank * n // self.size, (self.rank + 1) * n // self.size)

    def heads(self, heads: int, local_heads: int = 0) -> tuple[int, int]:
        """(heads, band-local heads) of this rank's contiguous head block:
        the first ``local_heads`` heads of the layer are band-local, so the
        rank's block holds ``clamp(local_heads − r·H/tp, 0, H/tp)`` of them."""
        if heads % self.size:
            raise ValueError(f"{heads} heads do not split over tp={self.size}")
        n = heads // self.size
        return n, min(max(local_heads - self.rank * n, 0), n)


def of_mesh(mesh) -> TensorParallel | None:
    """The ``TensorParallel`` of a ``make_hybrid_mesh`` mesh's tp dim, or
    None where tp is 1."""
    if mesh.size(mesh.mesh_dim_names.index("tp")) == 1:
        return None
    sub = mesh["tp"]
    return TensorParallel(sub.get_group(), sub.get_local_rank(), sub.size())


def row_parallel(a: torch.Tensor, w: torch.Tensor, bias, residual, tp: TensorParallel | None,
                 out_dtype: torch.dtype) -> torch.Tensor:
    """``a·w + bias + residual`` in ``out_dtype`` on ``gemm_bias_act``;
    under tp (a, w the rank's columns and row shard) the ranks' products
    summed over tp in f32, rank 0's with the bias and the residual, then
    cast."""
    from biom3_tpu_torch.ops.kernels import gemm_bias_act

    if tp is None:
        return gemm_bias_act(a, w, bias, residual=residual, out_dtype=out_dtype)
    out = gemm_bias_act(a, w, bias if tp.first else None,
                        residual=residual if tp.first else None, out_dtype=torch.float32)
    return all_reduce_(out, tp).to(out_dtype)


def all_reduce_(x: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    """Sum ``x`` over tp in place (nothing without tp) → ``x``."""
    if tp is not None:
        dist.all_reduce(x, group=tp.group)
    return x


def _all_gather(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    """The ranks' ``x`` concatenated along ``dim`` in rank order."""
    x = x.movedim(dim, 0).contiguous()
    out = x.new_empty((tp.size * x.shape[0], *x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=tp.group)
    return out.movedim(0, dim)


class _CopyToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone(), ctx.tp), None


class _ReduceFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return all_reduce_(x.contiguous().clone(), tp)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _ScatterToTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return x.narrow(dim, tp.block(x.shape[dim]).start, x.shape[dim] // tp.size)

    @staticmethod
    def backward(ctx, g):
        return _all_gather(g, ctx.tp, ctx.dim), None, None


class _GatherFromTp(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp, dim):
        ctx.tp, ctx.dim = tp, dim
        return _all_gather(x, tp, dim)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[ctx.dim] // ctx.tp.size
        return g.narrow(ctx.dim, ctx.tp.rank * n, n), None, None


def copy_to_tp(x: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    """Identity; the gradient is summed over tp (the input of a
    column-parallel product, whose ranks each give a partial gradient)."""
    return x if tp is None else _CopyToTp.apply(x, tp)


def reduce_from_tp(x: torch.Tensor, tp: TensorParallel | None) -> torch.Tensor:
    """``x`` summed over tp (a row-parallel product's partial outputs); the
    gradient passes as it is."""
    return x if tp is None else _ReduceFromTp.apply(x, tp)


def scatter_to_tp(x: torch.Tensor, tp: TensorParallel | None, dim: int = 0) -> torch.Tensor:
    """This rank's block of ``x`` (whole on every rank) along ``dim``; the
    gradient is the ranks' blocks gathered whole."""
    return x if tp is None else _ScatterToTp.apply(x, tp, dim)


def gather_from_tp(x: torch.Tensor, tp: TensorParallel, dim: int) -> torch.Tensor:
    """The ranks' blocks of a tp-sharded tensor gathered whole along
    ``dim``; the gradient (the same on every rank) gives back this rank's
    block."""
    return _GatherFromTp.apply(x, tp, dim)

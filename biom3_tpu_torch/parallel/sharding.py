"""Batch rows over a mesh's (dp, fsdp) positions.

The port's counterpart of the JAX package's batch sharding
(``biom3_tpu/parallel/sharding.py``: ``P(("dp", "fsdp"))``) and of the
``shard_map`` bodies that run one forward per device with the parameters
replicated (``models/fused_forward.py:294-318``).  Batch shard ``s = i·fsdp
+ j`` takes the contiguous rows ``[s·B/n, (s+1)·B/n)``; under tp > 1 each
(dp, fsdp) row block runs once, at its tp = 0 position (in JAX the tp
positions compute the same rows).

``shard_rows`` issues each position's work on its own device without a
host sync: inputs and outputs move with ``non_blocking`` copies and
nothing is read back, so positions on distinct cards run at once, while
positions that share a card run one after another on its current stream.
Randomness stays with the caller, on the global batch: only the forward
is split.

The training half (JAX ``sharding.py:15-58``) works on a
``torch.distributed`` ``DeviceMesh``, one process per rank:
``params_shardings`` and ``shard_params`` place the parameters by
``param_partition_spec`` — over tp as ``DTensor`` shards that the layers
on the kernels split themselves by (``parallel/tensor.py``), over (dp,
fsdp) through FSDP2 —, ``put_global`` gives each rank its row block of a
batch that every rank holds whole, and ``data_group`` is the group of the
ranks holding other row blocks.
"""

from __future__ import annotations

import contextlib
import copy

import torch

from biom3_tpu_torch.parallel.mesh import (
    Mesh,
    axis_sizes,
    canonical,
    fsdp_dim,
    param_partition_spec,
)


def device_context(device: torch.device):
    """Make ``device`` current for a kernel launch (the wrappers launch on
    the current device's stream); nothing on the CPU."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


def split_rows(t: torch.Tensor, n: int) -> tuple[torch.Tensor, ...]:
    """``n`` contiguous row blocks of ``t`` (views), in shard order."""
    if t.shape[0] % n:
        raise ValueError(f"batch {t.shape[0]} not divisible by {n} mesh shards")
    return t.split(t.shape[0] // n)


def gather_rows(parts, device: torch.device):
    """Concatenate the shards' outputs (tensors, or tuples of tensors) in
    shard order on ``device``."""
    if isinstance(parts[0], tuple):
        return tuple(gather_rows([p[i] for p in parts], device) for i in range(len(parts[0])))
    return torch.cat([p.to(device, non_blocking=True) for p in parts])


def module_on(module: torch.nn.Module, device: torch.device) -> torch.nn.Module:
    """``module`` itself where it lies on ``device``, else a copy there."""
    here = canonical(next(module.parameters()).device)
    return module if here == device else copy.deepcopy(module).to(device)


def moved_to(tree, device: torch.device):
    """A copy of ``tree`` (tensors in dicts, lists and tuples) on ``device``."""
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    if isinstance(tree, dict):
        return {k: moved_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(moved_to(v, device) for v in tree)
    return tree


def per_position(mesh: Mesh, make) -> list:
    """``make(device)`` once per DISTINCT device of the batch positions →
    one object per position; positions on one device share it."""
    made: dict[torch.device, object] = {}
    for device in mesh.batch_devices():
        if device not in made:
            made[device] = make(device)
    return [made[d] for d in mesh.batch_devices()]


def shard_rows(fns: list, mesh: Mesh):
    """``fns[s]``, batch position s's function of row tensors, → one
    function of global tensors: each tensor argument (any other passes
    through) is split into the positions' row blocks, each block runs at
    its position on its device, and the outputs are gathered onto the
    mesh's first device.  The batch must divide by dp·fsdp; the returned
    function carries ``.mesh``."""
    devices = mesh.batch_devices()
    n, first = len(devices), mesh.first_device
    if len(fns) != n:
        raise ValueError(f"{len(fns)} functions for {n} batch positions")

    def sharded(*args):
        parts = [split_rows(a, n) if isinstance(a, torch.Tensor) else (a,) * n for a in args]
        outs = []
        for s, (device, fn) in enumerate(zip(devices, fns)):
            with device_context(device):
                outs.append(fn(*(p[s].to(device, non_blocking=True)
                                 if isinstance(p[s], torch.Tensor) else p[s] for p in parts)))
        return gather_rows(outs, first)

    sharded.mesh = mesh
    return sharded


# --- training: parameters and batches over a DeviceMesh ---------------------

def params_shardings(model: torch.nn.Module, mesh) -> dict[str, tuple]:
    """Parameter name → ``param_partition_spec`` on ``mesh``."""
    return {name: param_partition_spec(name, tuple(p.shape), mesh)
            for name, p in model.named_parameters()}


def _kernel_layers() -> tuple:
    """The modules whose ``forward`` hands their weights to a kernel
    wrapper: FSDP2 must gather those weights in that module's pre-forward
    hook, since the child ``Linear``s' ``forward`` never runs."""
    from biom3_tpu_torch.models.bert import BertLayer
    from biom3_tpu_torch.models.esm2 import ESM2Layer
    from biom3_tpu_torch.models.proteoscribe import TransformerLayer

    return (TransformerLayer, ESM2Layer, BertLayer)


def _megatron(module: torch.nn.Module) -> bool:
    """A layer that splits itself over tp (``parallel/tensor.py``): the
    Stage-3 layer in ``layer-block`` and ``block`` mode, the ESM2 layer in
    ``layer-block`` mode."""
    from biom3_tpu_torch.models.esm2 import ESM2Layer
    from biom3_tpu_torch.models.proteoscribe import TransformerLayer

    return ((isinstance(module, TransformerLayer) and module.attn_impl in ("layer-block", "block"))
            or (isinstance(module, ESM2Layer) and module.attn_impl == "layer-block"))


def _tp_dim(p) -> int | None:
    """The dim a parameter FSDP2 has gathered (a ``DTensor`` on the tp
    dim) is sharded over tp, else None."""
    return p.placements[-1].dim if p.placements[-1].is_shard() else None


def _localize_hooks(unit: torch.nn.Module, skip: set, tp) -> None:
    """Hooks on the FSDP2 unit ``unit`` that, for its forward, put plain
    tensors in place of its tp ``DTensor`` parameters (those of its
    subtree outside the nested units ``skip``), after FSDP2 has gathered
    them over (dp, fsdp): a Megatron layer gets the rank's shards, any
    other module each parameter gathered whole over tp
    (``gather_from_tp``, what GSPMD does for an op it does not split).
    The parameters go back before FSDP2's post-forward hook."""
    from biom3_tpu_torch.parallel.tensor import gather_from_tp

    local = _megatron(unit)
    slots = []
    stack = [unit]
    while stack:
        m = stack.pop()
        slots += [(m, n) for n, p in m._parameters.items() if p is not None]
        stack += [c for c in m.children() if c not in skip]
    saved = []

    def plain(p):
        dim = _tp_dim(p)
        return p.to_local() if local or dim is None else gather_from_tp(p.to_local(), tp, dim)

    def pre(module, args):
        saved[:] = [(m, n, m._parameters[n]) for m, n in slots]
        for m, n, p in saved:
            m._parameters[n] = plain(p)

    def post(module, args, out):
        for m, n, p in saved:
            m._parameters[n] = p
        saved.clear()

    unit.register_forward_pre_hook(pre)
    unit.register_forward_hook(post, prepend=True)


def shard_params(model: torch.nn.Module, mesh) -> torch.nn.Module:
    """Shard ``model`` in place over ``mesh``.

    tp first (tp > 1): each parameter becomes a ``DTensor`` on the mesh's
    tp dim, ``Shard`` on the dim ``param_partition_spec`` gives tp
    (``Replicate`` where it gives none), and each layer that splits itself
    over tp (``_megatron``) gets this rank's ``TensorParallel``.  Then
    FSDP2 (``fully_shard``) over the (dp, fsdp) dims: replicated over dp,
    sharded over fsdp (FSDP2's hybrid mode), each parameter on the dim the
    spec gives fsdp; FSDP2 lays a tp ``DTensor`` out on the whole (dp,
    fsdp, tp) mesh.  A parameter JAX does not shard over fsdp (1-D, or no
    dim divides) takes FSDP2's default, dim 0, padded where uneven: FSDP2
    shards every parameter of a module it wraps, and gathers it whole
    before the forward either way.  Each layer in ``_kernel_layers`` is
    wrapped, then the root; no mixed-precision policy, so the numbers are
    the one-device step's.  At tp > 1 each wrapped module's forward sees
    plain tensors (``_localize_hooks``).  ``model`` must already lie on the
    mesh's device."""
    from torch.distributed.fsdp import fully_shard
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from biom3_tpu_torch.parallel.tensor import of_mesh

    specs = {n: param_partition_spec(n, tuple(p.shape), mesh)
             for n, p in model.named_parameters()}
    tp = of_mesh(mesh)
    if tp is not None:
        for name, p in list(model.named_parameters()):
            owner, leaf = model, name
            if "." in name:
                path, leaf = name.rsplit(".", 1)
                owner = model.get_submodule(path)
            spec = specs[name]
            placement = Shard(spec.index("tp")) if "tp" in spec else Replicate()
            owner.register_parameter(leaf, torch.nn.Parameter(
                distribute_tensor(p.detach(), mesh["tp"], [placement], src_data_rank=None),
                requires_grad=p.requires_grad))
        for module in model.modules():
            if _megatron(module):
                tp.heads(module.heads)   # the rank's whole heads, or raise now
                for m in module.modules():
                    if hasattr(m, "tp"):
                        m.tp = tp
    by_id = {id(p): specs[n] for n, p in model.named_parameters()}

    def placement(p):
        dim = fsdp_dim(by_id[id(p)])
        return None if dim is None else Shard(dim)

    data_mesh = mesh["dp", "fsdp"]
    units = [m for m in model.modules() if isinstance(m, _kernel_layers())]
    for module in units:
        fully_shard(module, mesh=data_mesh, shard_placement_fn=placement)
    fully_shard(model, mesh=data_mesh, shard_placement_fn=placement)
    if tp is not None:
        for unit in units + [model]:
            _localize_hooks(unit, set(units), tp)
    return model


def data_group(mesh):
    """The process group of this rank's tp position over (dp, fsdp): the
    ranks holding other rows, over which the steps reduce what they report
    and gather the contrastive batch (the tp ranks of one row block hold
    the same rows).  None, the world group, at tp = 1.  A collective: every
    rank calls it, once per mesh."""
    import torch.distributed as dist

    if axis_sizes(mesh)["tp"] == 1:
        return None
    ranks = mesh.mesh.reshape(-1, mesh.mesh.shape[-1]).t().tolist()
    group, _ = dist.new_subgroups_by_enumeration(ranks)
    return group


def batch_sharding(mesh, rows: int) -> slice:
    """This rank's contiguous row block of a batch of ``rows``: batch shard
    ``s = dp_index·fsdp + fsdp_index`` of dp·fsdp (JAX's ``P(("dp",
    "fsdp"))`` order); the tp ranks of one (dp, fsdp) block share it."""
    sizes = axis_sizes(mesh)
    n = sizes["dp"] * sizes["fsdp"]
    if rows % n:
        raise ValueError(f"batch {rows} not divisible by {n} (dp x fsdp) shards")
    s = mesh.get_local_rank("dp") * sizes["fsdp"] + mesh.get_local_rank("fsdp")
    return slice(s * rows // n, (s + 1) * rows // n)


def put_global(value: torch.Tensor, mesh) -> torch.Tensor:
    """This rank's row block (``batch_sharding``) of ``value``, a batch
    that every rank holds whole (built from the same seed on each, as the
    reference fed each rank the same DataLoader shards), on the rank's
    device (its current card, or the CPU)."""
    device = (torch.device("cuda", torch.cuda.current_device()) if mesh.device_type == "cuda"
              else torch.device(mesh.device_type))
    return value[batch_sharding(mesh, value.shape[0])].to(device).contiguous()

"""Serving-path ProteoScribe forward on the port's kernels.

Port of ``biom3_tpu/models/fused_forward.py:28-56,151-318``.
``make_stack_apply(model)`` packs the plain module's weights once — q/k/v
fused and every matrix transposed to (d_in, d_out) in the serving dtype,
the (T, depth, d) time-bias table precomputed — and returns
``apply(x, t, z_c, pos) → (B, k, C) f32``, the sampler's
``apply_takes_positions`` contract (``ops.stack.stack_logits``).  The JAX
package's ``_cond_mlp`` is the ``ConditioningMLP`` module's own forward
here.  ``ff_quant``/``proj_quant="int8"`` pack the FF or the q/k/v/out
matrices as per-output-channel int8 (``ops/quant.py``, from the f32
weights, as the JAX package packs them, fused_forward.py:244-256).
``stack_supported(cfg)`` is the shape gate of ``plan_stack_kernel``
(fused_forward.py:94-101) for the port's kernels: the engine serves a
config it refuses through the ``ProteoScribe`` module.  On the CPU the
plain versions take any head dim and window, so only ``n_blocks`` binds
``make_stack_apply`` itself.  ``make_sharded_stack_apply(model, mesh)`` is
its mesh twin: the batch's rows split over the mesh's (dp, fsdp)
positions, the weights packed once per distinct device.
"""

from __future__ import annotations

import logging

import torch
import torch.nn.functional as F

from biom3_tpu_torch.models.proteoscribe import (
    LN_EPS,
    ProteoScribe,
    sinusoidal_time_embedding,
)
from biom3_tpu_torch.ops.kernels import HEAD_CLASSES
from biom3_tpu_torch.ops.quant import quantize_weight_int8
from biom3_tpu_torch.ops.stack import QUANT_MODES, pack_stack_weights, stack_logits
from biom3_tpu_torch.parallel.sharding import module_on, per_position, shard_rows

HEAD_DIMS = (32, 64)        # the attention kernels' head dims (ops/kernels.py)
_LOGGED: set[str] = set()   # fallback reasons already logged in this process


def log_once(msg: str) -> None:
    """Log an engine's fallback from the kernels once per process."""
    if msg not in _LOGGED:
        _LOGGED.add(msg)
        logging.getLogger("biom3_tpu_torch").warning(msg)


def stack_supported(cfg) -> tuple[bool, str]:
    """(True, "") when the stack forward's kernels take ``cfg``, else
    (False, the first reason): one block, d divisible by the heads, a head
    dim the attention kernels take, L a multiple of the window, and the
    window tiled by ``stage3_attention_core``'s query tile, and at most 32
    classes (``gather_head``'s n32 head).  d = heads · head dim is then a
    multiple of 32, which every GEMM (int8: K % 32) and row-wise kernel
    (d % 8, ``gather_head`` d % 16) takes."""
    d, heads, L, W = cfg.dim, cfg.heads, cfg.max_seq_len, cfg.local_window
    if cfg.n_blocks != 1:
        return False, f"n_blocks={cfg.n_blocks} (the stack forward serves one block)"
    if cfg.num_classes > HEAD_CLASSES:
        return False, f"num_classes={cfg.num_classes} (gather_head takes {HEAD_CLASSES})"
    if d % heads:
        return False, f"dim={d} not divisible by heads={heads}"
    dh = d // heads
    if dh not in HEAD_DIMS:
        return False, f"head dim {dh} (the attention kernels take {HEAD_DIMS})"
    if cfg.local_heads:
        if L % W:
            return False, f"max_seq_len={L} not divisible by local_window={W}"
        tile = min(W, 128 if dh == 32 else 64)
        if W % tile or tile % 8:
            return False, f"local_window={W} does not tile by {tile} query rows"
    return True, ""


def final_head(model: ProteoScribe, h: torch.Tensor) -> torch.Tensor:
    """Final LayerNorm (f32) + Linear → C on any (…, d) hidden slice."""
    core = model.transformer
    hn = F.layer_norm(h.float(), (h.shape[-1],), core.norm.weight, core.norm.bias, LN_EPS)
    return core.out(hn)


def time_bias_table(model: ProteoScribe) -> torch.Tensor:
    """(T, dim·n_blocks·depth) additive bias of every timestep."""
    cfg = model.config
    device = model.transformer.out.weight.device
    ts = torch.arange(cfg.num_timesteps, device=device)
    emb = sinusoidal_time_embedding(ts, cfg.dim, float(cfg.num_timesteps), cfg.rescale_steps)
    return model.transformer.mlp(emb)


@torch.no_grad()
def make_stack_apply(model: ProteoScribe, *, dtype: torch.dtype = torch.bfloat16,
                     gelu: str = "erf", ff_quant: str = "none", proj_quant: str = "none",
                     attn_quant: str = "none"):
    """Pack ``model`` for ``ops.stack.stack_logits``; returns
    ``apply(x (B, L) int, t (B,) int, z_c (B, cond_dim) | None, pos (B, k)
    int) → (B, k, C) f32``, k from 1 to L: confidence order and MaskGIT
    pass every position, ``pos`` (B, L), and get the full logit grid (the
    engine's ``gather_k``).  The module stays the owner of the condition
    MLP, which runs per call in f32.  ``attn_quant="int8"`` runs the
    band-local heads' products in int8 (``ops.stack.stack_logits``, which
    checks the mode at each call, as the TPU kernel does); no engine selects
    it, as in the JAX package."""
    cfg = model.config
    if cfg.n_blocks != 1:
        raise ValueError(f"the stack forward serves one block, got n_blocks={cfg.n_blocks}")
    for name, mode in (("ff_quant", ff_quant), ("proj_quant", proj_quant)):
        if mode not in QUANT_MODES:
            raise ValueError(f"{name} must be one of {QUANT_MODES}, got {mode!r}")
    core = model.transformer
    layers = list(core.transformer_blocks[0])
    depth, d = cfg.depth, cfg.dim

    def mats(get, quant: str):
        """(depth, d_in, d_out) in ``dtype``, or int8 (depth, d_out, d_in)
        codes and their (depth, d_out) scales."""
        if quant == "none":
            return torch.stack([get(layer).t() for layer in layers]).to(dtype).contiguous(), None
        q, s = quantize_weight_int8(torch.stack([get(layer).t() for layer in layers]))
        return q.transpose(1, 2).contiguous(), s.contiguous()

    def vecs(get):
        return torch.stack([get(layer) for layer in layers]).float().contiguous()

    (wq, sq), (wk, sk), (wv, sv), (wo, so) = (
        mats(lambda m, n=n: getattr(m.attn, n).weight, proj_quant)
        for n in ("to_q", "to_k", "to_v", "to_out"))
    (w1, s1), (w2, s2) = (mats(lambda m: m.ff.w1.weight, ff_quant),
                          mats(lambda m: m.ff.w2.weight, ff_quant))
    w = pack_stack_weights(
        core.x_emb_NN.weight.to(dtype).contiguous(),
        core.axial_pos_emb.table().to(dtype).contiguous(),
        vecs(lambda m: m.attn_norm.weight), vecs(lambda m: m.attn_norm.bias),
        wq, wk, wv, wo, vecs(lambda m: m.attn.to_out.bias),
        vecs(lambda m: m.ff_norm.weight), vecs(lambda m: m.ff_norm.bias),
        w1, vecs(lambda m: m.ff.w1.bias), w2, vecs(lambda m: m.ff.w2.bias),
        core.norm.weight.float().contiguous(), core.norm.bias.float().contiguous(),
        core.out.weight.t().to(dtype).contiguous(), core.out.bias.float().contiguous(),
        s1, s2, sq, sk, sv, so,
    )
    # (T, depth, d): the flat MLP output is laid out (d, depth)
    table = time_bias_table(model).reshape(cfg.num_timesteps, d, depth).transpose(1, 2)
    table = table.contiguous()

    @torch.no_grad()
    def apply(x, t, z_c=None, pos=None):
        if pos is None:
            raise ValueError("stack apply requires decode positions")
        bias = table[t.long()]
        if model.conditional:
            if z_c is None:
                raise ValueError("conditional model requires z_c")
            yb = core.y_mlp(z_c.float())
            bias = bias + yb.reshape(z_c.shape[0], d, depth).transpose(1, 2)
        return stack_logits(x.to(torch.int32).contiguous(), pos.to(torch.int32).contiguous(),
                            bias.to(dtype), w, local_heads=cfg.local_heads, heads=cfg.heads,
                            window=cfg.local_window, gelu=gelu, attn_quant=attn_quant)

    return apply


def make_sharded_stack_apply(model: ProteoScribe, mesh, **kwargs):
    """Mesh twin of ``make_stack_apply`` (JAX ``make_sharded_stack_apply``,
    fused_forward.py:294-318): ``apply(x, t, z_c, pos)`` on global tensors
    on the mesh's first device, each (dp, fsdp) position's rows through the
    stack forward on its own device, the logits gathered back in row order.
    ``make_stack_apply(**kwargs)`` packs once per distinct device (the
    model itself serves its own device, a copy each other one); no
    collectives, as denoising is batch-parallel.  B must be a multiple of
    dp·fsdp."""
    return shard_rows(per_position(mesh, lambda d: make_stack_apply(module_on(model, d),
                                                                    **kwargs)), mesh)

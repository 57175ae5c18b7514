"""Serving-path ProteoScribe forward on the port's kernels.

Port of ``biom3_tpu/models/fused_forward.py:28-56,151-291``.
``make_stack_apply(model)`` packs the plain module's weights once — q/k/v
fused and every matrix transposed to (d_in, d_out) in the serving dtype,
the (T, depth, d) time-bias table precomputed — and returns
``apply(x, t, z_c, pos) → (B, k, C) f32``, the sampler's
``apply_takes_positions`` contract (``ops.stack.stack_logits``).  The JAX
package's ``_cond_mlp`` is the ``ConditioningMLP`` module's own forward
here.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from biom3_tpu_torch.models.proteoscribe import (
    LN_EPS,
    ProteoScribe,
    sinusoidal_time_embedding,
)
from biom3_tpu_torch.ops.stack import pack_stack_weights, stack_logits


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
                     gelu: str = "erf"):
    """Pack ``model`` for ``ops.stack.stack_logits``; returns
    ``apply(x (B, L) int, t (B,) int, z_c (B, cond_dim) | None, pos (B, k)
    int) → (B, k, C) f32``.  The module stays the owner of the condition
    MLP, which runs per call in f32."""
    cfg = model.config
    if cfg.n_blocks != 1:
        raise ValueError(f"the stack forward serves one block, got n_blocks={cfg.n_blocks}")
    core = model.transformer
    layers = list(core.transformer_blocks[0])
    depth, d = cfg.depth, cfg.dim

    def mats(get):
        return torch.stack([get(layer).t() for layer in layers]).to(dtype).contiguous()

    def vecs(get):
        return torch.stack([get(layer) for layer in layers]).float().contiguous()

    w = pack_stack_weights(
        core.x_emb_NN.weight.to(dtype).contiguous(),
        core.axial_pos_emb.table().to(dtype).contiguous(),
        vecs(lambda m: m.attn_norm.weight), vecs(lambda m: m.attn_norm.bias),
        mats(lambda m: m.attn.to_q.weight), mats(lambda m: m.attn.to_k.weight),
        mats(lambda m: m.attn.to_v.weight),
        mats(lambda m: m.attn.to_out.weight), vecs(lambda m: m.attn.to_out.bias),
        vecs(lambda m: m.ff_norm.weight), vecs(lambda m: m.ff_norm.bias),
        mats(lambda m: m.ff.w1.weight), vecs(lambda m: m.ff.w1.bias),
        mats(lambda m: m.ff.w2.weight), vecs(lambda m: m.ff.w2.bias),
        core.norm.weight.float().contiguous(), core.norm.bias.float().contiguous(),
        core.out.weight.t().to(dtype).contiguous(), core.out.bias.float().contiguous(),
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
                            window=cfg.local_window, gelu=gelu)

    return apply

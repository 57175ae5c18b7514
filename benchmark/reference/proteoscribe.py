"""ProteoScribe (BioM3 Stage 3) written out in plain float32 PyTorch.

The conditional OA-ARDM denoiser of BioM3 (bioRxiv 2024.11.11.622734;
``Stage3_source/cond_diff_transformer_layer.py``): token embedding plus two
summed axial position tables; a sinusoidal time embedding (``half - 1``
divisor, t rescaled to 4000) through an MLP (Linear → softplus → Linear) into
one additive bias per layer, plus the same MLP on z_c; ``depth`` pre-norm
layers (LayerNorm eps 1e-6), each split-head attention — the first
``local_heads`` heads band-local (a window of W queries attends to the keys of
windows w-1, w, w+1), the rest linear attention (softmax of q over features
scaled by dh^-0.5, softmax of k over the sequence, q'(k'ᵀv)) — then an erf-GELU
feed-forward of width 4d; final LayerNorm and a Linear to 29 classes.

The parameters are the published state-dict keys (``layout``).  The loss is
the negative OA-ARDM ELBO estimate; ``adamw_step`` is AdamW with decoupled
decay, and ``ema_update`` the parameters' moving average.  Imports nothing of
the program.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from reference.common import FP32, Precision, gelu, layer_norm

LN_EPS = 1e-6
PREFIX = "transformer.transformer_blocks.0.{l}.layers.layers.0."


def dims(cfg: dict) -> dict:
    """The sizes of a Stage-3 config section (the published JSON keys)."""
    d = int(cfg["transformer_dim"])
    return {"C": int(cfg["num_classes"]), "d": d, "depth": int(cfg["transformer_depth"]),
            "heads": int(cfg["transformer_heads"]), "local": int(cfg["transformer_local_heads"]),
            "W": int(cfg["transformer_local_size"]), "L": int(cfg["diffusion_steps"]),
            "cond": int(cfg["text_emb_dim"]), "ff": 4 * d}


def layout(cfg: dict) -> dict[str, tuple]:
    """Published state-dict key → shape."""
    s = dims(cfg)
    d, L, W, ff, depth = s["d"], s["L"], s["W"], s["ff"], s["depth"]
    out = {
        "transformer.x_emb_NN.weight": (s["C"], d),
        "transformer.axial_pos_emb.weights_0": (1, L // W, 1, d),
        "transformer.axial_pos_emb.weights_1": (1, 1, W, d),
        "transformer.mlp.0.weight": (4 * d, d), "transformer.mlp.0.bias": (4 * d,),
        "transformer.mlp.2.weight": (d * depth, 4 * d), "transformer.mlp.2.bias": (d * depth,),
        "transformer.y_mlp.0.weight": (4 * d, s["cond"]), "transformer.y_mlp.0.bias": (4 * d,),
        "transformer.y_mlp.2.weight": (d * depth, 4 * d), "transformer.y_mlp.2.bias": (d * depth,),
    }
    for layer in range(depth):
        p = PREFIX.format(l=layer)
        out.update({
            p + "0.norm.weight": (d,), p + "0.norm.bias": (d,),
            p + "0.fn.to_q.weight": (d, d), p + "0.fn.to_k.weight": (d, d),
            p + "0.fn.to_v.weight": (d, d), p + "0.fn.to_out.weight": (d, d),
            p + "0.fn.to_out.bias": (d,),
            p + "1.norm.weight": (d,), p + "1.norm.bias": (d,),
            p + "1.fn.fn.w1.weight": (ff, d), p + "1.fn.fn.w1.bias": (ff,),
            p + "1.fn.fn.w2.weight": (d, ff), p + "1.fn.fn.w2.bias": (d,),
        })
    out.update({"transformer.norm.weight": (d,), "transformer.norm.bias": (d,),
                "transformer.out.weight": (s["C"], d), "transformer.out.bias": (s["C"],)})
    return out


def time_embedding(t, d: int, num_steps: int):
    t = t.float() / num_steps * 4000.0
    half = d // 2
    freq = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                     * -(math.log(10000.0) / (half - 1)))
    ang = t[:, None] * freq[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _mlp(p, name, x, prec):
    h = F.softplus(prec.linear(x, p[name + ".0.weight"], p[name + ".0.bias"], "cond"))
    return prec.linear(h, p[name + ".2.weight"], p[name + ".2.bias"], "cond")


def band_attention(q, k, v, W: int, prec: Precision):
    """(B, H, L, dh) each; keys of the neighbouring windows, out-of-range
    windows masked."""
    B, H, L, dh = q.shape
    nw = L // W
    win = lambda z: z.reshape(B, H, nw, W, dh)  # noqa: E731

    def around(z):
        z = F.pad(win(z), (0, 0, 0, 0, 1, 1))
        return torch.cat([z[:, :, 0:nw], z[:, :, 1:nw + 1], z[:, :, 2:nw + 2]], dim=3)

    kk, vv = around(k), around(v)
    s = prec.matmul(win(q), kk.transpose(-1, -2)) * dh ** -0.5
    w_idx = torch.arange(nw, device=q.device)[:, None] + torch.arange(3, device=q.device) - 1
    invalid = ((w_idx < 0) | (w_idx >= nw)).repeat_interleave(W, dim=-1)   # (nw, 3W)
    s = s.masked_fill(invalid[:, None, :], float("-inf"))
    return prec.matmul(torch.softmax(s, dim=-1), vv).reshape(B, H, L, dh)


def linear_attention(q, k, v, prec: Precision):
    dh = q.shape[-1]
    qs = torch.softmax(q, dim=-1) * dh ** -0.5
    ks = torch.softmax(k, dim=-2)
    return prec.matmul(qs, prec.matmul(ks.transpose(-1, -2), v))


def hidden(p: dict, cfg: dict, x, t, z_c, prec: Precision = FP32):
    """x (B, L) ids, t (B,), z_c (B, cond) → final hidden states (B, L, d)."""
    s = dims(cfg)
    d, depth, H, nl = s["d"], s["depth"], s["heads"], s["local"]
    B, L = x.shape
    dh = d // H
    pos = (p["transformer.axial_pos_emb.weights_0"] + p["transformer.axial_pos_emb.weights_1"])
    emb = p["transformer.x_emb_NN.weight"].float()[x.long()] + pos.reshape(-1, d)[None, :L].float()
    bias = (_mlp(p, "transformer.mlp", time_embedding(t, d, s["L"]), prec)
            + _mlp(p, "transformer.y_mlp", z_c.float(), prec)).reshape(B, d, depth)
    h = emb
    for layer in range(depth):
        pre = PREFIX.format(l=layer)
        h = h + bias[:, :, layer][:, None, :]
        a = layer_norm(h, p[pre + "0.norm.weight"], p[pre + "0.norm.bias"], LN_EPS)
        split = lambda z: z.reshape(B, L, H, dh).transpose(1, 2)  # noqa: E731
        q, k, v = (split(prec.linear(a, p[pre + f"0.fn.to_{n}.weight"], kind="proj"))
                   for n in "qkv")
        heads = []
        if nl:
            heads.append(band_attention(q[:, :nl], k[:, :nl], v[:, :nl], s["W"], prec))
        if nl < H:
            heads.append(linear_attention(q[:, nl:], k[:, nl:], v[:, nl:], prec))
        ctx = torch.cat(heads, dim=1).transpose(1, 2).reshape(B, L, d)
        h = h + prec.linear(ctx, p[pre + "0.fn.to_out.weight"], p[pre + "0.fn.to_out.bias"],
                            "proj")
        f = layer_norm(h, p[pre + "1.norm.weight"], p[pre + "1.norm.bias"], LN_EPS)
        f = gelu(prec.linear(f, p[pre + "1.fn.fn.w1.weight"], p[pre + "1.fn.fn.w1.bias"], "ff"))
        h = h + prec.linear(f, p[pre + "1.fn.fn.w2.weight"], p[pre + "1.fn.fn.w2.bias"], "ff")
    return h


def head(p: dict, h, prec: Precision = FP32):
    hn = layer_norm(h, p["transformer.norm.weight"], p["transformer.norm.bias"], LN_EPS)
    return prec.linear(hn, p["transformer.out.weight"], p["transformer.out.bias"], "head")


@torch.no_grad()
def logits_at(p: dict, cfg: dict, x, t, z_c, positions, prec: Precision = FP32,
              rows: int = 8):
    """(B, k, C) float32 logits at ``positions`` (B, k), ``rows`` batch rows
    at a time."""
    outs = []
    for i in range(0, x.shape[0], rows):
        h = hidden(p, cfg, x[i:i + rows], t[i:i + rows], z_c[i:i + rows], prec)
        pos = positions[i:i + rows].long()
        hg = torch.gather(h, 1, pos[..., None].expand(-1, -1, h.shape[-1]))
        outs.append(head(p, hg, prec))
    return torch.cat(outs)


def elbo_loss(p: dict, cfg: dict, tokens, z_c, path, t, prec: Precision = FP32):
    """The negative OA-ARDM ELBO estimate of one batch: tokens kept where the
    path's rank is below t, the absorbing state 0 elsewhere; the masked
    positions' log-likelihood summed per row, weighted by 1 / (L - t + 1)."""
    L = tokens.shape[1]
    masked = torch.where(path < t[:, None], tokens, torch.zeros_like(tokens))
    logp = torch.log_softmax(head(p, hidden(p, cfg, masked, t, z_c, prec), prec), dim=-1)
    true = logp.gather(-1, tokens.long()[..., None])[..., 0]
    per_row = (true * (masked == 0).float()).sum(-1)
    return -(per_row / (L - t.float() + 1.0)).mean()


@torch.no_grad()
def adamw_step(params: dict, grads: dict, state: dict, *, lr: float,
               betas=(0.9, 0.999), eps: float = 1e-8, weight_decay: float = 0.0) -> None:
    """One AdamW step in place (decoupled decay, bias-corrected moments,
    eps outside the square root).  ``state``: name → [m, v, steps taken],
    a missing leaf starting at zeros and 0."""
    b1, b2 = betas
    for name, p in params.items():
        g = grads[name]
        m, v, done = state.setdefault(name, [torch.zeros_like(p), torch.zeros_like(p), 0])
        step = state[name][2] = done + 1
        p.mul_(1.0 - lr * weight_decay)
        m.mul_(b1).add_(g, alpha=1.0 - b1)
        v.mul_(b2).addcmul_(g, g, value=1.0 - b2)
        denom = (v / (1.0 - b2 ** step)).sqrt_().add_(eps)
        p.addcdiv_(m, denom, value=-lr / (1.0 - b1 ** step))


@torch.no_grad()
def ema_update(ema: dict, params: dict, beta: float) -> None:
    """The parameters' moving average in place: ema ← β·ema + (1 − β)·p,
    written ema + (1 − β)·(p − ema)."""
    for name, e in ema.items():
        e.add_((params[name] - e) * (1.0 - beta))

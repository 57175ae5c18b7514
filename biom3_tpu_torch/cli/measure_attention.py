"""The attention kernels that run on the tensor cores, on one CUDA card:
``flash_attention``, ``esm2_attention``, ``esm2_attention_bwd``,
``dense_attention``, ``local_window_attention`` and ``stage3_attention_core``
(its band heads).

    python -m biom3_tpu_torch.cli.measure_attention [--iters 50] [--out build/measure_attention.json]
        [--only PREFIX ...] [--plan-sweep]

At ``chip_smoke.py`` phase 3's timed shape (ESM2-650M width: B=2, 20
heads, L=1024, head dim 64; one full-length row and one of 400 tokens
with a PAD tail): each kernel is held against its plain version
(max|Δ|/max|ref| <= 2e-2, the attention gradient per 64-column head
group), then timed by CUDA events beside one PyTorch call of the same
function (``scaled_dot_product_attention`` with the key mask; for the
ESM2 kernels on the already-rotated q, k, the rotation left out, and for
the gradient autograd through it, the graph built once).  Reported: ms
per call, TFLOP/s on the FLOPs the function needs (4·Dh per (query, live
key) pair forward, 10·Dh backward; the backward kernel's own work, 18·Dh,
beside it), the least time the card could take (``bound_ms``: those FLOPs
at 989 TFLOP/s, or the bytes at 3.35 TB/s if larger), its share of the
kernel's time, and the kernel's time over the library call's; the
wrapper's host µs per call (the enqueue); and each kernel launch's device
ms per call from ``torch.profiler`` (the gradient's staging launch and its
two passes apart, as the forward's staging and its sweep), their sum
(``device_ms``) and the bound's share of it.  ``--only`` measures the
cases whose names start with the prefixes given; ``--plan-sweep`` also
times ``stage3_attention_core`` at B=2, 4 and 32 under other splits of
its linear heads than ``ops/kernels.stage3_linear_plan``'s (ctx chunks 1,
4, 16; statistics blocks of 64 and 256 rows; output blocks of 128 and 512
rows), device ms per launch beside the plan's own.  ``dense_attention``
(the BERT tower's unmasked heads) is measured the same way at BERT's
width (L = 512, 12 heads of 64) at B=2, phase 3's timed batch, and B=16,
PenCL's, beside SDPA with no mask.  ``local_window_attention`` (bf16)
is measured at phase 3's shape (B=4, 8 heads, L=1024, head dim 32, W=128)
and at Stage-3 B=32, beside SDPA with the boolean (L, L) band mask, its
FLOPs 4·Dh per (query, band key) pair.  ``stage3_attention_core`` (the
fused Stage-3 attention: 8 band heads and 8 linear heads of 32 on the
(B, L, 3·512) qkv, W=128) at phase 3's shape (B=4) and Stage-3 B=32,
beside SDPA with the band mask on the 8 band heads alone (the linear
heads have no library call), its FLOPs 4·Dh per band pair plus 4·L·Dh²
a linear head, held per 32-column head group; its profile shows its
three launches (the linear heads' statistics, their ctx, and the band
heads with the linear output rows).  ``stage3_attention_core_i8`` (the
band heads' QKᵀ and PV in int8) at the same two batches on the same
kind of qkv, beside ``stage3_attention_core`` (bf16) on the same qkv, as
no library call computes it: its ops 4·Dh a band pair at the int8 peak
(the linear heads' at bf16's), its bytes qkv in and the head outputs
out; the profile shows its quantize pre-pass, the linear heads' two
launches and the band kernel with the linear output rows.  Then the ``stage3_graph`` path's
forward, ``ProteoScribe(attn_impl="kernel")`` in bf16 at full width on
seeded weights, at B=2 and B=32: ms per forward by CUDA events and a
device profile by kernel.  Prints one JSON object with the card's name and
power limit and writes it to ``--out``.

Two versions in one call (the same card): run this file from another
checkout's root with that checkout first on the path, e.g.
``cd parent && PYTHONPATH=. python ../biom3_tpu_torch/cli/measure_attention.py``;
it then builds and times that checkout's kernels.  Exits non-zero without
a card.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

from biom3_tpu_torch.cli.measure_gemm import nbytes
from biom3_tpu_torch.utils.flops import PEAK_BF16, PEAK_INT8, PEAK_BYTES  # H100 SXM data sheet

REL_TOL = 2e-2
B, H, L, DH = 2, 20, 1024, 64
LENGTHS = (1024, 400)
BERT_L, BERT_H, BERT_BATCHES = 512, 12, (2, 16)
LOCAL_H, LOCAL_DH, LOCAL_W, LOCAL_BATCHES = 8, 32, 128, (4, 32)   # Stage 3's band heads
STAGE3_HEADS = 16                                                  # 8 band + 8 linear
GRAPH_BATCHES = (2, 32)
# kernel name fragment → its name in the profile breakdown
LAUNCHES = (("esm2_bwd_stage", "stage"), ("esm2_bwd_dq", "pass1_dq"),
            ("esm2_bwd_dkv", "pass2_dkv"), ("flash_attn", "flash"),
            ("esm2_attn_stage", "fwd_stage"), ("esm2_attn", "fwd_sweep"),
            ("dense_attn", "dense"), ("local_attn", "local"),
            ("stage3_linear_stats", "linear_stats"), ("stage3_linear_ctx", "linear_ctx"),
            ("stage3_local_wgmma", "band_and_linear_rows"),
            ("stage3_i8_quant", "i8_quant"), ("stage3_i8_band", "i8_band_and_linear_rows"),
            ("stage3_bwd_dq", "band_pass1_dq"), ("stage3_bwd_dkv", "band_pass2_dkv"),
            ("lin_bwd1", "linear_bwd1"), ("lin_bwd2", "linear_bwd2"), ("lin_bwd3", "linear_bwd3"))
LIN_CHUNKS = (64, 128, 256, 512, 1024)   # --lin-chunk-sweep: rows a linear-heads backward block


def rel_err(got, want, group: int = 0) -> float:
    got, want = got.float(), want.float()
    if not bool(got.isfinite().all()):
        raise AssertionError("kernel output has non-finite values")
    if group:
        got = got.reshape(-1, got.shape[-1] // group, group)
        want = want.reshape(-1, want.shape[-1] // group, group)
        return float(((got - want).abs().amax((0, 2))
                      / want.abs().amax((0, 2)).clamp(min=1e-30)).max())
    return float((got - want).abs().max() / want.abs().max().clamp(min=1e-30))


def cases(g) -> dict[str, dict]:
    """Kernel → {"run", "plain", "lib", "flops", "work_flops", "bytes",
    "group"} at the timed shape on ``g``'s device."""
    import torch
    import torch.nn.functional as F

    from biom3_tpu_torch.ops import kernels as K
    from biom3_tpu_torch.ops.rotary import apply_rotary, rotary_cos_sin

    dev, bf = g.device, torch.bfloat16
    E = H * DH

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    pad = torch.ones((B, L), dtype=torch.int32, device=dev)
    for b, n in enumerate(LENGTHS):
        pad[b, :n] = 0
    pairs = L * sum(LENGTHS)          # (query, live key) pairs of one head
    keep = (pad == 0)[:, None, None, :]
    q, k, v = rnd(B, H, L, DH), rnd(B, H, L, DH), rnd(B, H, L, DH)
    qkv, da = rnd(B, L, 3 * E), rnd(B, L, E)
    cos, sin = rotary_cos_sin(L, DH, dtype=bf, device=dev)
    heads = [t.view(B, L, H, DH).transpose(1, 2) for t in qkv.split(E, dim=-1)]
    qs, ks, vs = (apply_rotary(heads[0], cos, sin), apply_rotary(heads[1], cos, sin),
                  heads[2].contiguous())
    qs, ks, vs = (t.detach().contiguous().requires_grad_() for t in (qs, ks, vs))
    rotated = tuple(t.detach() for t in (qs, ks, vs))
    sdpa = F.scaled_dot_product_attention(qs, ks, vs, attn_mask=keep)
    dsdpa = da.view(B, L, H, DH).transpose(1, 2)

    def dense(b):
        qkvb = rnd(b, BERT_L, 3 * BERT_H * DH)
        heads = [t.view(b, BERT_L, BERT_H, DH).transpose(1, 2)
                 for t in qkvb.split(BERT_H * DH, dim=-1)]
        flops = 4 * b * BERT_H * BERT_L * BERT_L * DH
        return {"run": lambda: K.dense_attention(qkvb, heads=BERT_H),
                "plain": lambda: K.dense_attention_plain(qkvb, heads=BERT_H),
                "lib": lambda: F.scaled_dot_product_attention(*heads),
                "flops": flops, "work_flops": flops,
                "bytes": nbytes(qkvb) + b * BERT_L * BERT_H * DH * 2, "group": 0}

    return {
        "flash_attention": {
            "run": lambda: K.flash_attention(q, k, v, pad),
            "plain": lambda: K.flash_attention_plain(q, k, v, pad),
            "lib": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=keep),
            "flops": 4 * H * pairs * DH, "work_flops": 4 * H * pairs * DH,
            "bytes": nbytes(q, k, v, pad) + nbytes(q), "group": 0},
        "esm2_attention": {
            "run": lambda: K.esm2_attention(qkv, pad, cos, sin, heads=H),
            "plain": lambda: K.esm2_attention_plain(qkv, pad, cos, sin, heads=H),
            "lib": lambda: F.scaled_dot_product_attention(*rotated, attn_mask=keep),
            "flops": 4 * H * pairs * DH, "work_flops": 4 * H * pairs * DH,
            "bytes": nbytes(qkv, pad, cos, sin) + nbytes(da), "group": 0},
        "esm2_attention_bwd": {
            "run": lambda: K.esm2_attention_bwd(qkv, da, pad, cos, sin, heads=H),
            "plain": lambda: K.esm2_attention_bwd_plain(qkv, da, pad, cos, sin, heads=H),
            "lib": lambda: torch.autograd.grad(sdpa, (qs, ks, vs), dsdpa, retain_graph=True),
            "flops": 10 * H * pairs * DH, "work_flops": 18 * H * pairs * DH,
            "bytes": nbytes(qkv, da, pad, cos, sin) + nbytes(qkv), "group": DH},
        **{f"dense_attention_B{b}": dense(b) for b in BERT_BATCHES},
        **{f"local_window_attention_B{b}": local(b, g) for b in LOCAL_BATCHES},
        **{f"stage3_attention_core_B{b}": stage3(b, g) for b in LOCAL_BATCHES},
        **{f"stage3_attention_bwd_B{b}": stage3_bwd(b, g) for b in LOCAL_BATCHES},
        **{f"stage3_attention_core_i8_B{b}": stage3_i8(b, g) for b in LOCAL_BATCHES},
    }


def band_pairs(b: int, L: int, window: int, heads: int) -> int:
    """(query, key) pairs of the band: each window's queries see windows
    w-1..w+1 that exist."""
    nw = L // window
    keys = sum(min(nw, w + 2) - max(0, w - 1) for w in range(nw)) * window
    return b * heads * window * keys


def local(b: int, g) -> dict:
    """``local_window_attention`` at Stage-3 batch b beside SDPA with the
    boolean (L, L) band mask."""
    import torch
    import torch.nn.functional as F

    from biom3_tpu_torch.ops import kernels as K

    q, k, v = (torch.randn(b, LOCAL_H, L, LOCAL_DH, generator=g, device=g.device).bfloat16()
               for _ in range(3))
    win = torch.arange(L, device=g.device) // LOCAL_W
    band = (win[:, None] - win[None, :]).abs() <= 1
    flops = 4 * LOCAL_DH * band_pairs(b, L, LOCAL_W, LOCAL_H)
    return {"run": lambda: K.local_window_attention(q, k, v, window=LOCAL_W),
            "plain": lambda: K.local_window_attention_plain(q, k, v, window=LOCAL_W),
            "lib": lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=band),
            "flops": flops, "work_flops": flops, "bytes": nbytes(q, k, v, q), "group": 0}


def stage3(b: int, g) -> dict:
    """``stage3_attention_core`` at Stage-3 batch b (d = 512, 8 band and 8
    linear heads of 32, W = 128) beside SDPA with the boolean (L, L) band
    mask on the band heads alone."""
    import torch
    import torch.nn.functional as F

    from biom3_tpu_torch.ops import kernels as K

    d = STAGE3_HEADS * LOCAL_DH
    qkv = torch.randn(b, L, 3 * d, generator=g, device=g.device).bfloat16()
    band_heads = [t.view(b, L, STAGE3_HEADS, LOCAL_DH)[:, :, :LOCAL_H].transpose(1, 2)
                  for t in qkv.split(d, dim=-1)]
    win = torch.arange(L, device=g.device) // LOCAL_W
    band = (win[:, None] - win[None, :]).abs() <= 1
    lin_flops = 4 * b * (STAGE3_HEADS - LOCAL_H) * L * LOCAL_DH ** 2
    flops = 4 * LOCAL_DH * band_pairs(b, L, LOCAL_W, LOCAL_H) + lin_flops
    kw = dict(heads=STAGE3_HEADS, local_heads=LOCAL_H, window=LOCAL_W)
    return {"run": lambda: K.stage3_attention_core(qkv, **kw),
            "plain": lambda: K.stage3_attention_core_plain(qkv, **kw),
            "lib": lambda: F.scaled_dot_product_attention(*band_heads, attn_mask=band),
            "flops": flops, "work_flops": flops, "bytes": nbytes(qkv) + b * L * d * 2,
            "group": LOCAL_DH}


def stage3_i8(b: int, g) -> dict:
    """``stage3_attention_core_i8`` at Stage-3 batch b (the shapes of
    ``stage3``) beside ``stage3_attention_core`` (bf16) on the same qkv.
    Ops: 4·Dh a band pair at the int8 peak and the linear heads' 4·L·Dh²
    at bf16's, counted as int8-peak equivalents; bytes: qkv in, the head
    outputs out."""
    import torch

    from biom3_tpu_torch.ops import kernels as K

    d = STAGE3_HEADS * LOCAL_DH
    qkv = torch.randn(b, L, 3 * d, generator=g, device=g.device).bfloat16()
    lin_flops = 4 * b * (STAGE3_HEADS - LOCAL_H) * L * LOCAL_DH ** 2
    ops = 4 * LOCAL_DH * band_pairs(b, L, LOCAL_W, LOCAL_H) + lin_flops * PEAK_INT8 / PEAK_BF16
    kw = dict(heads=STAGE3_HEADS, local_heads=LOCAL_H, window=LOCAL_W)
    return {"run": lambda: K.stage3_attention_core_i8(qkv, **kw),
            "plain": lambda: K.stage3_attention_core_i8_plain(qkv, **kw),
            "lib": lambda: K.stage3_attention_core(qkv, **kw),
            "lib_name": "stage3_attention_core (bf16)", "peak": PEAK_INT8,
            "flops": ops, "work_flops": ops, "bytes": nbytes(qkv) + b * L * d * 2,
            "group": LOCAL_DH}


def stage3_bwd(b: int, g) -> dict:
    """``stage3_attention_bwd`` at Stage-3 batch b (the shapes of
    ``stage3``) beside SDPA's backward with the boolean (L, L) band mask on
    the band heads alone (autograd, the graph built once).  FLOPs: 10·Dh
    per band pair and 10·L·Dh² a linear head (the function's), 18·Dh per
    band pair (the band passes' design) as ``work_flops``; bytes: qkv and
    dattn read, dqkv written."""
    import torch
    import torch.nn.functional as F

    from biom3_tpu_torch.ops import kernels as K

    d = STAGE3_HEADS * LOCAL_DH
    qkv = torch.randn(b, L, 3 * d, generator=g, device=g.device).bfloat16()
    da = torch.randn(b, L, d, generator=g, device=g.device).bfloat16()
    band_heads = [t.view(b, L, STAGE3_HEADS, LOCAL_DH)[:, :, :LOCAL_H].transpose(1, 2)
                  .contiguous().requires_grad_() for t in qkv.split(d, dim=-1)]
    win = torch.arange(L, device=g.device) // LOCAL_W
    band = (win[:, None] - win[None, :]).abs() <= 1
    sdpa = F.scaled_dot_product_attention(*band_heads, attn_mask=band)
    dsdpa = da.view(b, L, STAGE3_HEADS, LOCAL_DH)[:, :, :LOCAL_H].transpose(1, 2)
    pairs = band_pairs(b, L, LOCAL_W, LOCAL_H)
    lin_flops = 10 * b * (STAGE3_HEADS - LOCAL_H) * L * LOCAL_DH ** 2
    kw = dict(heads=STAGE3_HEADS, local_heads=LOCAL_H, window=LOCAL_W)
    return {"run": lambda: K.stage3_attention_bwd(qkv, da, **kw),
            "plain": lambda: K.stage3_attention_bwd_plain(qkv, da, **kw),
            "lib": lambda: torch.autograd.grad(sdpa, band_heads, dsdpa, retain_graph=True),
            "flops": 10 * LOCAL_DH * pairs + lin_flops,
            "work_flops": 18 * LOCAL_DH * pairs + lin_flops,
            "bytes": 2 * nbytes(qkv) + nbytes(da), "group": LOCAL_DH}


def lin_chunk_sweep(g) -> dict:
    """``stage3_attention_bwd`` (8 band + 8 linear heads of 32, W=128,
    L=1024) at B=4 and 32 with the linear heads' backward on chunks of
    each of ``LIN_CHUNKS`` sequence rows: device ms per launch,
    ``ops/kernels.stage3_linear_bwd_plan``'s own rows first."""
    import torch

    from biom3_tpu_torch.ops import kernels as K

    plan, out = K.stage3_linear_bwd_plan, {}
    d = STAGE3_HEADS * LOCAL_DH
    kw = dict(heads=STAGE3_HEADS, local_heads=LOCAL_H, window=LOCAL_W)
    try:
        for b in LOCAL_BATCHES:
            qkv = torch.randn(b, L, 3 * d, generator=g, device=g.device).bfloat16()
            da = torch.randn(b, L, d, generator=g, device=g.device).bfloat16()
            want = K.stage3_attention_bwd_plain(qkv, da, **kw)
            own = plan(L, b * (STAGE3_HEADS - LOCAL_H), 132, K.lin_bwd_max_pairs())
            for chunk in (own,) + tuple(c for c in LIN_CHUNKS if c != own):
                K.stage3_linear_bwd_plan = lambda *_, c=chunk: c
                run = lambda: K.stage3_attention_bwd(qkv, da, **kw)  # noqa: E731
                err = rel_err(run(), want, LOCAL_DH)
                launches = launch_ms(run)
                out[f"B{b}_chunk{chunk}"] = {"device_ms": sum(launches.values()),
                                             "launch_ms": launches, "max_rel_err": err}
    finally:
        K.stage3_linear_bwd_plan = plan
    return out


def plan_sweep(g) -> dict:
    """``stage3_attention_core`` (8 band + 8 linear heads of 32, W=128,
    L=1024) at B=2, 4 and 32 under other linear-head splits than
    ``stage3_linear_plan``'s: device ms per launch for each (ctx chunks,
    statistics rows, output rows a block), the plan's own choice first."""
    import torch

    from biom3_tpu_torch.ops import kernels as K

    plan, out = K.stage3_linear_plan, {}
    d = STAGE3_HEADS * LOCAL_DH
    kw = dict(heads=STAGE3_HEADS, local_heads=LOCAL_H, window=LOCAL_W)
    try:
        for b in (2, 4, 32):
            qkv = torch.randn(b, L, 3 * d, generator=g, device=g.device).bfloat16()
            want = K.stage3_attention_core_plain(qkv, **kw)
            own = plan(L, b * (STAGE3_HEADS - LOCAL_H), 132)
            for chunks, srows, lrows in [own[:1] + own[2:]] + [
                    (c, s, r) for c in (1, 4, 16) for s in (64, 256) for r in (128, 512)]:
                K.stage3_linear_plan = (lambda *_, c=chunks, s=srows, r=lrows:
                                        (c, -(-L // c), s, r))
                run = lambda: K.stage3_attention_core(qkv, **kw)  # noqa: E731
                err = rel_err(run(), want, LOCAL_DH)
                launches = launch_ms(run)
                out[f"B{b}_chunks{chunks}_srows{srows}_lrows{lrows}"] = {
                    "device_ms": sum(launches.values()), "launch_ms": launches,
                    "max_rel_err": err}
    finally:
        K.stage3_linear_plan = plan
    return out


def graph_forward(iters: int) -> dict:
    """The ``stage3_graph`` path: ``ProteoScribe(attn_impl="kernel")`` in
    bf16 at full width (seeded weights), ms per forward at each batch of
    ``GRAPH_BATCHES`` by CUDA events, and a device profile by kernel."""
    import torch

    from biom3_tpu_torch.cli.measure_pencl import event_ms, profile_ms
    from biom3_tpu_torch.config import ProteoScribeConfig
    from biom3_tpu_torch.io.state_dict import seeded_init_
    from biom3_tpu_torch.models.proteoscribe import ProteoScribe

    dev = torch.device("cuda")
    cfg = ProteoScribeConfig()
    graph = ProteoScribe(cfg, attn_impl="kernel", dtype=torch.bfloat16)
    graph.load_state_dict(seeded_init_(ProteoScribe(cfg), 0).state_dict())
    graph = graph.to(dev).eval()
    g = torch.Generator(device=dev).manual_seed(1)
    out = {}
    for b in GRAPH_BATCHES:
        ids = torch.randint(0, cfg.num_classes, (b, cfg.max_seq_len), generator=g, device=dev)
        t = torch.randint(0, cfg.num_timesteps, (b,), generator=g, device=dev)
        z = torch.randn((b, cfg.cond_dim), generator=g, device=dev)

        @torch.no_grad()
        def forward(ids=ids, t=t, z=z):
            return graph(ids, t, z)

        out[f"B{b}"] = {"ms": event_ms(forward, iters), "profile": profile_ms(forward)}
    return out


def launch_ms(fn, calls: int = 10) -> dict[str, float]:
    """Device ms per call of ``fn`` by kernel launch (``torch.profiler``,
    device events only)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: dict[str, float] = {}
    for ev in prof.key_averages():
        if ev.device_type == DeviceType.CPU or ev.self_device_time_total <= 0:
            continue
        name = next((short for frag, short in LAUNCHES if frag in ev.key), ev.key[:60])
        out[name] = out.get(name, 0.0) + ev.self_device_time_total / calls / 1e3
    return out


def measure(case: dict, iters: int) -> dict:
    from biom3_tpu_torch.cli.measure_gemm import host_us
    from biom3_tpu_torch.cli.measure_pencl import event_ms

    err = rel_err(case["run"](), case["plain"](), case["group"])
    if err > REL_TOL:
        raise AssertionError(f"max|Δ|/max|ref| = {err:.3e} > {REL_TOL}")
    ms = event_ms(case["run"], iters)
    library_ms = event_ms(case["lib"], iters)
    bound_ms = max(case["flops"] / case.get("peak", PEAK_BF16),
                   case["bytes"] / PEAK_BYTES) * 1e3
    launches = launch_ms(case["run"])
    device_ms = sum(launches.values())
    return {"max_rel_err": err, "ms": ms, "library_ms": library_ms,
            "library": case.get("lib_name", "PyTorch"), "bound_ms": bound_ms,
            "tflops": case["flops"] / ms * 1e-9, "work_tflops": case["work_flops"] / ms * 1e-9,
            "bound_share": bound_ms / ms, "over_library": ms / library_ms,
            "launch_ms": launches, "device_ms": device_ms,
            "bound_share_device": bound_ms / device_ms, "host_us": host_us(case["run"])}


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--plan-sweep", action="store_true",
                   help="also time stage3_attention_core under other linear-head splits")
    p.add_argument("--lin-chunk-sweep", action="store_true",
                   help="also time stage3_attention_bwd with other linear-head block rows")
    p.add_argument("--only", nargs="*", default=None,
                   help="measure only the cases (and stage3_graph_forward) whose names start "
                        "with one of these")
    return p.parse_args(argv)


def main(argv=None) -> None:
    import torch

    from biom3_tpu_torch.ops import _build
    from biom3_tpu_torch.ops import kernels as K

    args = parse_arguments(argv)
    if not torch.cuda.is_available():
        raise SystemExit("measure_attention needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    _build.library()
    result = {"card": smi, "package": str(pathlib.Path(K.__file__).resolve().parents[1]),
              "torch": torch.__version__}
    g = torch.Generator(device="cuda").manual_seed(0)
    wanted = lambda name: args.only is None or name.startswith(tuple(args.only))  # noqa: E731
    for name, case in cases(g).items():
        if not wanted(name):
            continue
        result[name] = measure(case, args.iters)
        print(f"{name}: {json.dumps(result[name])}", flush=True)
    if args.plan_sweep:
        result["stage3_plan_sweep"] = plan_sweep(g)
        print(f"stage3_plan_sweep: {json.dumps(result['stage3_plan_sweep'])}", flush=True)
    if args.lin_chunk_sweep:
        result["stage3_bwd_lin_chunk_sweep"] = lin_chunk_sweep(g)
        print(f"stage3_bwd_lin_chunk_sweep: {json.dumps(result['stage3_bwd_lin_chunk_sweep'])}",
              flush=True)
    if wanted("stage3_graph_forward"):
        result["stage3_graph_forward"] = graph_forward(5)
        print(f"stage3_graph_forward: {json.dumps(result['stage3_graph_forward'])}", flush=True)
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        pathlib.Path(args.out).write_text(text + "\n")


if __name__ == "__main__":
    sys.exit(main())

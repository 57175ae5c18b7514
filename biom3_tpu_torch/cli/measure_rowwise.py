"""The row-wise kernels on one CUDA card: ``layernorm``, ``bias_layernorm``,
``embed_tokens``, ``gather_head``, ``esm2_embed``, ``layernorm_bwd``,
``col_sum`` and ``quant_rows``.

    python -m biom3_tpu_torch.cli.measure_rowwise [--iters 50] [--out build/measure_rowwise.json]
        [--only PREFIX ...] [--bits-out FILE | --bits-against FILE]

``layernorm`` at ``chip_smoke.py`` phase 3's five LayerNorm calls (Stage-3
FF pre-norm at B=4, 4096 x 512, f32 in, bf16 out, eps 1e-6; BERT's
post-norm at B=2, 1024 x 768, f32 in, bf16 and f32 out, eps 1e-12;
ESM2-650M at B=2, 2048 x 1280: LN1 on the bf16 residual, LN2 on the f32
one, and the final norm on 2 CLS rows with its f32 copy, eps 1e-5) and at
the sizes where the card is busy: Stage-3 B=32 (32768 x 512, f32 in, bf16
out) and ESM2 B=16 (16384 x 1280, bf16); and past the 1280 columns the
kernel holds in registers, on its shared-memory route: ESM2-3B's LN1 at
B=16 (16384 x 2560, bf16) and a Stage-3 dim of 4096 at B=32 (32768 x 4096,
f32 in, bf16 out).

The training backward's reductions with the callers' dtypes
(``ops/layer_block.py``, ``ops/esm2_block.py``): a Stage-3 layer's three
``col_sum`` (dyc bf16 x 512, dh1 bf16 x 2048, dxa f32 x 512) and two
``layernorm_bwd`` (LN2: f32 x, bf16 residual, f32 dx with its bf16 copy;
LN1: bf16 x, f32 residual, bf16 dx) at B=4 (4096 rows, phase 3's shape)
and B=32 (32768 rows); an ESM2-650M layer's at B=4 (4096 rows: ``col_sum``
over 1280, 3840 and 5120 bf16 columns; ``layernorm_bwd`` at 1280, bf16 x
and residual into a bf16 dx); and ESM2-3B's width at B=16 (16384 rows:
``layernorm_bwd`` at 2560, ``col_sum`` over the 10240 FF columns).

``bias_layernorm`` (the Stage-3 layer's prologue: h (B, 1024, d) bf16 plus
its batch row's bias, LayerNorm, xb f32 and xn bf16 out) at d 512 at B=4
and B=32, at d 1280 (B=16, the widest row held in registers), a ragged
1288 (B=3, L=997) and d 4096 (B=32, staged in shared memory); no library
call writes both outputs, so the plain version's device ms stands beside
the kernel's.

``embed_tokens`` and ``gather_head`` (the Stage-3 stack's first and last
steps: tok[ids] + pos at d 512, and LayerNorm with the (512, 29) head at 1
or 8 gathered positions a batch row, and at every position, k = L = 1024,
the full grid that confidence order and MaskGIT rank) at B=4, phase 3's
shape, and B=32; ``esm2_embed`` (the ESM2 tower's layer-0 embed with the
token-dropout rescale, E 1280) at ESM2 B=2 (lengths 1024 and 400, a PAD
tail) and B=16 (L 1024, no PAD); no library call, the plain version's
device ms beside the kernel's.

``quant_rows`` with the callers' widths and dtypes: a Stage-3 layer's four
quants (the LN1 output and the head outputs, 512 bf16; the LN2 output, 512
f32; the FF activation, 2048 f32) at B=4 (4096 rows, phase 3's shape) and
B=32 (32768 rows), and an ESM2-650M layer's (1280 bf16 twice, 1280 f32,
5120 f32) at B=16 (16384 rows).  No library call computes it: the plain
version's device ms stands beside the kernel's.

Each call is held against its plain version (max|Δ|/max|ref| <= 2e-2),
then timed: ms per call by CUDA events, device ms per call from
``torch.profiler`` (every kernel it launches), the wrapper's host µs per
call (the enqueue), and the same for one library call on the same rows:
``F.layer_norm`` (γ and β in the input's dtype; it writes the input's
dtype: f32 where the kernel writes bf16); ``x.float().sum(0)``; the
LayerNorm backward through autograd (``F.layer_norm`` in x's dtype, the
output gradient in it too, no residual).  Reported beside them: the
least time the card could take (``bound_ms``: each input read once and
each output written once at 3.35 TB/s, or the FLOPs at 989 TFLOP/s if
larger) and its share of the kernel's device time, and the library
call's own bound.  Prints one JSON object with the card's name and power
limit and writes it to ``--out``.  A call that a version of the kernels
refuses (``layernorm_bwd`` past 1280 columns before they took such rows)
is reported as refused.

``--bits-out FILE`` saves a SHA-256 of every output's bytes for the same
seeded inputs, as JSON, and of one ``gemm_dw`` with split-K slabs
(Stage-3 B=32, 32768 x 512 x 512: its slabs are summed by ``col_sum``'s
kernel); ``--bits-against FILE`` reports which outputs differ from that
file's.  Two versions in one call (the same card): run this file from
another checkout's root with that checkout first on the path, e.g. ``cd
parent && PYTHONPATH=. python ../biom3_tpu_torch/cli/measure_rowwise.py
--bits-out b.json``, then this checkout's with ``--bits-against b.json``.
Exits non-zero without a card.
"""

from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys

from biom3_tpu_torch.utils.flops import PEAK_BF16, PEAK_BYTES  # H100 SXM data sheet

REL_TOL = 2e-2
SEED = 0


def cases(g) -> dict[str, dict]:
    """Name → {"run", "plain", "lib", "flops", "bytes"} on ``g``'s device."""
    import torch
    import torch.nn.functional as F

    from biom3_tpu_torch.ops import kernels as K

    dev, bf, f32 = g.device, torch.bfloat16, torch.float32

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def vec(n, base=0.0):
        return (base + 0.1 * torch.randn(n, generator=g, device=dev)).float()

    def ln(rows, d, x_dtype, eps, want_f32=False):
        x, s, t = rnd(rows, d, dtype=x_dtype, scale=3.0), vec(d, 1.0), vec(d)
        ws, bs = s.to(x_dtype), t.to(x_dtype)
        kw = dict(eps=eps, out_dtype=bf, want_f32=want_f32)
        x_bytes = x.numel() * x.element_size()
        return {"run": lambda: K.layernorm(x, s, t, **kw),
                "plain": lambda: K.layernorm_plain(x, s, t, **kw),
                "lib": lambda: F.layer_norm(x, (d,), ws, bs, eps),
                "flops": 8 * rows * d,
                "bytes": x_bytes + 8 * d + rows * d * (2 + 4 * want_f32),
                "lib_bytes": 2 * x_bytes + 2 * d * x.element_size()}

    def col_sum(rows, n, dtype):
        x = rnd(rows, n, dtype=dtype)
        x_bytes = x.numel() * x.element_size()
        return {"run": lambda: K.col_sum(x), "plain": lambda: K.col_sum_plain(x),
                "lib": lambda: x.float().sum(0), "flops": rows * n, "bytes": x_bytes + 4 * n,
                "lib_bytes": x_bytes + 4 * n}

    def ln_bwd(rows, d, x_dtype, res_dtype, out_dtype, eps, want_cd=False):
        """The library call: autograd's LayerNorm backward from a graph built
        once, in x's dtype (dy too), no residual."""
        x, dy, s = rnd(rows, d, dtype=x_dtype, scale=3.0), rnd(rows, d, dtype=f32), vec(d, 1.0)
        res = rnd(rows, d, dtype=res_dtype)
        kw = dict(residual=res, eps=eps, out_dtype=out_dtype, want_cd=want_cd)
        xl = x.detach().requires_grad_()
        wl, bl = s.to(x_dtype).requires_grad_(), torch.zeros_like(s, dtype=x_dtype).requires_grad_()
        y, gy = F.layer_norm(xl, (d,), wl, bl, eps), dy.to(x_dtype)
        size = x.element_size()
        out = rows * d * (torch.finfo(out_dtype).bits // 8 + 2 * want_cd) + 8 * d
        return {"run": lambda: K.layernorm_bwd(x, dy, s, **kw),
                "plain": lambda: K.layernorm_bwd_plain(x, dy, s, **kw),
                "lib": lambda: torch.autograd.grad(y, (xl, wl, bl), gy, retain_graph=True),
                "flops": 12 * rows * d,
                "bytes": rows * d * (size + 4 + res.element_size()) + 4 * d + out,
                "lib_bytes": 3 * rows * d * size + 8 * rows + 6 * d * size}

    def layer(rows, d, ff):
        """A Stage-3 layer's backward reductions (ops/layer_block.py)."""
        return [col_sum(rows, d, bf), col_sum(rows, ff, bf), col_sum(rows, d, f32),
                ln_bwd(rows, d, f32, bf, f32, 1e-6, want_cd=True),
                ln_bwd(rows, d, bf, f32, bf, 1e-6)]

    def quant(rows, d, dtype):
        """No library call computes the per-row dynamic int8; the plain
        version's device time is reported beside the kernel's."""
        x = rnd(rows, d, dtype=dtype, scale=3.0)
        return {"run": lambda: K.quant_rows(x), "plain": lambda: K.quant_rows_plain(x),
                "lib": None, "flops": 3 * rows * d,
                "bytes": x.numel() * x.element_size() + rows * d + 4 * rows}

    def quants(rows, d, ff):
        """A layer's four activation quants (Stage 3, ESM2): the LN1 output
        and the head outputs in bf16, the LN2 output and the FF activation
        in f32 (ops/stage3_layer.py, ops/esm2_stack.py)."""
        return {"ln1_bf16": quant(rows, d, bf), "attn_bf16": quant(rows, d, bf),
                "ln2_f32": quant(rows, d, f32), "ff_f32": quant(rows, ff, f32)}

    def bias_ln(b, d, L=1024):
        """The Stage-3 layer's prologue: h (b, L, d) bf16 plus its batch
        row's bias, LayerNorm (eps 1e-6) → xb f32 and xn bf16.  No library
        call writes both outputs: the plain version's device ms stands
        beside the kernel's."""
        h, bias, s, t = rnd(b, L, d, scale=3.0), rnd(b, d), vec(d, 1.0), vec(d)
        rows = b * L
        return {"run": lambda: K.bias_layernorm(h, bias, s, t),
                "plain": lambda: K.bias_layernorm_plain(h, bias, s, t), "lib": None,
                "flops": 9 * rows * d, "bytes": rows * d * (2 + 4 + 2) + b * d * 2 + 8 * d}

    def embed(b, d=512, L=1024, vocab=29):
        """The Stage-3 stack's layer-0 embed: tok[ids] + pos."""
        ids = torch.randint(0, vocab, (b, L), generator=g, device=dev, dtype=torch.int32)
        tok, pos = rnd(vocab, d), rnd(L, d)
        return {"run": lambda: K.embed_tokens(ids, tok, pos),
                "plain": lambda: K.embed_tokens_plain(ids, tok, pos), "lib": None,
                "flops": b * L * d, "bytes": ids.numel() * 4 + (vocab + L) * d * 2 + b * L * d * 2}

    def head(b, k, d=512, L=1024, classes=29):
        """The Stage-3 stack's epilogue: LayerNorm and the (d, 29) head at k
        gathered positions a batch row (k = L: every position, in order).
        The head is packed as the stack packs it (``pad_head``, where the
        kernels have it)."""
        h, s, t = rnd(b, L, d, scale=3.0), vec(d, 1.0), vec(d)
        if k == L:
            pos = torch.arange(L, device=dev, dtype=torch.int32).expand(b, L).contiguous()
        else:
            pos = torch.randint(0, L, (b, k), generator=g, device=dev, dtype=torch.int32)
        w, hb = rnd(d, classes, scale=d ** -0.5), vec(classes)
        w = K.pad_head(w) if hasattr(K, "pad_head") else w
        return {"run": lambda: K.gather_head(h, pos, s, t, w, hb),
                "plain": lambda: K.gather_head_plain(h, pos, s, t, w, hb), "lib": None,
                "flops": 2 * b * k * d * classes + 8 * b * k * d,
                "bytes": b * k * (d * 2 + 4 + classes * 4) + 8 * d + d * classes * 2 + classes * 4}

    def esm_embed(lengths, L=1024, E=1280):
        """The ESM2 tower's layer-0 embed: <cls>, residues, <eos>, a PAD tail
        to L, one <mask> in row 0; table (33, E)."""
        ids = torch.ones((len(lengths), L), dtype=torch.int32, device=dev)
        for r, n in enumerate(lengths):
            ids[r, 1:n - 1] = torch.randint(4, 24, (n - 2,), generator=g, device=dev,
                                            dtype=torch.int32)
            ids[r, 0], ids[r, n - 1] = 0, 2
        ids[0, 5] = 32
        table = rnd(33, E)
        rows = ids.numel()
        return {"run": lambda: K.esm2_embed(ids, table), "lib": None,
                "plain": lambda: K.esm2_embed_plain(ids, table, pad_idx=1, mask_idx=32,
                                                    token_dropout=True),
                "flops": 3 * rows * E, "bytes": rows * 4 + 33 * E * 2 + rows * E * 2}

    names = ["col_sum_dyc", "col_sum_dh1", "col_sum_dxa", "ln2_bwd", "ln1_bwd"]
    b4, b32 = layer(4 * 1024, 512, 2048), layer(32 * 1024, 512, 2048)
    return {
        **{f"stage3_b4_{n}": c for n, c in zip(names, b4)},
        **{f"stage3_b32_{n}": c for n, c in zip(names, b32)},
        "esm2_b4_col_sum_dyc": col_sum(4 * 1024, 1280, bf),
        "esm2_b4_col_sum_dqkv": col_sum(4 * 1024, 3840, bf),
        "esm2_b4_col_sum_dh1": col_sum(4 * 1024, 5120, bf),
        "esm2_b4_ln_bwd": ln_bwd(4 * 1024, 1280, bf, bf, bf, 1e-5),
        "esm2_3b_b16_ln_bwd": ln_bwd(16 * 1024, 2560, bf, bf, bf, 1e-5),
        "esm2_3b_b16_col_sum_dh1": col_sum(16 * 1024, 10240, bf),
        "stage3_b4_ff_prenorm": ln(4 * 1024, 512, f32, 1e-6),
        "bert_b2_postnorm": ln(2 * 512, 768, f32, 1e-12, want_f32=True),
        "esm2_b2_ln1": ln(2 * 1024, 1280, bf, 1e-5),
        "esm2_b2_ln2": ln(2 * 1024, 1280, f32, 1e-5),
        "esm2_cls_norm": ln(2, 1280, bf, 1e-5, want_f32=True),
        "stage3_b32_ff_prenorm": ln(32 * 1024, 512, f32, 1e-6),
        "esm2_b16_ln1": ln(16 * 1024, 1280, bf, 1e-5),
        "esm2_3b_b16_ln1": ln(16 * 1024, 2560, bf, 1e-5),
        "stage3_d4096_b32_ff_prenorm": ln(32 * 1024, 4096, f32, 1e-6),
        "stage3_b4_embed_tokens": embed(4),
        "stage3_b32_embed_tokens": embed(32),
        "stage3_b4_gather_head_k1": head(4, 1),
        "stage3_b4_gather_head_k8": head(4, 8),
        "stage3_b32_gather_head_k8": head(32, 8),
        "stage3_b4_gather_head_kL": head(4, 1024),
        "stage3_b32_gather_head_kL": head(32, 1024),
        "esm2_b2_embed": esm_embed([1024, 400]),
        "esm2_b16_embed": esm_embed([1024] * 16),
        "stage3_b4_bias_ln": bias_ln(4, 512),
        "stage3_b32_bias_ln": bias_ln(32, 512),
        "d1280_b16_bias_ln": bias_ln(16, 1280),
        "d1288_b3_bias_ln": bias_ln(3, 1288, L=997),
        "d4096_b32_bias_ln": bias_ln(32, 4096),
        **{f"stage3_b4_quant_{n}": c for n, c in quants(4 * 1024, 512, 2048).items()},
        **{f"stage3_b32_quant_{n}": c for n, c in quants(32 * 1024, 512, 2048).items()},
        **{f"esm2_b16_quant_{n}": c for n, c in quants(16 * 1024, 1280, 5120).items()},
    }


def device_ms(fn, calls: int = 10, tries: int = 3) -> float:
    """Device ms per call of ``fn``: its device events' time
    (``torch.profiler``), summed over the kernels it launches; profiled
    again (up to ``tries`` times) when a trace holds no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        total = sum(ev.self_device_time_total for ev in prof.key_averages()
                    if ev.device_type != DeviceType.CPU)
        if total > 0:
            return total / calls / 1e3
    raise RuntimeError("the profiler recorded no device time")


def flat(x) -> list:
    return [t for item in x for t in flat(item)] if isinstance(x, tuple) else [x]


def measure(case: dict, iters: int) -> dict:
    from biom3_tpu_torch.cli.measure_gemm import host_us
    from biom3_tpu_torch.cli.measure_pencl import event_ms

    got, want = flat(case["run"]()), flat(case["plain"]())
    err = max(float((a.float() - b.float()).abs().max() / b.float().abs().max())
              for a, b in zip(got, want))
    if not all(bool(a.isfinite().all()) for a in got) or err > REL_TOL:
        raise AssertionError(f"max|Δ|/max|ref| = {err:.3e} > {REL_TOL}, or non-finite")
    ms, dev_ms = event_ms(case["run"], iters), device_ms(case["run"])
    t_ops, t_bytes = case["flops"] / PEAK_BF16 * 1e3, case["bytes"] / PEAK_BYTES * 1e3
    bound_ms = max(t_ops, t_bytes)
    out = {"max_rel_err": err, "ms": ms, "device_ms": dev_ms, "host_us": host_us(case["run"]),
           "bound_ms": bound_ms, "bound_by": "operations" if t_ops >= t_bytes else "bytes",
           "bound_share_device": bound_ms / dev_ms, "bytes": case["bytes"]}
    if case["lib"] is None:
        out["plain_device_ms"] = device_ms(case["plain"])
        return out
    lib_ms, lib_dev_ms = event_ms(case["lib"], iters), device_ms(case["lib"])
    lib_bound_ms = max(t_ops, case["lib_bytes"] / PEAK_BYTES * 1e3)
    return {**out, "library_ms": lib_ms, "library_device_ms": lib_dev_ms,
            "library_host_us": host_us(case["lib"]), "library_bound_ms": lib_bound_ms,
            "library_bound_share_device": lib_bound_ms / lib_dev_ms}


def digest(t) -> str:
    """SHA-256 of a tensor's dtype, shape and bytes."""
    import hashlib

    import torch

    data = t.detach().cpu().contiguous().view(-1).view(torch.uint8).numpy().tobytes()
    return hashlib.sha256(f"{t.dtype} {tuple(t.shape)} ".encode() + data).hexdigest()


def outputs(g) -> dict[str, list[str]]:
    """Every case's outputs' digests, and a split-K ``gemm_dw``'s, for a
    bits comparison; a refused call's error instead."""
    import torch

    from biom3_tpu_torch.ops import kernels as K

    x, dy = (torch.randn(32 * 1024, 512, generator=g, device=g.device).to(torch.bfloat16)
             for _ in range(2))
    runs = {name: case["run"] for name, case in cases(g).items()}
    runs["stage3_b32_gemm_dw_split_k"] = lambda: K.gemm_dw(x, dy)
    got = {}
    for name, run in runs.items():
        try:
            got[name] = [digest(t) for t in flat(run())]
        except ValueError as e:
            got[name] = [f"refused: {e}"]
    return got


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--out", type=str, default=None)
    p.add_argument("--only", nargs="*", default=None,
                   help="time only the cases whose names start with one of these")
    bits = p.add_mutually_exclusive_group()
    bits.add_argument("--bits-out", type=str, default=None,
                      help="save digests of the seeded cases' outputs here (JSON)")
    bits.add_argument("--bits-against", type=str, default=None,
                      help="report which outputs differ from this file's")
    return p.parse_args(argv)


def main(argv=None) -> None:
    import torch

    from biom3_tpu_torch.ops import _build
    from biom3_tpu_torch.ops import kernels as K

    args = parse_arguments(argv)
    if not torch.cuda.is_available():
        raise SystemExit("measure_rowwise needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    _build.library()
    result = {"card": smi, "package": str(pathlib.Path(K.__file__).resolve().parents[1]),
              "torch": torch.__version__}
    g = torch.Generator(device="cuda").manual_seed(SEED)
    for name, case in cases(g).items():
        if args.only is not None and not name.startswith(tuple(args.only)):
            continue
        try:
            result[name] = measure(case, args.iters)
        except ValueError as e:   # a kernel that refuses the shape
            result[name] = {"refused": str(e)}
        print(f"{name}: {json.dumps(result[name])}", flush=True)
    if args.bits_out or args.bits_against:
        got = outputs(torch.Generator(device="cuda").manual_seed(SEED + 1))
        if args.bits_out:
            pathlib.Path(args.bits_out).write_text(json.dumps(got))
        else:
            ref = json.loads(pathlib.Path(args.bits_against).read_text())
            result["bits_differ"] = sorted(name for name in ref if got.get(name) != ref[name])
            print(f"bits against {args.bits_against}: {len(ref)} outputs, differ: "
                  f"{result['bits_differ']}", flush=True)
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        pathlib.Path(args.out).write_text(text + "\n")


if __name__ == "__main__":
    sys.exit(main())

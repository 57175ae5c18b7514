"""The GEMM kernels on one CUDA card: ``gemm_bias_act``, ``gemm_i8``, ``gemm_dx``, ``gemm_dw``.

    python -m biom3_tpu_torch.cli.measure_gemm [--batches 4 32] [--dw-sweep] [--dx-sweep] \
        [--out build/measure_gemm.json]

For each Stage-3 batch B (M = B·1024 rows, d = 512, FF 2048): one layer's
four forward products, as the stack runs them (q/k/v 512→1536 bf16 out;
out-projection 512→512 with an f32 residual, f32 out; W1 512→2048 with
tanh GELU; W2 2048→512 with an f32 residual), in bf16 through
``gemm_bias_act`` and in int8 through ``gemm_i8``.  Each product is held
against its plain version (max|Δ|/max|ref| <= 2e-2), then the four are
timed together by CUDA events beside one PyTorch call each (``matmul``;
``torch._int_mm``, the int32 product only), with the least time the card
could take (operations at 989 TFLOP/s bf16 or 1979 TOP/s int8, bytes at
3.35 TB/s), the rate in TFLOP/s or TOP/s and each product's own time.
The input gradient ``gemm_dx`` the same way beside ``matmul(dy, w.t())``,
at each Stage-3 batch (one layer's four dX: dattn = dy·Woᵀ, dh1 =
(dy·W2ᵀ)∘gelu'(h1), du = dh1·W1ᵀ and dxn1 = dqkv·W3ᵀ, the last two f32
out) and at one ESM2-650M layer's four over ``ESM_DX_ROWS`` (2048 rows:
``chip_smoke.py`` phase 3's ESM2 batch; 4096: ``gemm_dw``'s).  The weight gradient ``gemm_dw`` (f32 out, the
rows summed) the same way
beside ``matmul`` on the transposed view, at each Stage-3 batch (one
layer's four dW: W2, W1, Wo, W3) and at one ESM2-650M layer's four over
4096 rows (Stage-1 training at B=4: W2, W1, Wo, W3).  ``--dw-sweep``
times each of those dW products alone on both of its tiles at 1 to 16
splits of the rows, beside the split rule's choice (``gemm_dw_plan``):
the evidence for that rule.  ``--dx-sweep`` likewise times each
``gemm_dx`` product alone on both tiles beside ``gemm_dx_plan``'s choice.
Also the host cost of one wrapper call
(enqueue only, no synchronise) of each GEMM and of ``layernorm``, a
kernel that takes no tensor maps, and the SASS counts of the tensor-core
and TMA instructions in each kernel of the built library (``cuobjdump
-sass``).  Prints one JSON object and writes it to ``--out``.

Two versions in one call (the same card): run this file from another
checkout's root with that checkout first on the path, e.g.
``cd parent && PYTHONPATH=. python ../biom3_tpu_torch/cli/measure_gemm.py``;
it then builds and times that checkout's kernels.  Exits non-zero without
a card.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import pathlib
import re
import shutil
import subprocess
import sys
import time

from biom3_tpu_torch.utils.flops import PEAK_BF16, PEAK_INT8, PEAK_BYTES  # H100 SXM data sheet

REL_TOL = 2e-2
ITERS = 20
L, D, FF = 1024, 512, 2048
SASS_OPS = ("HGMMA", "IGMMA", "UTMALDG", "HMMA", "IMMA")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors if t is not None)


def stage3_gemm_cases(B: int, g) -> dict[str, list[dict]]:
    """``{"gemm_bias_act": [...], "gemm_i8": [...]}``: one Stage-3 layer's
    four forward products at batch B on ``g``'s device, each case
    ``{"run", "plain", "flops", "bytes", "lib", "peak"}`` (bytes: every
    input read once, every output written once)."""
    import torch

    from biom3_tpu_torch.ops import kernels as K
    from biom3_tpu_torch.ops.quant import quantize_weight_int8

    dev, bf, f32 = g.device, torch.bfloat16, torch.float32
    M = B * L

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def vec(n):
        return 0.1 * torch.randn(n, generator=g, device=dev)

    def case(name, *args, flops, out, lib, peak, **kw):
        tensors = [t for t in (*args, *kw.values()) if isinstance(t, torch.Tensor)]
        return {"run": lambda: getattr(K, name)(*args, **kw),
                "plain": lambda: getattr(K, name + "_plain")(*args, **kw),
                "flops": flops, "bytes": nbytes(*tensors) + out, "lib": lib, "peak": peak}

    def gemm(a, w, bias=None, out_dtype=bf, **kw):
        m, k, n = a.shape[0], a.shape[1], w.shape[1]
        return case("gemm_bias_act", a, w, bias, out_dtype=out_dtype, **kw, flops=2 * m * k * n,
                    out=m * n * (torch.finfo(out_dtype).bits // 8), peak=PEAK_BF16,
                    lib=lambda: torch.matmul(a, w))

    def gemm8(k, n, bias=True, out_dtype=bf, **kw):
        a8, sa = K.quant_rows_plain(rnd(M, k))
        w8, sw = quantize_weight_int8(rnd(k, n, dtype=f32, scale=k ** -0.5))
        w8 = w8.t().contiguous()
        return case("gemm_i8", a8, sa, w8, sw, vec(n) if bias else None, out_dtype=out_dtype,
                    **kw, flops=2 * M * k * n, out=M * n * (torch.finfo(out_dtype).bits // 8),
                    peak=PEAK_INT8, lib=lambda: torch._int_mm(a8, w8.t()))

    x, xf, mid = rnd(M, D), rnd(M, D, dtype=f32), rnd(M, FF)
    return {
        "gemm_bias_act": [
            gemm(x, rnd(D, 3 * D, scale=D ** -0.5)),
            gemm(x, rnd(D, D, scale=D ** -0.5), vec(D), residual=xf, out_dtype=f32),
            gemm(x, rnd(D, FF, scale=D ** -0.5), vec(FF), act="tanh"),
            gemm(mid, rnd(FF, D, scale=FF ** -0.5), vec(D), residual=xf),
        ],
        "gemm_i8": [
            gemm8(D, 3 * D, bias=False),
            gemm8(D, D, residual=xf, out_dtype=f32),
            gemm8(D, FF, act="tanh", out_dtype=f32),
            gemm8(FF, D, residual=xf),
        ],
    }


ESM_ROWS, ESM_E, ESM_FF = 4096, 1280, 5120
ESM_DX_ROWS = (2048, 4096)


def dx_cases(rows: int, d: int, ff: int, g) -> list[dict]:
    """One layer's four input gradients over ``rows`` rows at width ``d``
    and FF width ``ff`` (Stage 3: 512, 2048; ESM2-650M: 1280, 5120), each
    case as ``stage3_gemm_cases``' (the library call ``matmul(dy,
    w.t())``, the GELU derivative left out)."""
    import torch

    from biom3_tpu_torch.ops import kernels as K

    dev, bf, f32 = g.device, torch.bfloat16, torch.float32

    def rnd(*shape, dtype=bf, scale=1.0):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def dx(dy, w, out_dtype=bf, **kw):
        k, n = dy.shape[1], w.shape[0]
        tensors = [t for t in (dy, w, *kw.values()) if isinstance(t, torch.Tensor)]
        return {"run": lambda: K.gemm_dx(dy, w, out_dtype=out_dtype, **kw),
                "plain": lambda: K.gemm_dx_plain(dy, w, out_dtype=out_dtype, **kw),
                "args": (dy, w, kw.get("gelu_of"), out_dtype),
                "flops": 2 * rows * k * n,
                "bytes": nbytes(*tensors) + rows * n * (torch.finfo(out_dtype).bits // 8),
                "lib": lambda: torch.matmul(dy, w.t()), "peak": PEAK_BF16}

    dy, dh = rnd(rows, d), rnd(rows, ff)
    return [dx(dy, rnd(d, d, scale=d ** -0.5)),
            dx(dy, rnd(ff, d, scale=ff ** -0.5), gelu_of=rnd(rows, ff, dtype=f32)),
            dx(dh, rnd(d, ff, scale=d ** -0.5), out_dtype=f32),
            dx(rnd(rows, 3 * d), rnd(d, 3 * d, scale=d ** -0.5), out_dtype=f32)]


def dw_cases(B: int | None, g) -> list[dict]:
    """One layer's four weight gradients: Stage 3 at batch B (B·1024 rows),
    or with ``B=None`` one ESM2-650M layer's over ``ESM_ROWS`` rows, each
    case as ``stage3_gemm_cases``' (the library call ``matmul`` on xᵀ)."""
    import torch

    from biom3_tpu_torch.ops import kernels as K

    dev, bf = g.device, torch.bfloat16
    rows, d, ff = (B * L, D, FF) if B else (ESM_ROWS, ESM_E, ESM_FF)

    def rnd(*shape):
        return torch.randn(shape, generator=g, device=dev).to(bf)

    def dw(x, dy):
        k, n = x.shape[1], dy.shape[1]
        return {"run": lambda: K.gemm_dw(x, dy), "plain": lambda: K.gemm_dw_plain(x, dy),
                "args": (x, dy),
                "flops": 2 * rows * k * n, "bytes": nbytes(x, dy) + k * n * 4,
                "lib": lambda: torch.matmul(x.t(), dy), "peak": PEAK_BF16}

    h1, dy, u = rnd(rows, ff), rnd(rows, d), rnd(rows, d)
    return [dw(h1, dy), dw(u, rnd(rows, ff)), dw(u, dy), dw(u, rnd(rows, 3 * d))]


DW_SPLITS = (1, 2, 3, 4, 6, 8, 12, 16)


def dw_sweep(batches, g) -> dict[str, dict]:
    """``"rows:KxN"`` → {"plan": [tile rows, splits, rows a split],
    "ms": {"<tile>x<splits>": ms}} for each distinct dW product of
    ``dw_cases`` at the Stage-3 batches and the ESM2 layer, each
    configuration checked against the plain version first."""
    import torch

    from biom3_tpu_torch.cli.measure_pencl import event_ms
    from biom3_tpu_torch.ops import _build
    from biom3_tpu_torch.ops import kernels as K

    def launch(x, dy, bm, splits):
        rows, k = x.shape
        n = dy.shape[1]
        ktiles = -(-rows // 64)
        per = -(-ktiles // splits)
        splits = -(-ktiles // per)
        out = torch.empty((k, n), dtype=torch.float32, device=x.device)
        ws = (torch.empty((splits, k, n), dtype=torch.float32, device=x.device)
              if splits > 1 else None)
        _build.launch("b3_gemm_dw", x.data_ptr(), dy.data_ptr(), out.data_ptr(),
                      None if ws is None else ws.data_ptr(), k, n, rows, per * 64,
                      int(bm == 128), torch.cuda.current_stream().cuda_stream)
        return out

    result = {}
    for B in [*batches, None]:
        for case in dw_cases(B, g):
            x, dy = case["args"]
            key = f"{x.shape[0]}:{x.shape[1]}x{dy.shape[1]}"
            if key in result:
                continue
            want = case["plain"]()
            times = {}
            for bm in (64, 128):
                for splits in DW_SPLITS:
                    got = launch(x, dy, bm, splits)
                    err = float((got - want).abs().max() / want.abs().max())
                    if err > REL_TOL:
                        raise AssertionError(f"{key} {bm}x{splits}: max|Δ|/max|ref| {err:.3e}")
                    times[f"{bm}x{splits}"] = event_ms(lambda: launch(x, dy, bm, splits), ITERS)
            result[key] = {"plan": list(K.gemm_dw_plan(x.shape[0], x.shape[1], dy.shape[1])),
                           "ms": times}
            print(f"dw_sweep {key}: {json.dumps(result[key])}", flush=True)
        torch.cuda.empty_cache()
    return result


def dx_sweep(batches, g) -> dict[str, dict]:
    """``"rows:KxN"`` → {"plan": tile rows, "ms": {"64": ms, "128": ms}}
    for each ``gemm_dx`` product of ``dx_cases`` at the Stage-3 batches and
    over ``ESM_DX_ROWS``, each tile checked against the plain version
    first."""
    import torch

    from biom3_tpu_torch.cli.measure_pencl import event_ms
    from biom3_tpu_torch.ops import _build
    from biom3_tpu_torch.ops import kernels as K

    def launch(dy, w, h, out_dtype, bm):
        rows, k = dy.shape
        n = w.shape[0]
        out = torch.empty((rows, n), dtype=out_dtype, device=dy.device)
        _build.launch("b3_gemm_dx", dy.data_ptr(), w.data_ptr(),
                      None if h is None else h.data_ptr(), out.data_ptr(), rows, n, k,
                      3 if h is not None else 0, int(out_dtype == torch.float32), int(bm == 128),
                      torch.cuda.current_stream().cuda_stream)
        return out

    shapes = [(B * L, D, FF) for B in batches] + [(r, ESM_E, ESM_FF) for r in ESM_DX_ROWS]
    result = {}
    for rows, d, ff in shapes:
        for case in dx_cases(rows, d, ff, g):
            dy, w, h, out_dtype = case["args"]
            key = f"{rows}:{dy.shape[1]}x{w.shape[0]}"
            want = case["plain"]().float()
            times = {}
            for bm in (64, 128):
                got = launch(dy, w, h, out_dtype, bm).float()
                err = float((got - want).abs().max() / want.abs().max())
                if err > REL_TOL:
                    raise AssertionError(f"{key} {bm}: max|Δ|/max|ref| {err:.3e}")
                times[str(bm)] = event_ms(lambda: launch(dy, w, h, out_dtype, bm), ITERS)
            result[key] = {"plan": K.gemm_dx_plan(rows, w.shape[0]), "ms": times}
            print(f"dx_sweep {key}: {json.dumps(result[key])}", flush=True)
        torch.cuda.empty_cache()
    return result


def check(cases) -> tuple[float, float]:
    """Worst (max|Δ|, max|Δ|/max|ref|) of the cases' kernels against their
    plain versions; raises over ``REL_TOL``."""
    import torch

    worst = (0.0, 0.0)
    for c in cases:
        got, want = c["run"]().float(), c["plain"]().float()
        torch.cuda.synchronize()
        if not bool(got.isfinite().all()):
            raise AssertionError("kernel output has non-finite values")
        diff = float((got - want).abs().max())
        worst = max(worst[0], diff), max(worst[1], diff / max(float(want.abs().max()), 1e-30))
    if worst[1] > REL_TOL:
        raise AssertionError(f"max|Δ|/max|ref| = {worst[1]:.3e} > {REL_TOL}")
    return worst


def host_us(fn, n: int = 200) -> float:
    """Host µs per call of ``fn`` (the enqueue: checks, allocation, tensor
    maps, launch), the device drained before and after."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / n * 1e6


def host_costs(g) -> dict[str, float]:
    """Host µs of one wrapper call of each GEMM at the Stage-3 B=4 q/k/v
    product and of ``layernorm`` (no tensor maps) on its input rows."""
    import torch

    from biom3_tpu_torch.ops import kernels as K

    cases = stage3_gemm_cases(4, g)
    x = torch.randn(4 * L, D, generator=g, device=g.device)
    ones, zeros = torch.ones(D, device=g.device), torch.zeros(D, device=g.device)
    return {"gemm_bias_act": host_us(cases["gemm_bias_act"][0]["run"]),
            "gemm_i8": host_us(cases["gemm_i8"][0]["run"]),
            "layernorm": host_us(lambda: K.layernorm(x, ones, zeros, eps=1e-6,
                                                     out_dtype=torch.bfloat16))}


def timing(cases) -> dict:
    """ms of the cases' kernels and library calls, the bound and the rate."""
    from biom3_tpu_torch.cli.measure_pencl import event_ms

    ms = event_ms(lambda: [c["run"]() for c in cases], ITERS)
    library_ms = event_ms(lambda: [c["lib"]() for c in cases], ITERS)
    t_ops = sum(c["flops"] / c["peak"] for c in cases) * 1e3
    t_bytes = sum(c["bytes"] for c in cases) / PEAK_BYTES * 1e3
    bound = sum(max(c["flops"] / c["peak"], c["bytes"] / PEAK_BYTES) for c in cases) * 1e3
    flops = sum(c["flops"] for c in cases)
    return {"ms": ms, "per_product_ms": [event_ms(c["run"], ITERS) for c in cases],
            "library_ms": library_ms, "bound_ms": bound,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "rate_t_per_s": flops / ms / 1e9, "library_rate_t_per_s": flops / library_ms / 1e9}


def sass_counts(lib_path) -> dict[str, dict[str, int]]:
    """Kernel (demangled where ``cu++filt`` exists) → counts of ``SASS_OPS``
    in its SASS, for the kernels that have any."""
    from biom3_tpu_torch.ops import _build

    bindir = pathlib.Path(_build.nvcc_path()).parent
    sass = subprocess.run([str(bindir / "cuobjdump"), "-sass", str(lib_path)],
                          capture_output=True, text=True, check=True).stdout
    pattern = re.compile(r"\b(" + "|".join(SASS_OPS) + r")\b")
    counts: dict[str, collections.Counter] = {}
    name = None
    for line in sass.splitlines():
        if "Function :" in line:
            name = line.split("Function :", 1)[1].strip()
            counts[name] = collections.Counter()
        elif name is not None:
            counts[name].update(pattern.findall(line))
    names = [n for n, c in counts.items() if c]
    filt = bindir / "cu++filt"
    if not filt.is_file():
        filt = shutil.which("c++filt")
    shown = names
    if filt and names:
        shown = subprocess.run([str(filt)], input="\n".join(names), capture_output=True,
                               text=True, check=True).stdout.splitlines()
    return {s: {op: counts[n][op] for op in SASS_OPS} for n, s in zip(names, shown)}


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batches", type=int, nargs="+", default=[4, 32])
    p.add_argument("--dw-sweep", action="store_true",
                   help="also time gemm_dw's tiles at 1-16 splits (the split rule's evidence)")
    p.add_argument("--dx-sweep", action="store_true",
                   help="also time gemm_dx's two tiles (the tile rule's evidence)")
    p.add_argument("--out", type=str, default=None)
    return p.parse_args(argv)


def main(argv=None) -> None:
    import torch

    from biom3_tpu_torch.ops import _build
    from biom3_tpu_torch.ops import kernels as K

    args = parse_arguments(argv)
    if not torch.cuda.is_available():
        raise SystemExit("measure_gemm needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip()
    _build.library()
    result = {"card": smi, "package": str(pathlib.Path(K.__file__).resolve().parents[1]),
              "torch": torch.__version__}
    g = torch.Generator(device="cuda").manual_seed(0)
    for B in [*args.batches, None]:
        if B:
            named = {**{f"{n}_B{B}": c for n, c in stage3_gemm_cases(B, g).items()},
                     f"gemm_dx_B{B}": dx_cases(B * L, D, FF, g), f"gemm_dw_B{B}": dw_cases(B, g)}
        else:
            named = {**{f"gemm_dx_esm2_{rows}": dx_cases(rows, ESM_E, ESM_FF, g)
                        for rows in ESM_DX_ROWS}, "gemm_dw_esm2": dw_cases(None, g)}
        for key, cases in named.items():
            err_abs, err_rel = check(cases)
            result[key] = {"max_abs_err": err_abs, "max_rel_err": err_rel, **timing(cases)}
            print(f"{key}: {json.dumps(result[key])}", flush=True)
        del named, cases
        torch.cuda.empty_cache()
    if args.dw_sweep:
        result["dw_sweep"] = dw_sweep(args.batches, g)
    if args.dx_sweep:
        result["dx_sweep"] = dx_sweep(args.batches, g)
    result["host_us_per_call"] = host_costs(g)
    print(f"host: {json.dumps(result['host_us_per_call'])}", flush=True)
    try:
        result["sass"] = sass_counts(_build.LIB_PATH)
    except (OSError, subprocess.CalledProcessError, RuntimeError) as e:
        result["sass"] = {"error": repr(e)}
    text = json.dumps(result)
    print(text)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        pathlib.Path(args.out).write_text(text + "\n")


if __name__ == "__main__":
    sys.exit(main())

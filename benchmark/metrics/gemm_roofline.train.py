"""The GEMM kernels' share of their roofline in a training run: a layer's
four bf16 products forward (``gemm_bias_act``), their dX (``gemm_dx``) and dW
(``gemm_dw``, f32 out) on rows × L rows (``harness.roofline.stage3_layer_gemms``)
per step traced, against 989 TFLOP/s, over the device time of those kernels
(``gemm_dw``'s split-K slabs are summed by ``col_sum``, a row kernel outside
this family)."""

from harness import roofline

KERNELS = ("gemm_bias_act_wgmma", "gemm_dx_wgmma", "gemm_dw_wgmma", "gemm_i8_wgmma")


def read(ctx):
    steps = ctx.work.get("steps", 0)
    if ctx.trace is None or not steps:
        return None
    d = ctx.work["dims"]
    one = roofline.stage3_layer_gemms(ctx.work["rows"] * d["L"], d["d"], d["ff"], int8=False,
                                      backward=True)
    n = steps * d["depth"]
    return roofline.share(roofline.Work(one.ops * n, one.bound_s * n),
                          ctx.trace.family_s(KERNELS))

"""The GEMM kernels' share of their roofline in a design sweep: a layer's
four int8 products (q/k/v fused, out, w1, w2) on rows × L rows, int8 against
1979 TOP/s (``harness.roofline.stage3_layer_gemms``), over the device time of
the GEMM kernels."""

from harness import roofline

KERNELS = ("gemm_i8_wgmma", "gemm_bias_act_wgmma")


def work(ctx) -> roofline.Work:
    d = ctx.work["dims"]
    one = roofline.stage3_layer_gemms(ctx.work["rows"] * d["L"], d["d"], d["ff"], int8=True,
                                      backward=False)
    n = ctx.work["forwards"] * d["depth"]
    return roofline.Work(one.ops * n, one.bound_s * n)


def read(ctx):
    if ctx.trace is None or not ctx.work.get("forwards"):
        return None
    return roofline.share(work(ctx), ctx.trace.family_s(KERNELS))

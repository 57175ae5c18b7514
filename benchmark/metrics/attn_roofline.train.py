"""The Stage-3 attention kernels' share of their roofline in a training run:
``stage3_attention_core`` forward and ``stage3_attention_bwd`` (band heads at
3W keys a query, linear heads at 4·L·dh² a row; the backward twice the
forward's products, ``harness.roofline.stage3_attention``) per layer and step
traced, over the device time of their kernels."""

from harness import roofline

KERNELS = ("stage3_local_wgmma", "stage3_linear_stats", "stage3_linear_ctx",
           "stage3_bwd_dq_wgmma", "stage3_bwd_dkv_wgmma", "lin_bwd1", "lin_bwd2", "lin_bwd3")


def read(ctx):
    steps = ctx.work.get("steps", 0)
    if ctx.trace is None or not steps:
        return None
    d = ctx.work["dims"]
    one = roofline.stage3_attention(ctx.work["rows"], d["L"], d["d"], d["heads"], d["local"],
                                    d["W"], backward=True)
    n = steps * d["depth"]
    return roofline.share(roofline.Work(one.ops * n, one.bound_s * n),
                          ctx.trace.family_s(KERNELS))

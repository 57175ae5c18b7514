"""``stage3_attention_core``'s share of its roofline in a design sweep: the
bound of the traced forwards' attention (``harness.roofline.stage3_attention``:
band heads at 3W keys a query, linear heads at 4·L·dh² a row, q/k/v read and
the output written once, bf16) over the device time of its kernels."""

from harness import roofline

KERNELS = ("stage3_local_wgmma", "stage3_linear_stats", "stage3_linear_ctx")


def work(ctx) -> roofline.Work:
    d = ctx.work["dims"]
    one = roofline.stage3_attention(ctx.work["rows"], d["L"], d["d"], d["heads"], d["local"],
                                    d["W"], backward=False)
    n = ctx.work["forwards"] * d["depth"]
    return roofline.Work(one.ops * n, one.bound_s * n)


def read(ctx):
    if ctx.trace is None or not ctx.work.get("forwards"):
        return None
    return roofline.share(work(ctx), ctx.trace.family_s(KERNELS))

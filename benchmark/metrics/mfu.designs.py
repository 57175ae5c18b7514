"""The design sweep's matrix FLOPs over the bf16 peak for the traced window,
in %: every layer's products and attention on all L positions, the condition
MLP, and the head at the gathered positions, per forward traced."""

from harness import roofline


def flops_per_forward(w: dict) -> float:
    d = w["dims"]
    rows = w["rows"]
    layer = (roofline.stage3_layer_gemms(rows * d["L"], d["d"], d["ff"], int8=True,
                                         backward=False).ops
             + roofline.stage3_attention(rows, d["L"], d["d"], d["heads"], d["local"], d["W"],
                                         backward=False).ops)
    head = 2.0 * rows * w["gathered"] * d["d"] * d["C"]
    return d["depth"] * layer + head + roofline.stage3_cond_flops(rows, d["d"], d["depth"],
                                                                  d["cond"])


def read(ctx):
    if ctx.trace is None or ctx.trace.busy_s <= 0.0 or not ctx.work.get("forwards"):
        return None
    return roofline.mfu(ctx.work["forwards"] * flops_per_forward(ctx.work), ctx.trace.window_s)

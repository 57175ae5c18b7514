"""A training run's matrix FLOPs over the bf16 peak for the traced window, in
%: per step, every layer's products forward, dX and dW, the attention forward
and backward, the head on all rows × L positions and the condition MLP, each
three times a forward (forward, dX, dW)."""

from harness import roofline


def read(ctx):
    steps = ctx.work.get("steps", 0)
    if ctx.trace is None or ctx.trace.busy_s <= 0.0 or not steps:
        return None
    d, rows = ctx.work["dims"], ctx.work["rows"]
    layer = (roofline.stage3_layer_gemms(rows * d["L"], d["d"], d["ff"], int8=False,
                                         backward=True).ops
             + roofline.stage3_attention(rows, d["L"], d["d"], d["heads"], d["local"], d["W"],
                                         backward=True).ops)
    rest = 3.0 * (2.0 * rows * d["L"] * d["d"] * d["C"]
                  + roofline.stage3_cond_flops(rows, d["d"], d["depth"], d["cond"]))
    return roofline.mfu(steps * (d["depth"] * layer + rest), ctx.trace.window_s)

"""The bulk embedding's matrix FLOPs over the bf16 peak for the traced
window, in %: both towers' products and attention as the inputs need them
(ESM2 on each protein's real tokens, BERT on the caption's 512 positions, the
last layers on the rows their output needs), and both projection heads."""

from harness import roofline


def read(ctx):
    slabs = ctx.work.get("slabs")
    if ctx.trace is None or ctx.trace.busy_s <= 0.0 or not slabs:
        return None
    s = ctx.work["s1"]
    flops = 0.0
    for slab in slabs:
        pairs = len(slab["plen"])
        for n in slab["plen"]:
            n = int(n) + 2
            flops += (roofline.encoder_gemms(n, s["E"], 4 * s["E"], s["esm_layers"],
                                             int8=True).ops
                      + roofline.encoder_attention(n, s["E"], s["esm_layers"]).ops)
        L, P = slab["x_t"].shape[1], s["proj"]
        bert = (roofline.encoder_gemms(L, s["T"], s["bert_ff"], s["bert_layers"], int8=True).ops
                + roofline.encoder_attention(L, s["T"], s["bert_layers"]).ops)
        heads = 2.0 * (s["E"] * P + s["T"] * P + 2 * P * P)
        flops += pairs * (bert + heads)
    return roofline.mfu(flops, ctx.trace.window_s)

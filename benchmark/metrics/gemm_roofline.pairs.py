"""The GEMM kernels' share of their roofline in a bulk embedding: each
tower's int8 products (``harness.roofline.encoder_gemms``: ESM2 on the
protein's real tokens, BERT on the caption's 512 positions; the last layer's
q, out and FF on the first row only), int8 against 1979 TOP/s, over the
device time of the GEMM kernels."""

from harness import roofline

KERNELS = ("gemm_i8_wgmma", "gemm_bias_act_wgmma")


def tower_gemms(ctx) -> roofline.Work:
    s = ctx.work["s1"]
    w = roofline.Work()
    for slab in ctx.work["slabs"]:
        for n in slab["plen"]:
            w += roofline.encoder_gemms(int(n) + 2, s["E"], 4 * s["E"], s["esm_layers"],
                                        int8=True)
        bert = roofline.encoder_gemms(slab["x_t"].shape[1], s["T"], s["bert_ff"],
                                      s["bert_layers"], int8=True)
        w += roofline.Work(bert.ops * len(slab["plen"]), bert.bound_s * len(slab["plen"]))
    return w


def read(ctx):
    if ctx.trace is None or not ctx.work.get("slabs"):
        return None
    return roofline.share(tower_gemms(ctx), ctx.trace.family_s(KERNELS))

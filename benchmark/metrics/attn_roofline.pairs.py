"""The towers' attention kernels' share of their roofline in a bulk
embedding: ``esm2_attention`` over each protein's real tokens and
``dense_attention`` over the caption's 512 positions (BERT runs without an
attention mask, so every position is work the [CLS] row needs), both as
``harness.roofline.encoder_attention`` counts them, over the device time of
the two kernels' launches."""

from harness import roofline

KERNELS = ("esm2_attn_stage", "esm2_attn_wgmma", "dense_attn_wgmma")


def work(ctx) -> roofline.Work:
    s = ctx.work["s1"]
    w = roofline.Work()
    for slab in ctx.work["slabs"]:
        for n in slab["plen"]:
            w += roofline.encoder_attention(int(n) + 2, s["E"], s["esm_layers"])
        bert = roofline.encoder_attention(slab["x_t"].shape[1], s["T"], s["bert_layers"])
        w += roofline.Work(bert.ops * len(slab["plen"]), bert.bound_s * len(slab["plen"]))
    return w


def read(ctx):
    if ctx.trace is None or not ctx.work.get("slabs"):
        return None
    return roofline.share(work(ctx), ctx.trace.family_s(KERNELS))

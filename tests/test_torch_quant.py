"""The port's int8 serving recipe against the JAX package (CPU, f32).

* ``ops/quant.py`` — ``quantize_weight_int8``, ``quant_rows``,
  ``quant_cols`` — bit-equal to ``biom3_tpu/ops/pallas/quant.py`` on seeded
  inputs with zero rows and exact half-step ties;
* ``gemm_i8``'s plain version equal to a numpy int64 product;
* the Stage-3 stack, the BERT tower and the ESM2 tower in int8 (the port's
  kernel chains on their plain versions) against the TPU kernels in
  interpret mode, each side quantizing the same f32 weights with its own
  ``quantize_weight_int8``.  Tolerance: max|Δ| / max|ref| ≤ 2e-3 — f32 on
  both sides, so the only difference expected is an int8 code flipped at a
  rounding boundary by a different summation order upstream.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from biom3_tpu.config import BertConfig, ESM2Config, PenCLConfig, ProteoScribeConfig
from biom3_tpu.models.esm2 import ESM2 as JaxESM2
from biom3_tpu.models.pencl import PenCL
from biom3_tpu.ops.pallas import quant as jax_quant
from biom3_tpu.ops.pallas.bert_stack_tpu import (
    bert_embed as jax_bert_embed,
    bert_stack_arrays as jax_bert_stack_arrays,
    fused_bert_cls as jax_fused_bert_cls,
)
from biom3_tpu.ops.pallas.esm2_stack_tpu import (
    esm2_stack_arrays as jax_esm2_stack_arrays,
    fused_esm2_cls as jax_fused_esm2_cls,
)
from biom3_tpu_torch.io.from_jax import esm2_from_jax, pencl_text_from_jax, port_config
from biom3_tpu_torch.models.fused_forward import make_stack_apply
from biom3_tpu_torch.ops import kernels
from biom3_tpu_torch.ops import quant
from biom3_tpu_torch.ops.bert_stack import bert_embed, bert_stack_arrays, fused_bert_cls
from biom3_tpu_torch.ops.esm2_stack import esm2_stack_arrays, fused_esm2_cls

REL_TOL = 2e-3


def _rel(got, want) -> float:
    return float(np.abs(np.asarray(got) - np.asarray(want)).max() / np.abs(want).max())


def _perturb(tree, seed):
    """Flax inits biases/norms to 0/1; perturb so every parameter matters."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32), tree)


def _activations(rng, rows=16, d=64):
    """Seeded rows with a zero row and rows of exact half-step ties (amax
    127, so the multiplier is 1 and x.5 values land on the tie)."""
    z = rng.standard_normal((rows, d)).astype(np.float32) * 3
    z[1] = 0.0
    z[2, :] = np.arange(d) % 9 - 4.5
    z[2, 0] = 127.0
    z[3, :] = -(np.arange(d) % 7) - 0.5
    z[3, 1] = -127.0
    return z


def test_quantize_weight_int8_bit_equal_jax():
    rng = np.random.default_rng(0)
    w = rng.standard_normal((3, 64, 48)).astype(np.float32)
    w[1, :, 5] = 0.0                                       # a zero column
    w[2, :, 7] = np.arange(64) % 11 - 5.5                  # ties at scale 1
    w[2, 0, 7] = 127.0
    q_jax, s_jax = jax_quant.quantize_weight_int8(jnp.asarray(w))
    q, s = quant.quantize_weight_int8(torch.from_numpy(w))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    np.testing.assert_array_equal(q.numpy(), np.asarray(q_jax))
    np.testing.assert_array_equal(s.numpy(), np.asarray(s_jax))
    # per output channel: quantizing q, k and v apart equals the fused (d, 3d)
    parts = [quant.quantize_weight_int8(torch.from_numpy(w[:, :, i:i + 16])) for i in (0, 16, 32)]
    np.testing.assert_array_equal(torch.cat([p[0] for p in parts], 2).numpy(), q.numpy())
    np.testing.assert_array_equal(torch.cat([p[1] for p in parts], 1).numpy(), s.numpy())


@pytest.mark.parametrize("dtype,rows,d", [
    pytest.param("float32", 16, 64, id="float32"),
    pytest.param("bfloat16", 16, 64, id="bfloat16"),
    # the callers' widths and dtypes (a Stage-3 layer's bf16 LN1 output and
    # f32 FF activation, an ESM2-650M layer's bf16 and f32 FF rows), 13
    # rows: off the kernel's 8-row blocks
    pytest.param("bfloat16", 13, 512, id="bfloat16-13x512"),
    pytest.param("float32", 13, 2048, id="float32-13x2048"),
    pytest.param("bfloat16", 13, 1280, id="bfloat16-13x1280"),
    pytest.param("float32", 13, 5120, id="float32-13x5120"),
])
def test_quant_rows_and_cols_bit_equal_jax(dtype, rows, d):
    z = _activations(np.random.default_rng(1), rows, d)
    zj = jnp.asarray(z).astype(dtype)
    zt = torch.from_numpy(z).to(getattr(torch, dtype))
    for name in ("quant_rows", "quant_cols"):
        want_q, want_a = getattr(jax_quant, name)(zj)
        got_q, got_a = getattr(quant, name)(zt)
        np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q), err_msg=name)
        np.testing.assert_array_equal(got_a.numpy(), np.asarray(want_a), err_msg=name)
    # the kernel wrapper's CPU path: the same codes, scales as a vector
    q, a = kernels.quant_rows(torch.from_numpy(z))
    want_q, want_a = jax_quant.quant_rows(jnp.asarray(z))
    np.testing.assert_array_equal(q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(a.numpy(), np.asarray(want_a)[:, 0])
    assert (q[1] == 0).all() and float(a[1]) == np.float32(1e-6) * np.float32(1 / 127)


def test_gemm_i8_plain_is_the_exact_int_product():
    """At K = 5120 the int32 sums pass 2^24: an f32 product would round
    them, the plain version must not."""
    rng = np.random.default_rng(2)
    M, K, N = 8, 5120, 24
    a = rng.integers(-127, 128, (M, K)).astype(np.int8)
    a[0] = 127
    w = rng.integers(-127, 128, (N, K)).astype(np.int8)
    w[0] = 127
    sa = rng.random(M).astype(np.float32) + 0.5
    sw = rng.random(N).astype(np.float32) + 0.5
    acc = a.astype(np.int64) @ w.astype(np.int64).T
    assert acc[0, 0] == 127 * 127 * K > 2 ** 24
    want = acc.astype(np.float32) * sa[:, None] * sw[None, :]
    got = kernels.gemm_i8(torch.from_numpy(a), torch.from_numpy(sa), torch.from_numpy(w),
                    torch.from_numpy(sw), out_dtype=torch.float32).numpy()
    np.testing.assert_array_equal(got, want)
    bias = rng.standard_normal(N).astype(np.float32)
    res = rng.standard_normal((M, N)).astype(np.float32)
    got = kernels.gemm_i8(torch.from_numpy(a), torch.from_numpy(sa), torch.from_numpy(w),
                    torch.from_numpy(sw), torch.from_numpy(bias), act="tanh",
                    residual=torch.from_numpy(res), out_dtype=torch.float32).numpy()
    want = np.asarray(jax.nn.gelu(jnp.asarray(want + bias), approximate=True)) + res
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-3)


# --- the stacks in int8 against the TPU kernels in interpret mode ----------

def _stack_arrays(rng, depth=2, L=64, d=64, ff=256, V=29, C=29):
    """The TPU kernel's inputs, f32: tables, stacked (depth, d_in, d_out)
    matrices, vectors, ids, positions and the per-layer bias."""
    p = lambda *s, sc=1.0: (sc * rng.standard_normal(s)).astype(np.float32)  # noqa: E731
    mats = dict(wq=p(depth, d, d, sc=d ** -0.5), wk=p(depth, d, d, sc=d ** -0.5),
                wv=p(depth, d, d, sc=d ** -0.5), wo=p(depth, d, d, sc=d ** -0.5),
                w1=p(depth, d, ff, sc=d ** -0.5), w2=p(depth, ff, d, sc=ff ** -0.5))
    rest = dict(tok_table=p(V, d), pos_emb=p(L, d, sc=0.1), ln1_scale=1 + p(depth, d, sc=0.05),
                ln1_bias=p(depth, d, sc=0.05), bo=p(depth, d, sc=0.05),
                ln2_scale=1 + p(depth, d, sc=0.05), ln2_bias=p(depth, d, sc=0.05),
                b1=p(depth, ff, sc=0.05), b2=p(depth, d, sc=0.05), fn_scale=1 + p(d, sc=0.05),
                fn_bias=p(d, sc=0.05), head_w=p(d, C, sc=d ** -0.5), head_b=p(C, sc=0.05))
    B, k = 2, 4
    io = dict(ids=rng.integers(0, V, (B, L)).astype(np.int32),
              pos=np.stack([rng.permutation(L)[:k] for _ in range(B)]).astype(np.int32),
              bias=p(B, depth, d, sc=0.5))
    return mats, rest, io


@pytest.mark.parametrize("ff_quant,proj_quant",
                         [("int8", "none"), ("none", "int8"), ("int8", "int8")])
def test_stack_int8_matches_jax_kernel(ff_quant, proj_quant):
    """The port's ``fused_stack_logits`` on int8 weights against the TPU
    kernel's, each quantizing the same f32 matrices with its own
    ``quantize_weight_int8`` (the port keeps int8 codes (d_out, d_in))."""
    from biom3_tpu.ops.pallas.stack_kernel_tpu import fused_stack_logits as jax_stack

    from biom3_tpu_torch.ops.stack import fused_stack_logits

    mats, rest, io = _stack_arrays(np.random.default_rng(3))
    order = ("tok_table", "pos_emb", "ln1_scale", "ln1_bias", "wq", "wk", "wv", "wo", "bo",
             "ln2_scale", "ln2_bias", "w1", "b1", "w2", "b2", "fn_scale", "fn_bias", "head_w",
             "head_b")
    scale_of = {"w1": "s1", "w2": "s2", "wq": "sq", "wk": "sk", "wv": "sv", "wo": "so"}
    mode = {n: ff_quant if n in ("w1", "w2") else proj_quant for n in mats}
    jax_in, port_in = dict(rest), {n: torch.from_numpy(a) for n, a in rest.items()}
    for n, a in mats.items():
        if mode[n] == "int8":
            jax_in[n], jax_in[scale_of[n]] = jax_quant.quantize_weight_int8(jnp.asarray(a))
            q, s = quant.quantize_weight_int8(torch.from_numpy(a))
            port_in[n], port_in[scale_of[n]] = q.transpose(1, 2).contiguous(), s
        else:
            jax_in[n], port_in[n] = a, torch.from_numpy(a)
    scales = [n for n in ("s1", "s2", "sq", "sk", "sv", "so") if n in jax_in]
    kw = dict(local_heads=2, heads=4, window=16)
    want = np.asarray(jax_stack(*(jnp.asarray(io[n]) for n in ("ids", "pos", "bias")),
                                *(jnp.asarray(jax_in[n]) for n in order),
                                **{n: jax_in[n] for n in scales}, **kw, interpret=True,
                                stream="ld", softmax_opt=False, ln_onepass=False,
                                ff_quant=ff_quant, proj_quant=proj_quant))
    got = fused_stack_logits(*(torch.from_numpy(io[n]) for n in ("ids", "pos", "bias")),
                             *(port_in[n] for n in order), **{n: port_in[n] for n in scales},
                             **kw).numpy()
    assert got.shape == want.shape == (2, 4, 29)
    assert _rel(got, want) <= REL_TOL


def test_make_stack_apply_int8_packs_like_jax():
    """The engine's packing: int8 logits of a seeded ProteoScribe close to
    its f32 logits (the drift the int8 modes are gated on), and equal to
    ``fused_stack_logits`` on ``quantize_weight_int8`` of its matrices."""
    cfg = port_config(ProteoScribeConfig(num_classes=29, dim=64, depth=2, n_blocks=1, heads=4,
                                         local_heads=2, local_window=16, max_seq_len=64,
                                         num_timesteps=64, cond_dim=32))
    from biom3_tpu_torch.io.state_dict import seeded_init_
    from biom3_tpu_torch.models.proteoscribe import ProteoScribe

    model = seeded_init_(ProteoScribe(cfg), seed=3).eval()
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.integers(0, 29, (2, 64)))
    t = torch.from_numpy(rng.integers(0, 64, (2,)))
    z = torch.from_numpy(rng.standard_normal((2, 32)).astype(np.float32))
    pos = torch.from_numpy(np.stack([rng.permutation(64)[:4] for _ in range(2)]))
    f32 = make_stack_apply(model, dtype=torch.float32)(x, t, z, pos)
    i8 = make_stack_apply(model, dtype=torch.float32, ff_quant="int8", proj_quant="int8")(
        x, t, z, pos)
    cos = torch.nn.functional.cosine_similarity(i8, f32, dim=-1)
    assert float(cos.min()) > 0.999
    assert not torch.equal(i8, f32)


@pytest.mark.parametrize("ff_quant,proj_quant",
                         [("int8", "none"), ("none", "int8"), ("int8", "int8")])
def test_bert_int8_matches_jax_kernel(ff_quant, proj_quant):
    """One post-LN layer, the same x0 on both sides, so every int8 code is
    computed from the same activations.  Deeper, the next layer quantizes
    the raw residual, which the two packages round apart by ~1e-7: at this
    width one code flipped there moves the CLS by up to ~1e-2 (2 layers,
    ids seeded 4).  The stacked-layer indexing is held by the Stage-3 and
    ESM2 cases (2 layers each)."""
    cfg = BertConfig(num_layers=1, hidden_size=128, num_heads=2, intermediate_size=256,
                     vocab_size=120, max_position_embeddings=64)
    pcfg = PenCLConfig(esm=ESM2Config(num_layers=1, embed_dim=32, attention_heads=2), bert=cfg,
                       protein_embedding=32, text_embedding=cfg.hidden_size, proj_dim=32)
    params = PenCL(pcfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                              jnp.zeros((1, 8), jnp.int32), method=PenCL.init_all_params)
    params = _perturb(params, 4)
    port = pencl_text_from_jax(params, port_config(pcfg))
    bert_p = params["params"]["text_encoder"]
    ids = np.random.default_rng(4).integers(0, cfg.vocab_size, (2, 64)).astype(np.int32)
    q = dict(ff_quant=ff_quant, proj_quant=proj_quant)
    x0 = jax_bert_embed(bert_p, jnp.asarray(ids), dtype=jnp.float32)
    want = np.asarray(jax_fused_bert_cls(
        x0, **jax_bert_stack_arrays(bert_p, cfg.num_layers, jnp.float32, **q),
        heads=cfg.num_heads, rows=1, ff_block_l=32, gelu="erf", interpret=True, **q))
    with torch.no_grad():
        x0_t = bert_embed(port.bert, torch.from_numpy(ids), dtype=torch.float32)
        np.testing.assert_allclose(x0_t.numpy(), np.asarray(x0), atol=1e-5)
        got = fused_bert_cls(torch.from_numpy(np.array(x0)),
                             **bert_stack_arrays(port.bert, torch.float32, **q),
                             heads=cfg.num_heads, gelu="erf").numpy()
    assert _rel(got, want) <= REL_TOL


def test_esm2_int8_matches_jax_kernel():
    cfg = ESM2Config(num_layers=2, embed_dim=128, attention_heads=2, vocab_size=33)
    params = JaxESM2(cfg).init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                               compute_logits=True)
    params = _perturb(params, 5)
    port = esm2_from_jax(params, port_config(cfg))
    rng = np.random.default_rng(5)
    toks = np.concatenate([np.zeros((2, 1), np.int32),
                           rng.integers(4, 24, (2, 120)).astype(np.int32),
                           np.full((2, 1), 2, np.int32), np.full((2, 6), 1, np.int32)], axis=1)
    toks[0, 5] = 32
    q = dict(ff_quant="int8", proj_quant="int8")
    want = np.asarray(jax_fused_esm2_cls(
        jnp.asarray(toks), **jax_esm2_stack_arrays(params["params"], cfg.num_layers,
                                                   dtype=jnp.float32, **q),
        heads=cfg.attention_heads, ff_block_l=64, gelu="erf", interpret=True, **q))
    with torch.no_grad():
        got = fused_esm2_cls(torch.from_numpy(toks), **esm2_stack_arrays(port, torch.float32, **q),
                             heads=cfg.attention_heads, gelu="erf").numpy()
    assert got.shape == (2, cfg.embed_dim)
    assert _rel(got, want) <= REL_TOL


def test_int8_engines_resolve_auto_by_device(tmp_path):
    """``None`` (auto) is int8 on cuda on the stack path and none on cpu;
    the graph tower path refuses int8.  (Engines are built on the CPU here;
    what auto resolves to on cuda is read off the same rule.)"""
    from biom3_tpu_torch.config import Config
    from biom3_tpu_torch.pipeline.stage1 import PenCLEngine
    from biom3_tpu_torch.pipeline.stage3 import ProteoScribeEngine
    from biom3_tpu_torch.tokenizers import write_synthetic_wordpiece

    s3 = Config({"diffusion_steps": 32, "num_classes": 29, "text_emb_dim": 8,
                 "transformer_dim": 32, "transformer_heads": 2, "transformer_depth": 1,
                 "transformer_blocks": 1, "transformer_local_heads": 1,
                 "transformer_local_size": 16})
    eng = ProteoScribeEngine(s3, device="cpu")
    assert (eng.ff_quant, eng.proj_quant) == ("none", "none")
    eng = ProteoScribeEngine(s3, device="cpu", use_stack=True, ff_quant="int8",
                             proj_quant="int8")
    assert eng._apply_fn is not None and (eng.ff_quant, eng.proj_quant) == ("int8", "int8")
    vocab = write_synthetic_wordpiece(tmp_path / "tok")
    s1 = Config({"protein_encoder_embedding": 16, "text_encoder_embedding": 32,
                 "esm_num_layers": 1, "esm_attention_heads": 2, "bert_num_layers": 1,
                 "bert_num_heads": 2, "bert_intermediate_size": 64, "bert_vocab_size": vocab,
                 "bert_max_position_embeddings": 32, "proj_embedding_dim": 16,
                 "text_max_length": 32, "text_model_path": str(tmp_path / "tok")})
    eng = PenCLEngine(s1, device="cpu", text_only=True)
    assert {eng.ff_quant, eng.proj_quant, eng.bert_ff_quant, eng.bert_proj_quant} == {"none"}
    eng = PenCLEngine(s1, device="cpu", text_only=True, use_stack=True, bert_ff_quant="int8",
                      bert_proj_quant="int8")
    assert eng._bert_arrays["w1"].dtype == torch.int8 and "sq" in eng._bert_arrays
    with pytest.raises(ValueError, match="never quantizes"):
        PenCLEngine(s1, device="cpu", text_only=True, tower_impl="graph", ff_quant="int8")

"""biom3_tpu_torch text tower and Facilitator vs the JAX package (CPU, f32).

``fused_bert_cls`` runs the port's kernel chain on the plain versions
against the JAX kernel in interpret mode, at ``tests/test_bert_stack.py``'s
config and tolerance (atol 3e-4, rtol 1e-3).  The plain modules (BERT
tower + projection head, Facilitator) are held against their Flax twins
through ``io/from_jax.py``, and ``dense_attention``'s plain version (the
tower's unmasked heads) against the JAX package's ``full_attention``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from biom3_tpu.config import BertConfig, ESM2Config, FacilitatorConfig, PenCLConfig
from biom3_tpu.models.bert import BertEncoder as JaxBert
from biom3_tpu.models.facilitator import Facilitator as JaxFacilitator
from biom3_tpu.models.pencl import PenCL
from biom3_tpu.ops.attention import full_attention as jax_full_attention
from biom3_tpu.ops.pallas.bert_stack_tpu import (
    bert_embed as jax_bert_embed,
    bert_stack_arrays as jax_bert_stack_arrays,
    fused_bert_cls as jax_fused_bert_cls,
)
from biom3_tpu_torch.io.from_jax import facilitator_from_jax, pencl_text_from_jax, port_config
from biom3_tpu_torch.ops import kernels
from biom3_tpu_torch.ops.bert_stack import bert_embed, bert_stack_arrays, fused_bert_cls

CFG = BertConfig(num_layers=2, hidden_size=128, num_heads=2,
                 intermediate_size=256, vocab_size=120,
                 max_position_embeddings=64)
TOL = dict(atol=3e-4, rtol=1e-3)


def _perturb(tree, seed):
    """Flax inits biases/norms to 0/1; perturb so every parameter matters."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32), tree)


@pytest.fixture(scope="module")
def pencl():
    """A small PenCL (text tower at CFG) and the port's text side."""
    cfg = PenCLConfig(esm=ESM2Config(num_layers=1, embed_dim=32, attention_heads=2),
                      bert=CFG, protein_embedding=32, text_embedding=CFG.hidden_size,
                      proj_dim=32)
    model = PenCL(cfg)
    params = model.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                         jnp.zeros((1, 8), jnp.int32), method=PenCL.init_all_params)
    params = _perturb(params, 0)
    return cfg, model, params, pencl_text_from_jax(params, port_config(cfg))


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
def test_fused_bert_cls_matches_jax(pencl, gelu):
    cfg, _, params, port = pencl
    bert_p = params["params"]["text_encoder"]
    ids = np.random.default_rng(1).integers(0, CFG.vocab_size, (2, 64)).astype(np.int32)
    arrays = jax_bert_stack_arrays(bert_p, CFG.num_layers, jnp.float32)
    x0 = jax_bert_embed(bert_p, jnp.asarray(ids), dtype=jnp.float32)
    want = np.asarray(jax_fused_bert_cls(x0, **arrays, heads=CFG.num_heads, rows=1,
                                         ff_block_l=32, gelu=gelu, interpret=True))
    x0_t = bert_embed(port.bert, torch.from_numpy(ids), dtype=torch.float32)
    np.testing.assert_allclose(x0_t.numpy(), np.asarray(x0), atol=1e-5)
    with torch.no_grad():
        got = fused_bert_cls(x0_t, **bert_stack_arrays(port.bert, torch.float32),
                             heads=CFG.num_heads, gelu=gelu).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("L", [64, 100])
@pytest.mark.parametrize("Dh", [32, 64])
def test_dense_attention_plain_matches_jax(Dh, L):
    """The wrapper on CPU tensors (its plain version) vs ``full_attention``
    with no mask in f32 on the same q/k/v: head dims 32 and 64, a length
    on and one off the kernel's 64-row tiles."""
    rng = np.random.default_rng(6)
    B, H = 2, 3
    q, k, v = (rng.standard_normal((B, H, L, Dh)).astype(np.float32) for _ in range(3))
    want = np.asarray(jax_full_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))
    want = want.transpose(0, 2, 1, 3).reshape(B, L, H * Dh)
    qkv = np.concatenate([t.transpose(0, 2, 1, 3).reshape(B, L, H * Dh) for t in (q, k, v)], -1)
    got = kernels.dense_attention(torch.from_numpy(qkv), heads=H).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


def test_plain_bert_and_encode_text_match_flax(pencl):
    cfg, model, params, port = pencl
    ids = np.random.default_rng(2).integers(0, CFG.vocab_size, (3, 40)).astype(np.int32)
    hidden = JaxBert(CFG).apply({"params": params["params"]["text_encoder"]},
                                jnp.asarray(ids))["hidden"]
    want_z = model.apply(params, jnp.asarray(ids), method=PenCL.encode_text)
    with torch.no_grad():
        got_h = port.bert(torch.from_numpy(ids))["hidden"].numpy()
        got_z = port.encode_text(torch.from_numpy(ids)).numpy()
    np.testing.assert_allclose(got_h, np.asarray(hidden), **TOL)
    np.testing.assert_allclose(got_z, np.asarray(want_z), **TOL)


def test_facilitator_matches_flax():
    cfg = FacilitatorConfig(in_dim=48, hid_dim=96, out_dim=48)
    model = JaxFacilitator(cfg)
    params = _perturb(model.init(jax.random.key(3), jnp.zeros((1, cfg.in_dim))), 3)
    z = np.random.default_rng(3).standard_normal((5, cfg.in_dim)).astype(np.float32)
    want = np.asarray(model.apply(params, jnp.asarray(z)))
    port = facilitator_from_jax(params, port_config(cfg))
    with torch.no_grad():
        got = port(torch.from_numpy(z)).numpy()
    np.testing.assert_allclose(got, want, atol=2e-4, rtol=1e-3)
    # the gain is one scalar over the whole matrix (weight_norm dim=None)
    assert port.main[0].weight_g.shape == ()

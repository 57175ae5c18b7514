"""biom3_tpu_torch ESM2 tower and its kernels vs the JAX package (CPU, f32).

``fused_esm2_cls`` runs the port's kernel chain on the plain versions
against the JAX kernel in interpret mode, at ``tests/test_esm2_stack.py``'s
token pattern and tolerance (atol 2e-4, rtol 1e-3).  The plain ``ESM2``
module is held against the Flax graph through ``io/from_jax.py``; each new
kernel's plain version against the JAX function it stands for: the rotary
+ masked attention of the Flax layer (``esm2_attention``), the Pallas flash
kernel in interpret mode (``flash_attention``, within 2e-5 as
``tests/test_pallas_kernels.py``) and the Flax embedding with token
dropout (``esm2_embed``).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from flax import linen as nn
from jax.experimental.pallas import tpu as pltpu

from biom3_tpu.config import ESM2Config
from biom3_tpu.models.esm2 import ESM2 as JaxESM2
from biom3_tpu.ops.attention import full_attention as jax_full_attention
from biom3_tpu.ops.pallas.esm2_stack_tpu import (
    esm2_stack_arrays as jax_esm2_stack_arrays,
    fused_esm2_cls as jax_fused_esm2_cls,
)
from biom3_tpu.ops.pallas.flash_attention_tpu import flash_attention_pallas
from biom3_tpu.ops.rotary import apply_rotary as jax_apply_rotary
from biom3_tpu.ops.rotary import rotary_cos_sin as jax_rotary_cos_sin
from biom3_tpu_torch.io.from_jax import esm2_from_jax, port_config
from biom3_tpu_torch.models.esm2 import ESM2, esm2_state_dict
from biom3_tpu_torch.ops import kernels
from biom3_tpu_torch.ops.esm2_stack import esm2_stack_arrays, fused_esm2_cls
from biom3_tpu_torch.ops.rotary import apply_rotary, rotary_cos_sin

CFG = ESM2Config(num_layers=2, embed_dim=128, attention_heads=2, vocab_size=33)
PORT_CFG = port_config(CFG)   # the port's own config class
TOL = dict(atol=2e-4, rtol=1e-3)


def _perturb(tree, seed):
    """Flax inits biases/norms to 0/1; perturb so every parameter matters."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32), tree)


def _tokens(rng, B=2, L=128, pad=6):
    """<cls>, residues, <eos>, a PAD tail; one <mask> in row 0."""
    toks = np.concatenate([
        np.zeros((B, 1), np.int32),
        rng.integers(4, 24, (B, L - pad - 2)).astype(np.int32),
        np.full((B, 1), 2, np.int32),
        np.full((B, pad), 1, np.int32),
    ], axis=1)
    toks[0, 5] = 32
    return toks


@pytest.fixture(scope="module")
def tower():
    """A small Flax ESM2 with its LM head, and the port's module."""
    model = JaxESM2(CFG)
    params = model.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32), compute_logits=True)
    params = _perturb(params, 0)
    return model, params, esm2_from_jax(params, PORT_CFG)


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
def test_fused_esm2_cls_matches_jax_kernel(tower, gelu):
    _, params, port = tower
    toks = _tokens(np.random.default_rng(1))
    arrays = jax_esm2_stack_arrays(params["params"], CFG.num_layers, dtype=jnp.float32)
    want = np.asarray(jax_fused_esm2_cls(jnp.asarray(toks), **arrays, heads=CFG.attention_heads,
                                         ff_block_l=64, gelu=gelu, interpret=True))
    with torch.no_grad():
        got = fused_esm2_cls(torch.from_numpy(toks), **esm2_stack_arrays(port, torch.float32),
                             heads=CFG.attention_heads, gelu=gelu).numpy()
    assert got.shape == (2, CFG.embed_dim) and got.dtype == np.float32
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("heads", [2, 4], ids=["Dh64", "Dh32"])
@pytest.mark.parametrize("L", [65, 130])
def test_fused_esm2_cls_matches_jax_kernel_off_the_tiles(tower, L, heads):
    """``esm2_attention_plain`` inside the tower chain vs the JAX kernel in
    interpret mode at lengths one and two keys past the kernel's 64-row
    tiles, head dims 64 and 32, with a PAD-tailed row and an all-PAD row
    (the −1e9 added on every key: it attends uniformly)."""
    _, params, port = tower
    toks = _tokens(np.random.default_rng(6), B=2, L=L, pad=L // 3)
    toks[1] = 1
    arrays = jax_esm2_stack_arrays(params["params"], CFG.num_layers, dtype=jnp.float32)
    want = np.asarray(jax_fused_esm2_cls(jnp.asarray(toks), **arrays, heads=heads,
                                         ff_block_l=64, interpret=True))
    with torch.no_grad():
        got = fused_esm2_cls(torch.from_numpy(toks), **esm2_stack_arrays(port, torch.float32),
                             heads=heads).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("gelu", ["erf", "tanh"])
def test_plain_esm2_matches_flax(tower, gelu):
    _, params, _ = tower
    toks = _tokens(np.random.default_rng(2), B=3, L=40, pad=9)
    want = np.asarray(JaxESM2(CFG, gelu=gelu).apply(params, jnp.asarray(toks))["hidden"])
    port = esm2_from_jax(params, PORT_CFG, gelu=gelu)
    with torch.no_grad():
        got = port(torch.from_numpy(toks))["hidden"].numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_rotary_matches_jax():
    x = np.random.default_rng(3).standard_normal((2, 3, 50, 64)).astype(np.float32)
    jc, js = jax_rotary_cos_sin(50, 64)
    cos, sin = rotary_cos_sin(50, 64)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jc), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(js), atol=1e-6)
    got = apply_rotary(torch.from_numpy(x), cos, sin).numpy()
    np.testing.assert_allclose(got, np.asarray(jax_apply_rotary(jnp.asarray(x), jc, js)),
                               atol=1e-5)


def test_esm2_attention_plain_matches_flax_rotary_attention():
    """The wrapper on CPU tensors (its plain version) vs the Flax layer's
    rotary + masked full_attention on the same q/k/v, ragged PAD tails."""
    rng = np.random.default_rng(4)
    B, H, L, Dh = 3, 2, 96, 64
    q, k, v = (rng.standard_normal((B, H, L, Dh)).astype(np.float32) for _ in range(3))
    pad = np.zeros((B, L), bool)
    for b, n in enumerate((0, 17, 60)):
        pad[b, L - n:] = n > 0
    cos, sin = jax_rotary_cos_sin(L, Dh)
    want = jax_full_attention(jax_apply_rotary(jnp.asarray(q), cos, sin),
                              jax_apply_rotary(jnp.asarray(k), cos, sin), jnp.asarray(v),
                              padding_mask=jnp.asarray(pad))
    want = np.asarray(want).transpose(0, 2, 1, 3).reshape(B, L, H * Dh)
    qkv = np.concatenate([t.transpose(0, 2, 1, 3).reshape(B, L, H * Dh) for t in (q, k, v)], -1)
    tc, ts = rotary_cos_sin(L, Dh)
    got = kernels.esm2_attention(torch.from_numpy(qkv), torch.from_numpy(pad.astype(np.int32)),
                                 tc, ts, heads=H).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)


# (mask, L, D): lengths off the kernel's 64-row tiles (its keys >= L are
# excluded, not PAD: an all-PAD row averages over its L keys only) and head
# dim 32, which the kernel runs as zero-filled 64-wide tiles
FLASH_CASES = [pytest.param("masked", 128, 64, id="masked"),
               pytest.param("unmasked", 128, 64, id="unmasked"),
               pytest.param("all_pad_row", 128, 64, id="all_pad_row"),
               pytest.param("masked", 100, 64, id="masked-L100"),
               pytest.param("unmasked", 128, 32, id="unmasked-D32"),
               pytest.param("all_pad_row", 100, 32, id="all_pad_row-L100-D32")]


@pytest.mark.parametrize("case,L,D", FLASH_CASES)
def test_flash_attention_plain_matches_pallas(case, L, D):
    rng = np.random.default_rng(5)
    B, H = 2, 2
    q, k, v = (rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(3))
    mask = None
    if case != "unmasked":
        mask = rng.random((B, L)) < 0.25
        if case == "all_pad_row":
            mask[1] = True
    jmask = None if mask is None else jnp.asarray(mask)
    blk = 64 if L % 64 == 0 else L   # the Pallas kernel needs L divisible by its blocks
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(flash_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                                 padding_mask=jmask, blk_q=blk, blk_k=blk))
    tmask = None if mask is None else torch.from_numpy(mask.astype(np.int32))
    got = kernels.flash_attention(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                                  tmask).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5)
    if case == "all_pad_row":  # uniform weights: the mean of V
        np.testing.assert_allclose(got[1], np.broadcast_to(v[1].mean(1, keepdims=True), got[1].shape),
                                   atol=2e-5)


def _flax_layer0_input(cfg, params, toks):
    """The input of the Flax tower's first layer: embedding, token dropout
    and PAD zeroing, captured by intercepting ``layers_0``."""
    seen = {}

    def grab(next_fun, args, kwargs, context):
        if context.method_name == "__call__" and context.module.name == "layers_0":
            seen["x"] = np.asarray(args[0])
        return next_fun(*args, **kwargs)

    with nn.intercept_methods(grab):
        JaxESM2(cfg).apply(params, jnp.asarray(toks))
    return seen["x"]


@pytest.mark.parametrize("token_dropout", [True, False])
def test_esm2_embed_plain_matches_flax(tower, token_dropout):
    _, params, port = tower
    cfg = ESM2Config(num_layers=2, embed_dim=128, attention_heads=2, vocab_size=33,
                     token_dropout=token_dropout)
    toks = _tokens(np.random.default_rng(6), B=3, L=64, pad=20)
    toks[1, 3:9] = 32  # a second row with several <mask> tokens
    toks[2, 1:] = 1    # a row of <cls> and PAD only
    want = _flax_layer0_input(cfg, params, toks)
    got = kernels.esm2_embed(torch.from_numpy(toks), port.embed_tokens.weight.detach(),
                             pad_idx=cfg.pad_idx, mask_idx=cfg.mask_idx,
                             token_dropout=token_dropout).numpy()
    np.testing.assert_allclose(got, want, atol=1e-6, rtol=1e-6)


def test_esm2_state_dict_drops_only_named_keys(tower):
    """A fair-esm state dict carries the LM head (weight tied to
    embed_tokens), the contact head and rotary buffers: the filter drops
    exactly those, and any other stray key still fails the strict load."""
    _, _, port = tower
    sd = {k: v.clone() for k, v in port.state_dict().items()}
    extra = {"lm_head.weight": sd["embed_tokens.weight"], "lm_head.bias": torch.zeros(33),
             "lm_head.dense.weight": torch.zeros(128, 128),
             "contact_head.regression.weight": torch.zeros(1, 4),
             "contact_head.regression.bias": torch.zeros(1)}
    extra.update({f"layers.{i}.self_attn.rot_emb.inv_freq": torch.zeros(32)
                  for i in range(CFG.num_layers)})
    assert esm2_state_dict({**sd, **extra}).keys() == sd.keys()
    ESM2(PORT_CFG).load_state_dict(esm2_state_dict({**sd, **extra}), strict=True)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        ESM2(PORT_CFG).load_state_dict(esm2_state_dict({**sd, "layers.0.stray": torch.zeros(1)}),
                                  strict=True)

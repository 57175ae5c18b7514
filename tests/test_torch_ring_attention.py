"""Ring attention in biom3_tpu_torch against the JAX package (CPU, f32).

``ops/ring_attention.ring_attention`` over the tp axis of an 8-position
mesh (``devices=[cpu] * 8``; positions named ``cpu:0`` .. ``cpu:7`` count
as distinct devices, so the blocks move between "devices" on every hop)
against JAX ``ring_attention`` on its 8-device CPU mesh, at
``tests/test_ring_attention.py``'s shapes and tolerances (atol 2e-5; 3e-5
at L = 4096): alone, with a PAD mask, and at L = 4096 with D = 16.  Its
autograd gradients against the plain attention's; ``full_attention(
impl="ring")``; and ``ESM2(attn_impl="ring")`` against JAX
``ESM2(attn_impl="xla")`` at 2 layers and width 64.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from biom3_tpu.config import ESM2Config
from biom3_tpu.models.esm2 import ESM2 as JaxESM2
from biom3_tpu.ops.ring_attention import ring_attention as jax_ring_attention
from biom3_tpu_torch.io.from_jax import esm2_from_jax, port_config
from biom3_tpu_torch.ops import full_attention, ring_attention
from biom3_tpu_torch.parallel import MeshConfig, make_mesh


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small ops, which stall in
    the thread pool's barriers when the suite's workers share the cores
    (15× slower there with the default pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def meshes():
    jmesh = JaxMesh(np.asarray(jax.devices()[:8]).reshape(8), ("tp",))
    shared = make_mesh(MeshConfig(tp=8), [torch.device("cpu")] * 8)
    distinct = make_mesh(MeshConfig(tp=8), [torch.device("cpu", i) for i in range(8)])
    return jmesh, shared, distinct


def _qkv(rng, B=2, H=2, L=256, D=32):
    return tuple(rng.standard_normal((B, H, L, D)).astype(np.float32) for _ in range(3))


@pytest.mark.parametrize("case", ["full", "padding_mask", "long_context"])
def test_ring_attention_matches_jax(meshes, case):
    jmesh, shared, distinct = meshes
    rng = np.random.default_rng(0)
    shape, atol, mask = dict(), 2e-5, None
    if case == "padding_mask":
        shape = dict(L=128)
    elif case == "long_context":   # beyond the reference's 1024 cap
        shape, atol = dict(B=1, H=1, L=4096, D=16), 3e-5
    q, k, v = _qkv(rng, **shape)
    if case == "padding_mask":
        mask = rng.random((2, 128)) < 0.3
    want = np.asarray(jax_ring_attention(*map(jnp.asarray, (q, k, v)), jmesh,
                                         padding_mask=None if mask is None else jnp.asarray(mask)))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    tmask = None if mask is None else torch.from_numpy(mask)
    got = ring_attention(tq, tk, tv, shared, padding_mask=tmask)
    np.testing.assert_allclose(got.numpy(), want, atol=atol)
    np.testing.assert_array_equal(ring_attention(tq, tk, tv, distinct, padding_mask=tmask).numpy(),
                                  got.numpy())
    np.testing.assert_array_equal(
        full_attention(tq, tk, tv, tmask, impl="ring", mesh=shared).numpy(), got.numpy())


def test_ring_attention_gradients_match_plain_attention(meshes):
    _, shared, _ = meshes
    rng = np.random.default_rng(1)
    q, k, v = (torch.from_numpy(a).requires_grad_() for a in _qkv(rng, L=128))
    mask = torch.from_numpy(rng.random((2, 128)) < 0.3)
    dy = torch.from_numpy(rng.standard_normal((2, 2, 128, 32)).astype(np.float32))
    grads = []
    for impl, mesh in (("ring", shared), ("plain", None)):
        out = full_attention(q, k, v, mask, impl=impl, mesh=mesh)
        grads.append(torch.autograd.grad((out * dy).sum(), (q, k, v)))
    for g, w in zip(*grads):
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=2e-5)
    with pytest.raises(ValueError, match="needs a mesh"):
        full_attention(q, k, v, impl="ring")
    with pytest.raises(ValueError, match="not divisible by the 8 positions"):
        ring_attention(q[:, :, :100], k[:, :, :100], v[:, :, :100], shared)


def test_esm2_with_ring_attention_matches_jax_xla(meshes):
    """The whole protein tower with its attention over 8 positions, against
    the JAX tower with plain attention (``tests/test_ring_attention.py``)."""
    jmesh, shared, _ = meshes
    rng = np.random.default_rng(0)
    cfg = ESM2Config(num_layers=2, embed_dim=64, attention_heads=2, vocab_size=33)
    tokens = np.concatenate([np.zeros((2, 1), np.int32),
                             rng.integers(4, 24, (2, 61)).astype(np.int32),
                             np.full((2, 1), 2, np.int32),
                             np.full((2, 1), 1, np.int32)], axis=1)   # one PAD
    model = JaxESM2(cfg, attn_impl="xla")
    params = model.init(jax.random.key(0), jnp.asarray(tokens))
    want = np.asarray(model.apply(params, jnp.asarray(tokens))["hidden"])
    port = esm2_from_jax(params, port_config(cfg), attn_impl="ring", mesh=shared)
    with torch.no_grad():
        got = port(torch.from_numpy(tokens))["hidden"].numpy()
    np.testing.assert_allclose(got, want, atol=3e-5)
    with pytest.raises(ValueError, match="needs a mesh"):
        esm2_from_jax(params, port_config(cfg), attn_impl="ring")

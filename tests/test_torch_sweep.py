"""The generation sweep in biom3_tpu_torch against the JAX package (CPU, f32).

``pipeline/sweep.SweepRunner`` on the port's stack forward against JAX
``SweepRunner`` on the Flax graph over a one-device mesh, at temperature 0
(RNG-free), with the JAX module's ``sample_permutations`` patched to hand
out the paths the port's runner drew, slab by slab: 3 prompts × 3
replicas at ``device_batch=4`` (slabs of 4, 4 and a partial 1), at k = 1
and k = 4, chunked.  The sequences must be equal.
``Stage1SweepRunner`` against JAX's (tower kernels in interpret mode,
tanh GELU) at the JAX test's tiny config (tests/test_sweep.py:93-115), N =
11 in slabs of 4 (the engine set to tanh GELU, which it picks by itself
only on the card): z_t and z_p within atol 2e-4 / rtol 1e-3.  A text-only
engine is refused with JAX's message, and an unknown GELU by the engine.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import biom3_tpu.pipeline.sweep as jax_sweep
import biom3_tpu_torch.pipeline.sweep as sweep
from biom3_tpu.config import Config as JaxConfig, ProteoScribeConfig
from biom3_tpu.io.export import pencl_params_to_torch
from biom3_tpu.io.torch_load import save_torch_file
from biom3_tpu.models.proteoscribe import ProteoScribe as JaxProteoScribe
from biom3_tpu.parallel.mesh import MeshConfig, make_mesh
from biom3_tpu_torch.config import Config
from biom3_tpu_torch.io.from_jax import port_config, proteoscribe_from_jax
from biom3_tpu_torch.models.fused_forward import make_stack_apply

SMALL = ProteoScribeConfig(
    num_classes=29, dim=32, depth=2, n_blocks=1, heads=4, local_heads=2,
    local_window=8, max_seq_len=32, num_timesteps=32, cond_dim=16,
)
TOL = dict(atol=2e-4, rtol=1e-3)


@pytest.fixture(scope="module")
def stage3():
    rng = np.random.default_rng(0)
    model = JaxProteoScribe(SMALL)
    L = SMALL.max_seq_len
    variables = model.init(jax.random.key(0), jnp.zeros((1, L), jnp.int32),
                           jnp.zeros((1,), jnp.int32), jnp.zeros((1, SMALL.cond_dim)))
    variables = jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32), variables)
    return model, variables, proteoscribe_from_jax(variables, port_config(SMALL))


@pytest.mark.parametrize("k,chunk", [(1, 8), (4, 2)])
def test_sweep_runner_equals_jax(stage3, monkeypatch, k, chunk):
    model, variables, port = stage3
    prompts = np.random.default_rng(3).standard_normal((3, SMALL.cond_dim)).astype(np.float32)
    paths = []
    port_perms = sweep.sample_permutations

    def record(generator, batch, length):
        paths.append(port_perms(generator, batch, length))
        return paths[-1]

    monkeypatch.setattr(sweep, "sample_permutations", record)
    runner = sweep.SweepRunner(make_stack_apply(port, dtype=torch.float32, gelu="erf"),
                               SMALL.num_timesteps, device="cpu", temperature=0.0,
                               chunk_steps=chunk, positions_per_step=k,
                               apply_takes_positions=True)
    got = runner.run(prompts, num_replicas=3, seed=5, device_batch=4)
    assert [len(p) for p in paths] == [4, 4, 1]

    handed = iter(paths)
    monkeypatch.setattr(jax_sweep, "sample_permutations",
                        lambda key, batch, length: jnp.asarray(next(handed).numpy()))
    jax_runner = jax_sweep.SweepRunner(model.apply, variables, SMALL.num_timesteps,
                                       make_mesh(MeshConfig(dp=1, fsdp=1, tp=1)),
                                       temperature=0.0, chunk_steps=chunk, positions_per_step=k)
    want = jax_runner.run(prompts, num_replicas=3, seed=5, device_batch=4)
    assert got == want
    assert len(got) == 3 and all(len(r) == 3 for r in got)


def test_sweep_runner_needs_a_card_unless_told_cpu(stage3):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        sweep.SweepRunner(lambda x, t, z: None, SMALL.num_timesteps)


STAGE1 = {
    "protein_encoder_embedding": 16, "text_encoder_embedding": 16,
    "esm_num_layers": 1, "esm_attention_heads": 2,
    "bert_num_layers": 1, "bert_num_heads": 2,
    "bert_intermediate_size": 32, "bert_vocab_size": 40,
    "bert_max_position_embeddings": 32,
    "proj_embedding_dim": 8, "temperature": 0.8, "dropout": 0.1,
    "text_max_length": 32,
}


def test_stage1_sweep_runner_equals_jax(tmp_path):
    from biom3_tpu.pipeline.stage1 import PenCLEngine as JaxPenCLEngine
    from biom3_tpu_torch.pipeline.stage1 import PenCLEngine

    jax_engine = JaxPenCLEngine(JaxConfig(STAGE1), None, dtype=jnp.float32,
                                tower_impl="fused-stack", attn_impl="xla")
    save_torch_file({k: torch.from_numpy(np.array(v)) for k, v in
                     pencl_params_to_torch(jax_engine.params, jax_engine.config).items()},
                    tmp_path / "pencl.bin")
    engine = PenCLEngine(Config(STAGE1), tmp_path / "pencl.bin", device="cpu", use_stack=True,
                         gelu="tanh")
    rng = np.random.default_rng(0)
    N = 11
    x_t = rng.integers(4, 40, (N, 32)).astype(np.int32)
    x_p = rng.integers(4, 30, (N, 24)).astype(np.int32)
    want = jax_sweep.Stage1SweepRunner(jax_engine, make_mesh(MeshConfig(dp=1, fsdp=1, tp=1)),
                                       device_batch=4, interpret=True).run(x_t, x_p)
    got = sweep.Stage1SweepRunner(engine, device_batch=4).run(x_t, x_p)
    for g, w in zip(got, want):
        assert g.shape == w.shape == (N, 8) and g.dtype == np.float32
        np.testing.assert_allclose(g, w, **TOL)

    with pytest.raises(ValueError) as jax_refusal:
        jax_sweep.Stage1SweepRunner(
            JaxPenCLEngine(JaxConfig(STAGE1), None, dtype=jnp.float32, text_only=True,
                           tower_impl="fused-stack", attn_impl="xla"),
            make_mesh(MeshConfig(dp=1, fsdp=1, tp=1)))
    text_only = PenCLEngine(Config(STAGE1), tmp_path / "pencl.bin", device="cpu",
                            use_stack=True, text_only=True)
    for eng in (text_only, PenCLEngine(Config(STAGE1), tmp_path / "pencl.bin", device="cpu")):
        with pytest.raises(ValueError) as refusal:
            sweep.Stage1SweepRunner(eng)
        assert str(refusal.value) == str(jax_refusal.value)
    with pytest.raises(ValueError, match="gelu must be 'erf' or 'tanh', got 'relu'"):
        PenCLEngine(Config(STAGE1), None, device="cpu", use_stack=True, gelu="relu")

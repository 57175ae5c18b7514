"""The port's device mesh (``biom3_tpu_torch.parallel``) and the paths that
run on it, against the JAX package on its 8-device CPU mesh (CPU, f32).

The port's positions share one device here (``devices=[cpu] * n``), which
runs the same code that spreads rows over distinct cards; positions named
``cpu:1`` .. ``cpu:n-1`` (which torch places on the CPU) count as distinct
devices, so the per-device copies are built and used too.  A shard's
logits equal the one-device forward's on the same rows bit for bit; over a
whole batch they may differ in the last bits (the CPU's matmuls block by
row count), which moves no sampled id here, so a mesh run's ids must
equal the one-device run's, randomness included (the draws stay on the
global batch); against the JAX package the comparisons run at
temperature 0, with the JAX module's paths handed to the port where the
sampler draws them.

* ``make_mesh``: position order as JAX's for (8,1,1), (4,2,1), (2,2,2),
  and the batch positions as ``P(("dp", "fsdp"))``'s; too few devices raise
  JAX's message, no card raises.
* ``make_sharded_stack_apply`` on (dp 2, fsdp 2): shard by shard equal to
  the one-device apply on the shard's rows, the whole batch within 1e-5 of
  it; within 2e-4 / 1e-3 of JAX's under ``shard_map`` (interpret mode); B
  % 4 raises.
* ``make_sharded_sampler``/``make_sharded_inpainter``: ids equal to JAX's
  at temperature 0, and to the one-device ``sample_batch``/
  ``inpaint_batch`` at temperature 1.
* ``SweepRunner``/``Stage1SweepRunner`` on a mesh, mirroring
  ``tests/test_sweep.py``.
* ``ServingPipeline(mesh=...)`` with the continuous, trajectory and packed
  paths, mirroring ``tests/test_serving.py:311-366`` and
  ``tests/test_continuous.py:286-300``.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

import biom3_tpu.pipeline.sweep as jax_sweep
import biom3_tpu_torch.pipeline.sweep as sweep
from biom3_tpu.config import Config as JaxConfig, ProteoScribeConfig
from biom3_tpu.diffusion.sampler import sample_permutations as jax_sample_permutations
from biom3_tpu.io.export import pencl_params_to_torch, proteoscribe_params_to_torch
from biom3_tpu.io.torch_load import save_torch_file
from biom3_tpu.models.fused_forward import (
    make_sharded_stack_apply as jax_make_sharded_stack_apply,
)
from biom3_tpu.models.proteoscribe import ProteoScribe as JaxProteoScribe
from biom3_tpu.parallel.mesh import MeshConfig as JaxMeshConfig, make_mesh as jax_make_mesh
from biom3_tpu.pipeline.stage3 import ProteoScribeEngine as JaxEngine
from biom3_tpu_torch.config import Config
from biom3_tpu_torch.io.from_jax import port_config, proteoscribe_from_jax
from biom3_tpu_torch.models.fused_forward import make_sharded_stack_apply, make_stack_apply
from biom3_tpu_torch.parallel import MeshConfig, make_mesh
from biom3_tpu_torch.pipeline.stage3 import ProteoScribeEngine
from test_cli import is_subsequence
from test_torch_serving import PROMPT, _valid, stage_files  # noqa: F401  (fixture)

TOL = dict(atol=2e-4, rtol=1e-3)
CPU = torch.device("cpu")
# the JAX test_sweep.py configuration
TINY = ProteoScribeConfig(
    num_classes=29, dim=32, depth=2, n_blocks=1, heads=4, local_heads=2,
    local_window=16, max_seq_len=64, num_timesteps=64, cond_dim=16,
)
STAGE3 = {"diffusion_steps": 32, "num_classes": 29, "text_emb_dim": 16,
          "transformer_dim": 32, "transformer_heads": 4, "transformer_depth": 2,
          "transformer_blocks": 1, "transformer_local_heads": 2, "transformer_local_size": 8}


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: these tests run many small ops, which stall in
    the thread pool's barriers when the suite's workers share the cores
    (15× slower there with the default pool)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _perturb(tree, seed):
    """Flax inits biases and norms to 0 and 1: perturb so every parameter matters."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32), tree)


def _cpu_mesh(dp, fsdp=1, tp=1, distinct=False):
    n = dp * fsdp * tp
    devices = [CPU] + [torch.device("cpu", i) for i in range(1, n)] if distinct else [CPU] * n
    return make_mesh(MeshConfig(dp=dp, fsdp=fsdp, tp=tp), devices)


# --- make_mesh ------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(8, 1, 1), (4, 2, 1), (2, 2, 2)])
def test_make_mesh_order_matches_jax(shape):
    jmesh = jax_make_mesh(JaxMeshConfig(*shape))
    mesh = make_mesh(MeshConfig(*shape), [torch.device("cpu", d.id) for d in jax.devices()])
    assert mesh.shape == dict(jmesh.shape) and mesh.axis_names == jmesh.axis_names
    assert [d.index for d in mesh.devices.flat] == [d.id for d in jmesh.devices.flat]
    # batch shard s holds rows [s·B/n, (s+1)·B/n) on a device JAX puts them on
    B, n = 16, mesh.batch_shards
    rows = NamedSharding(jmesh, P(("dp", "fsdp"))).devices_indices_map((B,))
    for s, device in enumerate(mesh.batch_devices()):
        holders = {d.id for d, (sl,) in rows.items() if (sl.start, sl.stop) == (s * B // n,
                                                                              (s + 1) * B // n)}
        assert device.index in holders
    assert [d.index for d in mesh.axis_devices("tp")] == [d.id for d in jmesh.devices[0, 0]]


def test_make_mesh_refuses_too_few_devices():
    with pytest.raises(ValueError) as jax_err:
        jax_make_mesh(JaxMeshConfig(dp=4, fsdp=2), jax.devices()[:6])
    with pytest.raises(ValueError) as err:
        make_mesh(MeshConfig(dp=4, fsdp=2), [CPU] * 6)
    assert str(err.value) == str(jax_err.value) == "mesh needs 8 devices, have 6"


def test_make_mesh_needs_a_card_unless_given_devices():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for devices in (None, ["cuda"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(MeshConfig(dp=2), devices)
    assert repr(_cpu_mesh(2, 2)) == "Mesh(dp=2, fsdp=2, tp=1; cpu x4)"


# --- the sharded stack forward -------------------------------------------------------

@pytest.fixture(scope="module")
def tiny():
    model = JaxProteoScribe(TINY)
    L = TINY.max_seq_len
    variables = _perturb(model.init(jax.random.key(0), jnp.zeros((1, L), jnp.int32),
                                    jnp.zeros((1,), jnp.int32), jnp.zeros((1, TINY.cond_dim))), 0)
    return model, variables, proteoscribe_from_jax(variables, port_config(TINY))


@pytest.mark.parametrize("distinct", [False, True])
def test_sharded_stack_apply_equals_one_device_and_jax(tiny, distinct):
    _, variables, port = tiny
    rng = np.random.default_rng(1)
    B, L, k = 8, TINY.max_seq_len, 4
    x = rng.integers(0, 29, (B, L)).astype(np.int32)
    t = rng.integers(0, L, (B,)).astype(np.int32)
    z = rng.standard_normal((B, TINY.cond_dim)).astype(np.float32)
    pos = np.stack([rng.permutation(L)[:k] for _ in range(B)]).astype(np.int32)
    mesh = _cpu_mesh(2, 2, distinct=distinct)
    sharded = make_sharded_stack_apply(port, mesh, dtype=torch.float32, gelu="erf")
    one = make_stack_apply(port, dtype=torch.float32, gelu="erf")
    args = [torch.from_numpy(a) for a in (x, t, z, pos)]
    got = sharded(*args)
    assert sharded.mesh is mesh and got.shape == (B, k, 29)
    # the whole batch differs in the last bits (the CPU's matmuls block by
    # the row count): within f32 summation order, never bit for bit
    np.testing.assert_allclose(got.numpy(), one(*args).numpy(), rtol=0, atol=1e-5)
    for s in range(4):   # each shard against the one-device forward on its own rows
        rows = slice(2 * s, 2 * s + 2)
        np.testing.assert_array_equal(got[rows].numpy(), one(*(a[rows] for a in args)).numpy())
    with pytest.raises(ValueError, match="batch 6 not divisible by 4 mesh shards"):
        sharded(*(a[:6] for a in args))
    if not distinct:
        jmesh = jax_make_mesh(JaxMeshConfig(dp=2, fsdp=2), jax.devices()[:4])
        want = jax_make_sharded_stack_apply(TINY, jmesh, dtype=jnp.float32, resident=True,
                                            interpret=True)(variables, *map(jnp.asarray,
                                                                           (x, t, z, pos)))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# --- the engine's sharded sampler and inpainter ------------------------------------

@pytest.fixture(scope="module")
def engines(tmp_path_factory):
    """The JAX engine at temperature 0 (seeded init, perturbed), its .bin,
    and the port's engines on it at temperature 0 and 1."""
    root = tmp_path_factory.mktemp("parallel")
    j3 = JaxEngine(JaxConfig(STAGE3), None, temperature=0.0, positions_per_step=4, chunk_steps=8)
    j3.params = _perturb(j3.params, 2)
    save_torch_file(proteoscribe_params_to_torch(j3.params, j3.config), root / "s3.bin")
    port = {temp: ProteoScribeEngine(Config(STAGE3), str(root / "s3.bin"), device="cpu",
                                     use_stack=True, temperature=temp, positions_per_step=4,
                                     chunk_steps=8) for temp in (0.0, 1.0)}
    return j3, port


def _masked(vocab, n):
    return np.stack([vocab.encode_partial("MK??ACDE??W?", STAGE3["diffusion_steps"])] * n)


def test_sharded_sampler_and_inpainter_equal_jax_at_temperature_0(engines):
    j3, port = engines
    jmesh = jax_make_mesh(JaxMeshConfig(dp=2, fsdp=2), jax.devices()[:4])
    mesh = _cpu_mesh(2, 2)
    z = np.random.default_rng(3).standard_normal((8, 16)).astype(np.float32)
    key = jax.random.key(11)
    paths = np.array(jax_sample_permutations(jax.random.split(key)[1], 8, 32))
    want = j3.make_sharded_sampler(jmesh, interpret=True)(z, key)
    got = port[0.0].make_sharded_sampler(mesh)(z, None, paths=paths)
    np.testing.assert_array_equal(got, want)
    masked = _masked(port[0.0].vocab, 8)
    want = j3.make_sharded_inpainter(jmesh, interpret=True)(masked, z, key)
    got = port[0.0].make_sharded_inpainter(mesh)(masked, z)
    np.testing.assert_array_equal(got, want)
    assert (got[masked != 0] == masked[masked != 0]).all() and (got != 0).all()
    with pytest.raises(ValueError, match="batch 6 not divisible by 4 mesh shards"):
        port[0.0].make_sharded_sampler(mesh)(z[:6], None, paths=paths[:6])


@pytest.mark.parametrize("distinct", [False, True])
def test_sharded_sampler_and_inpainter_equal_one_device_at_temperature_1(engines, distinct):
    eng = engines[1][1.0]
    mesh = _cpu_mesh(4, 2, distinct=distinct)
    z = np.random.default_rng(4).standard_normal((8, 16)).astype(np.float32)
    seeded = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    one = eng.sample_batch(z, seeded())
    np.testing.assert_array_equal(eng.make_sharded_sampler(mesh)(z, seeded()), one)
    masked = _masked(eng.vocab, 8)
    np.testing.assert_array_equal(eng.make_sharded_inpainter(mesh)(masked, z, seeded()),
                                  eng.inpaint_batch(masked, z, seeded()))
    with pytest.raises(ValueError, match="mesh's first position"):
        eng.make_sharded_sampler(make_mesh(MeshConfig(dp=2), [torch.device("cpu", 1)] * 2))


# --- the sweep runners ---------------------------------------------------------------

def _sweep_both(tiny, monkeypatch, mesh, prompts, replicas, device_batch, temperature=0.0):
    """The port's runner on ``mesh`` (recording its paths), then JAX's on the
    8-device mesh with those paths handed over."""
    model, variables, port = tiny
    paths = []
    port_perms = sweep.sample_permutations

    def record(generator, batch, length):
        paths.append(port_perms(generator, batch, length))
        return paths[-1]

    monkeypatch.setattr(sweep, "sample_permutations", record)
    runner = sweep.SweepRunner(make_sharded_stack_apply(port, mesh, dtype=torch.float32),
                               TINY.num_timesteps, mesh=mesh, temperature=temperature,
                               chunk_steps=32, apply_takes_positions=True)
    got = runner.run(prompts, num_replicas=replicas, seed=5, device_batch=device_batch)
    handed = iter(paths)
    monkeypatch.setattr(jax_sweep, "sample_permutations",
                        lambda key, batch, length: jnp.asarray(next(handed).numpy()))
    jax_runner = jax_sweep.SweepRunner(model.apply, variables, TINY.num_timesteps,
                                       jax_make_mesh(JaxMeshConfig(dp=4, fsdp=2)),
                                       temperature=0.0, chunk_steps=32)
    want = jax_runner.run(prompts, num_replicas=replicas, seed=5, device_batch=device_batch)
    return got, want, [len(p) for p in paths]


def test_sweep_runner_sharded_stack_equals_jax_and_one_device(tiny, monkeypatch):
    """``test_sweep_runner_sharded_stack_kernel``: the sharded stack forward
    on (dp 4, fsdp 2), 4 prompts × 2 replicas in one slab of 8, equal to
    JAX's runner at temperature 0; at temperature 1 equal to the
    one-device runner at the same seed."""
    mesh = _cpu_mesh(4, 2)
    prompts = np.random.default_rng(0).standard_normal((4, 16)).astype(np.float32)
    got, want, sizes = _sweep_both(tiny, monkeypatch, mesh, prompts, 2, 8)
    assert got == want and sizes == [8] and all(len(r) == 2 for r in got)
    port = tiny[2]
    kw = dict(temperature=1.0, chunk_steps=32, apply_takes_positions=True)
    one = sweep.SweepRunner(make_stack_apply(port, dtype=torch.float32), TINY.num_timesteps,
                            device="cpu", **kw)
    on_mesh = sweep.SweepRunner(make_sharded_stack_apply(port, mesh, dtype=torch.float32),
                                TINY.num_timesteps, mesh=mesh, **kw)
    assert (on_mesh.run(prompts, num_replicas=2, seed=7, device_batch=8)
            == one.run(prompts, num_replicas=2, seed=7, device_batch=8))
    with pytest.raises(ValueError, match="needs an apply sharded over that mesh"):
        sweep.SweepRunner(make_stack_apply(port, dtype=torch.float32), TINY.num_timesteps,
                          mesh=mesh, **kw)


def test_sweep_runner_uneven_batch_padding(tiny, monkeypatch):
    """``test_sweep_runner_uneven_batch_padding``: 5 prompts × 3 replicas
    in a slab of 16 on 8 shards, one padding row; equal to JAX's."""
    prompts = np.random.default_rng(6).standard_normal((5, 16)).astype(np.float32)
    got, want, sizes = _sweep_both(tiny, monkeypatch, _cpu_mesh(4, 2), prompts, 3, 16)
    assert got == want and sizes == [16]
    assert len(got) == 5 and all(len(r) == 3 for r in got)


STAGE1 = {
    "protein_encoder_embedding": 16, "text_encoder_embedding": 16,
    "esm_num_layers": 1, "esm_attention_heads": 2,
    "bert_num_layers": 1, "bert_num_heads": 2,
    "bert_intermediate_size": 32, "bert_vocab_size": 40,
    "bert_max_position_embeddings": 32,
    "proj_embedding_dim": 8, "temperature": 0.8, "dropout": 0.1,
    "text_max_length": 32,
}


def test_stage1_sweep_runner_on_a_mesh(tmp_path):
    """``test_stage1_sweep_runner_sharded``: N = 11 pairs on 8 shards (5
    padding rows): cosine >= 0.999 against the JAX engine's Flax forward;
    each shard equal to the engine's forward on its rows, the whole within
    1e-6 of the one-device runner; per-device engine copies (distinct
    positions) give the same bits."""
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
    zt, zp = sweep.Stage1SweepRunner(engine, _cpu_mesh(4, 2), device_batch=16).run(x_t, x_p)
    assert zt.shape == zp.shape == (N, 8)
    ref = jax_engine._forward(jax_engine.params, jnp.asarray(x_t), jnp.asarray(x_p))
    for got, want in ((zt, np.asarray(ref["text_joint_latent"])),
                      (zp, np.asarray(ref["seq_joint_latent"]))):
        cos = (got * want).sum(-1) / (np.linalg.norm(got, axis=-1) * np.linalg.norm(want, axis=-1))
        assert cos.min() > 0.999, cos.min()
    # each shard's 2 rows (padding included) bit-equal to the one-device
    # forward on those rows, the whole slab within f32 summation order of the
    # one-device runner's
    xt = np.concatenate([x_t, np.zeros((5, 32), np.int32)])
    xp = np.concatenate([x_p, np.ones((5, 24), np.int32)])
    shard_rows = [engine.embed_tokens(xt[r:r + 2], xp[r:r + 2]) for r in range(0, 16, 2)]
    for got, want in zip((zt, zp), zip(*shard_rows)):
        np.testing.assert_array_equal(got, torch.cat(want).numpy()[:N])
    for got, want in zip((zt, zp), sweep.Stage1SweepRunner(engine, device_batch=16).run(x_t, x_p)):
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    distinct = sweep.Stage1SweepRunner(engine, _cpu_mesh(4, 2, distinct=True),
                                       device_batch=16).run(x_t, x_p)
    for got, want in zip(distinct, (zt, zp)):
        np.testing.assert_array_equal(got, want)


# --- serving on the mesh -------------------------------------------------------------

def _pipeline(root, mesh=None, rows=4, **s3_kwargs):
    from biom3_tpu_torch.config import load_json_config as load
    from biom3_tpu_torch.pipeline.stage1 import PenCLEngine
    from biom3_tpu_torch.pipeline.stage2 import FacilitatorEngine
    from biom3_tpu_torch.serving import ServingPipeline

    s1 = PenCLEngine(load(root / "s1.json"), str(root / "s1.bin"), device="cpu", text_only=True,
                     use_stack=True)
    s2 = FacilitatorEngine(load(root / "s2.json"), str(root / "s2.bin"), device="cpu")
    s3 = ProteoScribeEngine(load(root / "s3.json"), str(root / "s3.bin"), device="cpu",
                            use_stack=True, **s3_kwargs)
    return ServingPipeline(s1, s2, s3, rows_per_dispatch=rows, default_replicas=2, seed=0,
                           mesh=mesh)


def test_mesh_pipeline_packed_paths_equal_one_device(stage_files):
    """``test_serving_pipeline_mesh_backend``: (dp 4, fsdp 2), 8-row
    dispatches; 5 rows of two requests in one sharded dispatch, and two
    inpaint replicas keeping the template, each equal to the one-device
    pipeline's (temperature 1, seeded); rows_per_dispatch 6 on 4 shards
    raises JAX's message."""
    root = stage_files[0]
    reqs = [{"prompt": PROMPT, "seed": 3},
            {"prompt": "kinase with atp binding", "num_replicas": 3, "seed": 4}]
    inp = [{"prompt": "zinc finger domain", "sequence": "MK??ACDE??", "num_replicas": 2,
            "seed": 8}]
    mesh_pipe = _pipeline(root, _cpu_mesh(4, 2), rows=8, temperature=1.0, chunk_steps=32)
    one_pipe = _pipeline(root, rows=8, temperature=1.0, chunk_steps=32)
    out = mesh_pipe.generate(reqs)
    assert [len(r["sequences"]) for r in out] == [2, 3]
    assert all(_valid(s) for r in out for s in r["sequences"])
    assert out == one_pipe.generate(reqs)
    assert mesh_pipe.device_stats() == {"dispatches": 1, "rows_live": 5, "rows_padded": 3,
                                        "row_occupancy": 0.625}
    filled = mesh_pipe.inpaint(inp)
    assert filled == one_pipe.inpaint(inp)
    for s in filled[0]["sequences"]:
        assert "?" not in s and is_subsequence("MKACDE", s), s
    with pytest.raises(ValueError, match="multiple of the mesh's dp\\*fsdp=4"):
        _pipeline(root, _cpu_mesh(2, 2), rows=6)


def test_mesh_continuous_and_trajectory_schedulers_match_jax(stage_files, monkeypatch):
    """``test_continuous_batcher_sharded_mesh_backend``: the continuous
    scheduler (exact mode) and the trajectory scheduler (k = 8) on (dp 2,
    fsdp 2) give a seeded request's sequences equal to the JAX schedulers'
    at temperature 0 (one device; the JAX trajectory scheduler's paths
    handed the port's per-row orders, as ``tests/test_torch_serving.py``)."""
    import biom3_tpu.pipeline.stage3 as jax_stage3
    from biom3_tpu.config import load_json_config
    from biom3_tpu.serving import ContinuousGenerateBatcher as JaxContinuous
    from biom3_tpu.serving import ServingPipeline as JaxPipeline
    from biom3_tpu.serving import TrajectoryBatcher as JaxTrajectory
    from biom3_tpu_torch.serving import ContinuousGenerateBatcher, TrajectoryBatcher
    from biom3_tpu_torch.serving.continuous import row_streams

    root, (j1, j2, j3), _ = stage_files
    L, seed, n_rep, R = 64, 9, 2, 4
    req = {"prompt": PROMPT, "num_replicas": n_rep, "seed": seed}
    invs = [row_streams(None, seed, rep, L)[0] for rep in range(n_rep)]
    paths = np.stack([np.argsort(invs[min(i, n_rep - 1)]) for i in range(R)]).astype(np.int32)
    monkeypatch.setattr(jax_stage3, "sample_permutations",
                        lambda key, batch, length: jnp.asarray(paths[:batch]))
    j3k8 = JaxEngine(load_json_config(root / "s3.json"), str(root / "s3.bin"), temperature=0.0,
                     positions_per_step=8, chunk_steps=8)
    runs = ((JaxContinuous, j3, ContinuousGenerateBatcher, {}),
            (JaxTrajectory, j3k8, TrajectoryBatcher, dict(positions_per_step=8, chunk_steps=8)))
    for jax_cls, jax_s3, port_cls, kw in runs:
        jax_batcher = jax_cls(JaxPipeline(j1, j2, jax_s3, rows_per_dispatch=R,
                                          default_replicas=2, seed=0))
        port_batcher = port_cls(_pipeline(root, _cpu_mesh(2, 2), rows=R, temperature=0.0, **kw))
        try:
            want = jax_batcher.submit(dict(req)).result(timeout=300)["sequences"]
            got = port_batcher.submit(dict(req)).result(timeout=120)["sequences"]
        finally:
            jax_batcher.close()
            port_batcher.close()
        assert got == want and all(_valid(s) and s for s in got), port_cls.__name__


def test_run_server_mesh_flags_answer_like_jax(stage_files):
    """``run_server --device cpu --mesh_fsdp 2 --continuous_inpaint``
    (positions on the CPU, the f32 module copied per position) in process:
    a seeded request at temperature 0 answers with the JAX continuous
    scheduler's sequences, and /v1/inpaint keeps the template."""
    from biom3_tpu.serving import ContinuousGenerateBatcher as JaxContinuous
    from biom3_tpu.serving import ServingPipeline as JaxPipeline
    from biom3_tpu_torch.cli import run_server
    from test_torch_serving import _get, _post

    root, (j1, j2, j3), flags = stage_files
    req = {"prompt": PROMPT, "num_replicas": 2, "seed": 5}
    args = run_server.parse_arguments(flags + ["--device", "cpu", "--mesh_fsdp", "2",
                                               "--continuous_inpaint", "--temperature", "0",
                                               "--rows_per_dispatch", "4", "--port", "0"])
    server = run_server.build_server(args)
    assert server.pipeline._mesh.shape == {"dp": 1, "fsdp": 2, "tp": 1}
    server.start()
    base = f"http://{server.host}:{server.port}"
    try:
        assert _get(f"{base}/healthz")["continuous_inpaint"] is True
        got = _post(f"{base}/v1/generate", req)["results"][0]["sequences"]
        filled = _post(f"{base}/v1/inpaint", {"prompt": PROMPT, "sequence": "MK??ACDE??",
                                              "num_replicas": 2})["results"][0]["sequences"]
    finally:
        server.close()
    jax_batcher = JaxContinuous(JaxPipeline(j1, j2, j3, rows_per_dispatch=4, default_replicas=2,
                                            seed=0))
    try:
        want = jax_batcher.submit(dict(req)).result(timeout=300)["sequences"]
    finally:
        jax_batcher.close()
    assert got == want and all(_valid(s) and s for s in got)
    assert len(filled) == 2 and all("?" not in s and is_subsequence("MKACDE", s) for s in filled)

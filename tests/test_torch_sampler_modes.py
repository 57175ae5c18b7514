"""The fast decode modes of biom3_tpu_torch against the JAX package, on the
CPU in f32: confidence order, MaskGIT (with and without an ``x0`` resume)
and the legacy batched-update replay, the full-grid stack forward and its
head, the engine's serving contracts and the Stage-2/3 sample CLIs.

A tiny ProteoScribe (L=32, depth 2) is initialised by Flax with a fixed
key, its parameters perturbed from a numpy seed and carried to the port
through ``io/from_jax.py``.  At temperature 0 every mode but path order
is RNG-free, so ids must be equal to the JAX samplers'.  At temperature >
0 the port draws from a ``torch.Generator`` or per-row Philox streams,
not JAX's bits: the tests check the schedule, the committed positions, the
draw's distribution (chi-square) and per-row reproducibility.  Logits
compare at atol 2e-4 / rtol 1e-3 (f32, different summation orders).
"""

import json
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from biom3_tpu.config import ProteoScribeConfig
from biom3_tpu.diffusion.sampler import (
    make_maskgit_sampler as jax_make_maskgit_sampler,
    make_sampler as jax_make_sampler,
)
from biom3_tpu.models.fused_forward import make_stack_apply as jax_make_stack_apply
from biom3_tpu.models.proteoscribe import ProteoScribe as JaxProteoScribe
from biom3_tpu_torch.diffusion.sampler import (
    make_maskgit_sampler,
    make_sampler,
    maskgit_schedule,
)
from biom3_tpu_torch.io.from_jax import port_config, proteoscribe_from_jax
from biom3_tpu_torch.models.fused_forward import make_stack_apply

SMALL = ProteoScribeConfig(
    num_classes=29, dim=32, depth=2, n_blocks=1, heads=4, local_heads=2,
    local_window=8, max_seq_len=32, num_timesteps=32, cond_dim=16,
)
L, C = SMALL.max_seq_len, SMALL.num_classes
TOL = dict(atol=2e-4, rtol=1e-3)
CHI2_28_P001 = 56.89   # chi-square, 28 degrees of freedom, upper 0.1 % point


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def models():
    """Flax ProteoScribe at SMALL with perturbed params, its port, z_c."""
    rng = np.random.default_rng(0)
    model = JaxProteoScribe(SMALL)
    variables = model.init(jax.random.key(0), jnp.zeros((1, L), jnp.int32),
                           jnp.zeros((1,), jnp.int32), jnp.zeros((1, SMALL.cond_dim)))
    variables = jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32), variables)
    z = (rng.standard_normal((3, SMALL.cond_dim))).astype(np.float32)
    return model, variables, proteoscribe_from_jax(variables, port_config(SMALL)), z


def _port_forward(port, forward):
    """(apply_fn, apply_takes_positions) of the module or the stack."""
    if forward == "stack":
        return make_stack_apply(port, dtype=torch.float32, gelu="erf"), True
    return port, False


# --- temperature 0: ids equal to the JAX samplers' ---------------------------

@pytest.mark.parametrize("k", [1, 4])
@pytest.mark.parametrize("forward", ["module", "stack"])
def test_confidence_temp0_ids_equal_jax(models, k, forward):
    model, variables, port, z = models
    B = 2
    paths = np.stack([np.random.default_rng(5 + b).permutation(L) for b in range(B)])
    jax_sample = jax_make_sampler(model.apply, SMALL.num_timesteps, temperature=0.0,
                                  positions_per_step=k, order="confidence")
    want = np.asarray(jax_sample(variables, jnp.asarray(z[:B]),
                                 jnp.asarray(paths, jnp.int32), jax.random.key(0)))
    apply, takes = _port_forward(port, forward)
    sample = make_sampler(apply, SMALL.num_timesteps, temperature=0.0, positions_per_step=k,
                          order="confidence", apply_takes_positions=takes)
    got = sample(_t(z[:B]), _t(paths.astype(np.int32))).numpy()
    np.testing.assert_array_equal(got, want)
    assert (got != 0).any()


@pytest.mark.parametrize("steps", [1, 4, L])
@pytest.mark.parametrize("resume", [False, True])
def test_maskgit_temp0_ids_equal_jax(models, steps, resume):
    """The JAX MaskGIT sampler on the Flax graph against the port's on the
    stack forward's plain versions at gather_k = L."""
    model, variables, port, z = models
    B = 2
    x0 = None
    if resume:
        rng = np.random.default_rng(9)
        x0 = np.where(rng.random((B, L)) < 0.3, rng.integers(1, C, (B, L)), 0).astype(np.int32)
    jax_sample = jax_make_maskgit_sampler(model.apply, L, steps=steps, temperature=0.0)
    want = np.asarray(jax_sample(variables, jnp.asarray(z[:B]), None, None,
                                 x0=None if x0 is None else jnp.asarray(x0)))
    apply, takes = _port_forward(port, "stack")
    sample = make_maskgit_sampler(apply, L, steps=steps, temperature=0.0,
                                  apply_takes_positions=takes)
    got = sample(_t(z[:B]), x0=None if x0 is None else _t(x0)).numpy()
    np.testing.assert_array_equal(got, want)
    if resume:
        np.testing.assert_array_equal(got[x0 != 0], x0[x0 != 0])


def test_legacy_replay_temp0_ids_equal_jax(models):
    """Q5's union-over-batch write on injected paths: the full logit grid of
    the module on both sides."""
    model, variables, port, z = models
    B = 3
    paths = np.stack([np.random.default_rng(20 + b).permutation(L)
                      for b in range(B)]).astype(np.int32)
    jax_sample = jax_make_sampler(model.apply, SMALL.num_timesteps, temperature=0.0,
                                  legacy_batch_update=True)
    want = np.asarray(jax_sample(variables, jnp.asarray(z), jnp.asarray(paths),
                                 jax.random.key(0)))
    sample = make_sampler(port, SMALL.num_timesteps, temperature=0.0, legacy_batch_update=True)
    got = sample(_t(z), _t(paths)).numpy()
    np.testing.assert_array_equal(got, want)


def _fixed_logits(B, seed=3, scale=2.0):
    """(B, L, C) logits with class 0 (the absorbing state) never chosen, so
    a committed position is never 0."""
    lg = np.random.default_rng(seed).standard_normal((B, L, C)).astype(np.float32) * scale
    lg[..., 0] = -1e9
    return lg


@pytest.mark.parametrize("order", ["path", "confidence"])
def test_return_trajectory_writes_k_positions_a_step(order):
    """Each outer step writes exactly k new positions; the trajectory equals
    the JAX sampler's on the same fixed logits."""
    B, k = 2, 4
    lg = _fixed_logits(B)
    paths = np.stack([np.random.default_rng(30 + b).permutation(L)
                      for b in range(B)]).astype(np.int32)
    jax_sample = jax_make_sampler(lambda p, x, t, zc: jnp.asarray(lg), L, temperature=0.0,
                                  positions_per_step=k, order=order, return_trajectory=True)
    _, want = jax_sample(None, jnp.zeros((B, 1)), jnp.asarray(paths), jax.random.key(0))
    sample = make_sampler(lambda x, t, zc: _t(lg), L, temperature=0.0, positions_per_step=k,
                          order=order, return_trajectory=True)
    x, traj = sample(torch.zeros(B, 1), _t(paths))
    assert tuple(traj.shape) == (L // k, B, L)
    np.testing.assert_array_equal(traj.numpy(), np.asarray(want))
    filled = (traj != 0).sum(-1)
    assert (filled == torch.arange(1, L // k + 1)[:, None] * k).all()
    assert torch.equal(traj[-1], x)


# --- temperature > 0 --------------------------------------------------------

def test_maskgit_schedule_and_x0_at_temperature(models):
    """After step s every row holds exactly L − m_s committed positions, the
    model sees that count as its timestep, and x0's positions never
    change."""
    B, steps = 4, 6
    lg = _fixed_logits(B)
    seen = []

    def apply(x, t, zc, pos):
        seen.append(((x != 0).sum(1).clone(), t.clone()))
        return _t(lg)

    rng = np.random.default_rng(4)
    x0 = np.where(rng.random((B, L)) < 0.25, rng.integers(1, C, (B, L)), 0).astype(np.int32)
    x0[0] = 0                                  # one row generates from scratch
    sample = make_maskgit_sampler(apply, L, steps=steps, temperature=1.0,
                                  apply_takes_positions=True)
    out = sample(torch.zeros(B, 1), x0=_t(x0), generator=torch.Generator().manual_seed(1))
    m = maskgit_schedule(L, steps)
    assert m == sorted(m, reverse=True) and len(set(m)) == steps and m[-1] == 0
    for s in range(1, steps):
        committed, t = seen[s]
        want = np.maximum(L - m[s - 1], (x0 != 0).sum(1))
        np.testing.assert_array_equal(committed.numpy(), want)
        np.testing.assert_array_equal(t.numpy(), np.minimum(want, L - 1))
    assert bool((out != 0).all())
    np.testing.assert_array_equal(out.numpy()[x0 != 0], x0[x0 != 0])


@pytest.mark.parametrize("mode", ["maskgit", "maskgit_rows", "confidence"])
def test_token_frequencies_follow_softmax(mode):
    """Every position's logits fixed to one row lg: one step draws all
    positions from softmax(lg / T); 2048 draws against it by chi-square
    (28 degrees of freedom, bound at its upper 0.1 % point)."""
    B, T = 64, 0.8
    lg = np.random.default_rng(12).standard_normal(C).astype(np.float32)
    grid = _t(np.broadcast_to(lg, (B, L, C)).copy())
    apply = lambda x, t, zc, pos: grid
    if mode == "confidence":
        sample = make_sampler(apply, L, temperature=T, positions_per_step=L, order="confidence",
                              apply_takes_positions=True)
        ids = sample(torch.zeros(B, 1), torch.zeros(B, L, dtype=torch.int32),
                     torch.Generator().manual_seed(2))
    else:
        sample = make_maskgit_sampler(apply, L, steps=1, temperature=T,
                                      apply_takes_positions=True)
        if mode == "maskgit":
            ids = sample(torch.zeros(B, 1), generator=torch.Generator().manual_seed(2))
        else:
            kd = torch.randint(0, 2 ** 32, (B, 2), generator=torch.Generator().manual_seed(2))
            ids = sample(torch.zeros(B, 1), key_data=kd)
    counts = np.bincount(ids.numpy().ravel(), minlength=C)
    p = np.exp(lg / T - (lg / T).max())
    expect = p / p.sum() * counts.sum()
    chi2 = float(((counts - expect) ** 2 / expect).sum())
    assert chi2 < CHI2_28_P001, (chi2, counts)


# --- the full-grid stack forward and its head --------------------------------

def test_stack_full_grid_matches_jax(models):
    """The stack forward at gather_k = L — every position to the head —
    against the JAX stack kernel in interpret mode."""
    _, variables, port, z = models
    rng = np.random.default_rng(6)
    B = 2
    x = rng.integers(0, C, (B, L)).astype(np.int32)
    t = rng.integers(0, SMALL.num_timesteps, (B,)).astype(np.int32)
    pos = np.broadcast_to(np.arange(L, dtype=np.int32), (B, L)).copy()
    jax_apply = jax_make_stack_apply(SMALL, dtype=jnp.float32, resident=False, interpret=True,
                                     gather_k=L)
    want = np.asarray(jax_apply(variables, jnp.asarray(x), jnp.asarray(t),
                                jnp.asarray(z[:B]), jnp.asarray(pos)))
    got = make_stack_apply(port, dtype=torch.float32, gelu="erf")(
        _t(x), _t(t), _t(z[:B]), _t(pos)).numpy()
    assert got.shape == (B, L, C)
    np.testing.assert_allclose(got, want, **TOL)


def test_gather_head_plain_full_grid_matches_jax_head(models):
    """``gather_head_plain`` at k = L, on the head packed by ``pad_head``,
    against the JAX head epilogue (final LayerNorm + head)."""
    from biom3_tpu.models import fused_forward as jff

    from biom3_tpu_torch.ops.kernels import gather_head, pad_head

    _, variables, port, _ = models
    rng = np.random.default_rng(8)
    B = 3
    h = (rng.standard_normal((B, L, SMALL.dim)) * 2.0).astype(np.float32)
    want = np.asarray(jff.final_head(SMALL, variables["params"], jnp.asarray(h)))
    core = port.transformer
    w = core.out.weight.detach().t().contiguous()
    pos = torch.arange(L, dtype=torch.int32).expand(B, L).contiguous()
    with torch.no_grad():
        args = (core.norm.weight.detach(), core.norm.bias.detach())
        got = gather_head(_t(h), pos, *args, pad_head(w), core.out.bias.detach())
        unpadded = gather_head(_t(h), pos, *args, w, core.out.bias.detach())
    assert pad_head(w).shape == (SMALL.dim, 32)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    torch.testing.assert_close(got, unpadded, rtol=0, atol=0)


# --- the engine's contracts ---------------------------------------------------

def _engine(**kw):
    from biom3_tpu_torch.config import Config
    from biom3_tpu_torch.pipeline.stage3 import ProteoScribeEngine

    cfg = Config({"diffusion_steps": 32, "num_classes": 29, "text_emb_dim": 16,
                  "transformer_dim": 32, "transformer_heads": 4, "transformer_depth": 2,
                  "transformer_blocks": 1, "transformer_local_heads": 2,
                  "transformer_local_size": 8})
    return ProteoScribeEngine(cfg, device="cpu", **{"use_stack": True, **kw})


@pytest.mark.parametrize("mode", [dict(sampler_mode="maskgit", maskgit_steps=4),
                                  dict(decode_order="confidence", positions_per_step=4)])
def test_trajectory_row_fn_seeded_row_in_any_batch(mode):
    """A row's ids depend on its key words alone: the same row in two batch
    mixes decodes the same, and another key decodes otherwise."""
    eng = _engine(temperature=1.0, **mode)
    assert eng.gather_k == 32 and not eng.supports_continuous_stepping()
    row_fn = eng.make_trajectory_row_fn()
    rng = np.random.default_rng(3)
    zc = rng.standard_normal((3, 16)).astype(np.float32)
    inv = np.stack([rng.permutation(32) for _ in range(3)]).astype(np.int32)
    kd = np.array([[11, 12], [21, 22], [31, 32]], np.uint32)
    a = row_fn(zc[[0, 1]], inv[[0, 1]], kd[[0, 1]]).numpy()
    b = row_fn(zc[[2, 0]], inv[[2, 2]], kd[[2, 0]]).numpy()
    np.testing.assert_array_equal(a[0], b[1])
    c = row_fn(zc[[0]], inv[[0]], np.array([[5, 6]], np.uint32)).numpy()
    assert (c[0] != a[0]).any()


@pytest.mark.parametrize("mode", [dict(), dict(sampler_mode="maskgit"),
                                  dict(decode_order="confidence"),
                                  dict(legacy_batch_update=True, use_stack=False)])
def test_continuous_stepping_only_for_exact_path_order(mode):
    """JAX ``supports_continuous_stepping``: exact path-order ARDM alone; the
    continuous scheduler's stepper refuses the others with JAX's message."""
    eng = _engine(**mode)
    exact = not mode
    assert eng.supports_continuous_stepping() is exact
    if exact:
        eng.make_continuous_stepper()
    else:
        with pytest.raises(ValueError, match="continuous stepping needs exact path-order ARDM"):
            eng.make_continuous_stepper()


def test_engine_refuses_what_jax_refuses():
    with pytest.raises(ValueError, match="incompatible with maskgit"):
        _engine(sampler_mode="maskgit", legacy_batch_update=True)
    with pytest.raises(ValueError, match="confidence"):
        _engine(decode_order="confidence", legacy_batch_update=True, use_stack=False)
    with pytest.raises(ValueError, match="full logit grid"):
        _engine(legacy_batch_update=True)
    with pytest.raises(ValueError, match="steps must be in"):
        _engine(sampler_mode="maskgit", maskgit_steps=33)


# --- the Stage-2 and Stage-3 sample CLIs against the JAX CLIs ----------------

@pytest.fixture(scope="module")
def cli_files(tmp_path_factory, models):
    """Stage-2/3 configs built here, the JAX engines' seeded weights
    exported to reference-layout .bin files, and a z_t / z_p / z_c input."""
    from biom3_tpu.config import load_json_config
    from biom3_tpu.io.export import facilitator_params_to_torch, proteoscribe_params_to_torch
    from biom3_tpu.io.torch_load import save_torch_file
    from biom3_tpu.pipeline.stage2 import FacilitatorEngine
    from biom3_tpu.pipeline.stage3 import ProteoScribeEngine

    root = tmp_path_factory.mktemp("sample_clis")
    (root / "s2.json").write_text(json.dumps({"emb_dim": 16, "hid_dim": 32, "dropout": 0.0}))
    (root / "s3.json").write_text(json.dumps({
        "num_replicas": 2, "batch_size_sample": 2, "diffusion_steps": 32, "num_classes": 29,
        "text_emb_dim": 16, "transformer_dim": 32, "transformer_heads": 4,
        "transformer_depth": 2, "transformer_blocks": 1, "transformer_local_heads": 2,
        "transformer_local_size": 8}))
    s2 = FacilitatorEngine(load_json_config(root / "s2.json"))
    s3 = ProteoScribeEngine(load_json_config(root / "s3.json"))
    save_torch_file(facilitator_params_to_torch(s2.params, s2.config), root / "s2.bin")
    save_torch_file(proteoscribe_params_to_torch(s3.params, s3.config), root / "s3.bin")
    rng = np.random.default_rng(1)
    data = {"z_t": rng.standard_normal((3, 16)).astype(np.float32),
            "z_p": rng.standard_normal((3, 16)).astype(np.float32),
            "z_c": rng.standard_normal((2, 16)).astype(np.float32)}
    torch.save({k: torch.from_numpy(v) for k, v in data.items()}, root / "in.pt")
    return root


def _run_jax_cli(module, argv, monkeypatch):
    monkeypatch.setattr(sys, "argv", ["prog", *argv])
    module.main()


def test_run_facilitator_sample_equals_jax_cli(cli_files, monkeypatch, capsys):
    from biom3_tpu.cli import run_facilitator_sample as jax_cli
    from biom3_tpu_torch.cli import run_facilitator_sample

    root = cli_files
    args = ["--input_data_path", str(root / "in.pt"), "--model_path", str(root / "s2.bin"),
            "--json_path", str(root / "s2.json")]
    _run_jax_cli(jax_cli, [*args, "--output_data_path", str(root / "f_jax.pt")], monkeypatch)
    want_text = capsys.readouterr().out
    run_facilitator_sample.main([*args, "--output_data_path", str(root / "f_port.pt"),
                                 "--device", "cpu"])
    got_text = capsys.readouterr().out
    want, got = (torch.load(root / f, weights_only=False) for f in ("f_jax.pt", "f_port.pt"))
    assert set(got) == set(want)
    np.testing.assert_allclose(np.asarray(got["z_c"]), np.asarray(want["z_c"]), atol=1e-5)
    nums = lambda text: [float(w) for line in text.splitlines() if ": " in line
                         for w in [line.rsplit(": ", 1)[1]] if w.replace(".", "").isdigit()]
    assert len(nums(got_text)) == 7
    np.testing.assert_allclose(nums(got_text), nums(want_text), atol=2e-6)
    shapes = lambda text: [line for line in text.splitlines() if line.startswith("Shape of")]
    assert shapes(got_text) == shapes(want_text) and len(shapes(got_text)) == 3


@pytest.mark.parametrize("flags", [["--sampler", "maskgit", "--maskgit-steps", "4"],
                                   ["--decode-order", "confidence", "--positions-per-step", "4"]])
def test_run_proteoscribe_sample_equals_jax_cli(cli_files, monkeypatch, capsys, flags):
    """Temperature 0 in the RNG-free modes: the same designs as the JAX CLI
    (f32 on both sides: the Flax graph, the port's module)."""
    from biom3_tpu.cli import run_proteoscribe_sample as jax_cli
    from biom3_tpu_torch.cli import run_proteoscribe_sample

    root = cli_files
    args = ["--json_path", str(root / "s3.json"), "--model_path", str(root / "s3.bin"),
            "--input_path", str(root / "in.pt"), "--temperature", "0", *flags]
    _run_jax_cli(jax_cli, [*args, "--output_path", str(root / "p_jax.pt")], monkeypatch)
    capsys.readouterr()
    run_proteoscribe_sample.main([*args, "--output_path", str(root / "p_port.pt"),
                                  "--device", "cpu"])
    out = capsys.readouterr().out
    assert "design_sequence_dict=" in out and "Generated sequences saved to" in out
    want, got = (torch.load(root / f, weights_only=False) for f in ("p_jax.pt", "p_port.pt"))
    assert got == want and set(got) == {"replica_0", "replica_1"}


@pytest.mark.parametrize("flags", [["--legacy-batch-update"],
                                   ["--top-k", "5", "--top-p", "0.9", "--dtype", "f32"]])
def test_run_proteoscribe_sample_takes_the_other_flags(cli_files, capsys, flags):
    """Path order at temperature 1: valid designs, two replicas of two
    prompts, and the same file for the same seed."""
    from biom3_tpu_torch.cli import run_proteoscribe_sample

    root = cli_files
    outs = []
    for i in range(2):
        run_proteoscribe_sample.main([
            "--json_path", str(root / "s3.json"), "--model_path", str(root / "s3.bin"),
            "--input_path", str(root / "in.pt"), "--output_path", str(root / f"o{i}.pt"),
            "--device", "cpu", "--seed", "3", *flags])
        outs.append(torch.load(root / f"o{i}.pt", weights_only=False))
    capsys.readouterr()
    assert outs[0] == outs[1]
    assert {k: len(v) for k, v in outs[0].items()} == {"replica_0": 2, "replica_1": 2}
    for seqs in outs[0].values():
        for s in seqs:
            assert isinstance(s, str) and "<START>" not in s and "<PAD>" not in s

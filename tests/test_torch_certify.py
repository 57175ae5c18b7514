"""The port's sampler-quality certification tools against the JAX
package's (CPU, f32).

``biom3_tpu_torch/tools/certify_task.py`` keeps copies of the JAX tools'
numpy pieces (``MODES``, the batch maker's draws, ``coherence_stats``;
``certify_inpaint.restore_stats``): each is held equal to its original in
``tools/``.  The trainer's state file round-trips and refuses a stale
key.  At a small config (depth 2, dim 64, heads 2 with 1 band-local, L =
32, window 16) one train step of the tools' trainer equals JAX's
``make_stage3_train_step`` on the same parameters, batch, paths and
timesteps; on JAX-trained parameters carried across, ``certify_int8``'s
bf16 and int8-ff+proj rows equal JAX's (the stack forward's plain versions
against JAX ``make_stack_apply(interpret=True)`` in f32: equal temp-0 ids,
coherence, class accuracy and exact-match fraction, the logit probe's min
cosine within 1e-4), and one ``certify_blocked`` cell (k = 2, temperature
0) and one ``certify_inpaint`` cell (``inpaint-confidence``, fraction 0.5,
temperature 0) give JAX's ids.
"""

import inspect
import pathlib
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from biom3_tpu.config import ProteoScribeConfig
from biom3_tpu.diffusion.inpainting import corrupt_samples as jax_corrupt_samples
from biom3_tpu.diffusion.inpainting import make_inpainter as jax_make_inpainter
from biom3_tpu.diffusion.oa_ardm import sample_random_paths, sample_timesteps
from biom3_tpu.diffusion.sampler import make_sampler as jax_make_sampler
from biom3_tpu.models.fused_forward import make_stack_apply as jax_make_stack_apply
from biom3_tpu.models.proteoscribe import ProteoScribe as JaxProteoScribe
from biom3_tpu.training.optim import make_optimizer as jax_make_optimizer
from biom3_tpu.training.stage3_task import make_stage3_train_step as jax_train_step
from biom3_tpu.training.state import TrainState as JaxTrainState
from biom3_tpu_torch.diffusion.inpainting import make_inpainter
from biom3_tpu_torch.io.from_jax import port_config, proteoscribe_params_to_torch
from biom3_tpu_torch.models.proteoscribe import ProteoScribe
from biom3_tpu_torch.tools import certify_blocked, certify_inpaint, certify_int8, certify_task

TOOLS = pathlib.Path(__file__).resolve().parents[1] / "tools"
sys.path.insert(0, str(TOOLS))
import certify_inpaint as jax_certify_inpaint  # noqa: E402
import certify_task as jax_certify_task  # noqa: E402

SMALL = ProteoScribeConfig(num_classes=29, dim=64, depth=2, n_blocks=1, heads=2, local_heads=1,
                           local_window=16, max_seq_len=32, num_timesteps=32, cond_dim=32)
L = SMALL.max_seq_len
B = 8               # sample batch of the certify rows, and the training batch
TRAIN_STEPS = 60    # JAX steps on the copy task before the rows


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small ops, which stall in the thread
    pool's barriers when the suite's workers share the cores."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jax_batch(rng, n):
    tokens, z_c, cls = jax_certify_task.make_batch(rng, n, L, SMALL.cond_dim)
    return {"tokens": tokens, "z_c": z_c}, cls


@pytest.fixture(scope="module")
def jax_toy():
    """The Flax module at SMALL, its initial parameters, the tools'
    optimizer (AdamW 1e-3, weight decay 1e-6) and JAX's jitted step."""
    model = JaxProteoScribe(SMALL)
    tx = jax_make_optimizer("AdamW", 1e-3, weight_decay=1e-6)
    params = model.init(jax.random.key(0), jnp.zeros((1, L), jnp.int32),
                        jnp.zeros((1,), jnp.int32), jnp.zeros((1, SMALL.cond_dim)))
    return model, params, tx, jax.jit(jax_train_step(model.apply, tx))


@pytest.fixture(scope="module")
def trained(jax_toy):
    """SMALL trained by JAX's step on the copy task → (Flax module, params,
    port module in f32 with torch attention)."""
    model, params, tx, step = jax_toy
    state = JaxTrainState.create(params, tx)
    rng = np.random.default_rng(0)
    for i in range(TRAIN_STEPS):
        state, _ = step(state, _jax_batch(rng, B)[0], jax.random.key(1000 + i))
    port = certify_task.serving_model(port_config(SMALL), _port_params(state.params),
                                      torch.device("cpu"))
    return model, state.params, port


def _port_params(params) -> dict:
    return {k: torch.from_numpy(np.array(v, np.float32))
            for k, v in proteoscribe_params_to_torch(params, SMALL).items()}


def _inputs():
    """The tools' sample inputs: z_c and classes from numpy seed 7, a path."""
    _, z_c, cls = certify_task.make_batch(np.random.default_rng(7), B, L, SMALL.cond_dim)
    path = np.stack([np.random.default_rng(42 + b).permutation(L) for b in range(B)])
    return z_c, cls, path.astype(np.int32)


# --- the copies --------------------------------------------------------------

def test_copies_equal_the_jax_tools():
    np.testing.assert_array_equal(certify_task.MODES, jax_certify_task.MODES)
    for mine, theirs in ((certify_task.coherence_stats, jax_certify_task.coherence_stats),
                         (certify_inpaint.restore_stats, jax_certify_inpaint.restore_stats)):
        assert inspect.getsource(mine) == inspect.getsource(theirs), mine.__name__
    for seed in range(3):
        tokens, z_c, cls = certify_task.batch_arrays(np.random.default_rng(seed), 6, L, 8)
        jt, jz, jcls = jax_certify_task.make_batch(np.random.default_rng(seed), 6, L, 8)
        np.testing.assert_array_equal(tokens, np.asarray(jt))
        np.testing.assert_array_equal(z_c, np.asarray(jz))
        np.testing.assert_array_equal(cls, jcls)
    rng = np.random.default_rng(1)
    seqs = rng.integers(0, 29, (10, L))
    seqs[:4] = 7
    cls = rng.integers(0, 2, 10)
    got, want = certify_task.coherence_stats(seqs, cls), jax_certify_task.coherence_stats(seqs,
                                                                                          cls)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    masked = np.where(rng.random((10, L)) < 0.5, seqs, 0)
    out = np.where(masked == 0, rng.integers(0, 29, (10, L)), masked)
    assert certify_inpaint.restore_stats(out, seqs, masked) == \
        jax_certify_inpaint.restore_stats(out, seqs, masked)


def test_state_file_roundtrip(tmp_path):
    """The trained parameters go to a torch file (parent made) and load
    back; a different training key refuses the stale file."""
    path = str(tmp_path / "fresh_dir" / "toy.pt")
    cfg, trained, losses = certify_task.build_and_train(2, 2, L, chunk=2, state_path=path,
                                                        device="cpu")
    assert cfg.heads == 4 and cfg.dim // cfg.heads == 32 and len(losses) == 1
    cfg2, loaded, again = certify_task.build_and_train(2, 2, L, chunk=2, state_path=path,
                                                       device="cpu")
    assert cfg2 == cfg and again == []
    for (k, a), (k2, b) in zip(trained.state_dict().items(), loaded.state_dict().items()):
        assert k == k2
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="was trained with"):
        certify_task.build_and_train(4, 2, L, chunk=2, state_path=path, device="cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            certify_task.build_and_train(2, 2, L)


# --- against the JAX package -----------------------------------------------------

def test_train_step_matches_jax(jax_toy):
    """One step of the tools' trainer (AdamW, ``layer_block`` on the
    kernels' plain versions) against JAX's on the same parameters, batch,
    paths and timesteps."""
    _, params, tx, jax_step = jax_toy
    batch, _ = _jax_batch(np.random.default_rng(3), B)
    key = jax.random.key(5)
    new, aux = jax_step(JaxTrainState.create(params, tx), batch, key)
    k_path, k_t, _ = jax.random.split(key, 3)
    path = np.asarray(sample_random_paths(k_path, B, L))
    t = np.asarray(sample_timesteps(k_t, B, L))

    port = ProteoScribe(port_config(SMALL), attn_impl="layer-block")
    port.load_state_dict(_port_params(params))
    _, step = certify_task.make_trainer(port)
    got = step({"tokens": torch.from_numpy(np.array(batch["tokens"])).long(),
                "z_c": torch.from_numpy(np.array(batch["z_c"]))},
               path=torch.tensor(path).long(), t=torch.tensor(t).long())
    np.testing.assert_allclose(float(got["loss"]), float(aux["loss"]), rtol=1e-5)
    # AdamW's first step moves each parameter by lr·g/(|g| + eps): where |g|
    # is within ~100 eps of 0 the gradients' last bits move that update by
    # up to lr, so those elements (|JAX's update| < 0.99 lr, a small share)
    # are left out; every other one within 1e-5 of the model's largest
    # parameter
    before, want = _port_params(params), _port_params(new.params)
    scale = max(float(w.abs().max()) for w in want.values())
    resolved = total = 0
    for name, p in port.state_dict().items():
        keep = (want[name] - before[name]).abs() >= 0.99 * 1e-3
        resolved, total = resolved + int(keep.sum()), total + keep.numel()
        assert float(torch.where(keep, p - want[name], 0).abs().max()) <= 1e-5 * scale, name
    assert resolved >= 0.9 * total


def _jax_int8_rows(model, params, z_c, cls, path, modes):
    """JAX ``tools/certify_int8.py``'s row loop on ``params`` (its stack
    forward in interpret mode, f32) → (rows, {mode: ids})."""
    x, t, pos = (jnp.asarray(a) for a in certify_int8.probe_inputs(B, L, SMALL.num_timesteps))
    rows, ids, ref = [], {}, None
    for name in modes:
        ffq, pq = certify_int8.QUANT[name]
        apply_fn = jax_make_stack_apply(SMALL, gelu="erf", resident=True, ff_quant=ffq,
                                        proj_quant=pq, interpret=True, dtype=jnp.float32)
        logits = np.asarray(jax.jit(apply_fn)(params, x, t, jnp.asarray(z_c), pos), np.float32)
        sampler = jax_make_sampler(apply_fn, SMALL.num_timesteps, temperature=0.0,
                                   chunk_steps=None, apply_takes_positions=True)
        seqs = ids[name] = np.asarray(sampler(params, jnp.asarray(z_c), jnp.asarray(path),
                                              jax.random.key(5)))
        cons, class_ok, _ = jax_certify_task.coherence_stats(seqs, cls)
        row = {"coherence_mean": round(float(cons.mean()), 4),
               "class_acc": round(float(class_ok.mean()), 3)}
        if ref is None:
            ref = logits, seqs
        else:
            cos = (logits * ref[0]).sum(-1) / (np.linalg.norm(logits, axis=-1)
                                               * np.linalg.norm(ref[0], axis=-1) + 1e-9)
            row["logit_min_cosine"] = round(float(cos.min()), 6)
            row["temp0_seq_exact_match"] = round(float((seqs == ref[1]).all(axis=1).mean()), 3)
        rows.append(row)
    return rows, ids


def test_certify_int8_rows_match_jax(trained):
    model, params, port = trained
    z_c, cls, path = _inputs()
    modes = ["bf16", "int8-ff+proj"]
    want_rows, want_ids = _jax_int8_rows(model, params, z_c.numpy(), cls, path, modes)
    rows, ids = certify_int8.certify_rows(port, modes, z_c, cls, torch.from_numpy(path),
                                          dtype=torch.float32)
    for name, got, want in zip(modes, rows, want_rows):
        np.testing.assert_array_equal(ids[name], want_ids[name], err_msg=name)
        for key in ("coherence_mean", "class_acc", "temp0_seq_exact_match"):
            assert got.get(key) == want.get(key), (name, key, got, want)
        if "logit_min_cosine" in want:
            assert abs(got["logit_min_cosine"] - want["logit_min_cosine"]) <= 1e-4
    assert {"mode_diversity", "logit_max_abs_delta", "temp0_tok_agreement"} <= set(rows[1])


def test_certify_blocked_cell_matches_jax(trained):
    model, params, port = trained
    z_c, cls, path = _inputs()
    sampler = jax_make_sampler(model.apply, SMALL.num_timesteps, temperature=0.0,
                               positions_per_step=2, chunk_steps=None, order="path")
    want = np.asarray(sampler(params, jnp.asarray(z_c.numpy()), jnp.asarray(path),
                              jax.random.key(5)))
    got = certify_blocked.blocked_ids(port, z_c, torch.from_numpy(path), order="path",
                                      temp=0.0, k=2)
    np.testing.assert_array_equal(got, want)
    row = certify_blocked.quality(got, cls)
    assert 0 <= row["coherence_mean"] <= 1 and 0 <= row["class_acc"] <= 1


def test_certify_inpaint_cell_matches_jax(trained):
    model, params, port = trained
    real, z_c, _ = certify_task.make_batch(np.random.default_rng(7), B, L, SMALL.cond_dim)
    masked, path, t = jax_corrupt_samples(jax.random.key(3), jnp.asarray(real.numpy()), 0.5, L)
    fn = jax_make_inpainter(model.apply, L, temperature=0.0, order="confidence")
    want = np.asarray(fn(params, masked, jnp.asarray(z_c.numpy()), path, t, jax.random.key(5)))
    port_fn = make_inpainter(port, L, temperature=0.0, order="confidence")
    got = certify_inpaint.fill("inpaint-confidence", port_fn, torch.tensor(np.array(masked)), z_c,
                               torch.tensor(np.array(path)), torch.tensor(np.array(t)), None)
    np.testing.assert_array_equal(got, want)
    stats = certify_inpaint.restore_stats(got, real.numpy(), np.asarray(masked))
    assert stats == jax_certify_inpaint.restore_stats(want, real.numpy(), np.asarray(masked))
    assert stats[2] == 1.0

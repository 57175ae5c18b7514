"""Stage-2 (Facilitator) training in biom3_tpu_torch against the JAX
package, on the CPU in f32: ``training/stage2_task.py`` (the MSE and MMD
losses and their gradients under ``jax.grad``, three AdamW steps),
the copied ``data/stage2_data.py`` and ``cli/run_train_stage2.py`` end to
end (``--resume``, ``--export_bin`` served by ``run_facilitator_sample``).

The Flax Facilitator's parameters are carried to the port by
``io/from_jax.py``; both sides train with dropout off (the JAX step's
``deterministic=True`` default).  Losses and gradients compare at atol
1e-6 / rtol 1e-5, parameters after three steps at atol 1e-5.
"""

import inspect
import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from biom3_tpu.config import FacilitatorConfig
from biom3_tpu.models.facilitator import Facilitator as JaxFacilitator
from biom3_tpu.training import stage2_task as jax_task
from biom3_tpu_torch.io.from_jax import facilitator_from_jax, facilitator_params_to_torch, \
    port_config
from biom3_tpu_torch.training import stage2_task

CFG = FacilitatorConfig(in_dim=16, hid_dim=32, out_dim=16, dropout=0.3)
GRAD_TOL = dict(atol=1e-6, rtol=1e-5)


@pytest.fixture(scope="module")
def setup():
    """Flax Facilitator (dropout 0.3, unused in training as in JAX), its port,
    and one batch of (z_t, z_p)."""
    model = JaxFacilitator(CFG)
    variables = model.init(jax.random.key(0), jnp.zeros((1, CFG.in_dim)))
    rng = np.random.default_rng(0)
    z_t = rng.standard_normal((8, CFG.in_dim)).astype(np.float32)
    z_p = (0.5 * rng.standard_normal((8, CFG.out_dim))).astype(np.float32)
    return model, variables, z_t, z_p


def _port_grads(port):
    return {n: p.grad.numpy() for n, p in port.named_parameters()}


@pytest.mark.parametrize("loss_type", ["MSE", "MMD"])
def test_loss_and_grads_equal_jax(setup, loss_type):
    model, variables, z_t, z_p = setup
    (loss, aux), grads = jax.value_and_grad(
        lambda p: jax_task.stage2_loss_fn(model.apply, p, jnp.asarray(z_t), jnp.asarray(z_p),
                                          loss_type=loss_type), has_aux=True)(variables)
    port = facilitator_from_jax(variables, port_config(CFG))
    got, got_aux = stage2_task.stage2_loss_fn(port, torch.from_numpy(z_t),
                                              torch.from_numpy(z_p), loss_type=loss_type)
    got.backward()
    np.testing.assert_allclose(float(got.detach()), float(loss), **GRAD_TOL)
    np.testing.assert_allclose(float(got_aux["mse"]), float(aux["mse"]), **GRAD_TOL)
    want = facilitator_params_to_torch(jax.tree_util.tree_map(np.asarray, grads), CFG)
    got_g = _port_grads(port)
    assert set(got_g) == set(want)
    for k in want:
        np.testing.assert_allclose(got_g[k], np.asarray(want[k]).reshape(got_g[k].shape),
                                   err_msg=k, **GRAD_TOL)
    with pytest.raises(ValueError, match="invalid loss option"):
        stage2_task.stage2_loss_fn(port, torch.from_numpy(z_t), torch.from_numpy(z_p),
                                   loss_type="L1")


@pytest.mark.parametrize("loss_type", ["MSE", "MMD"])
def test_three_adamw_steps_equal_jax(setup, loss_type):
    """Three steps of the JAX train step (optax AdamW) against the port's
    (``torch.optim.AdamW`` with optax's defaults), dropout off on both."""
    from biom3_tpu.training.optim import make_optimizer as jax_make_optimizer
    from biom3_tpu.training.state import TrainState as JaxTrainState
    from biom3_tpu_torch.training.optim import make_optimizer
    from biom3_tpu_torch.training.state import TrainState

    model, variables, z_t, z_p = setup
    tx = jax_make_optimizer("AdamW", 1e-2)
    jstate = JaxTrainState.create(variables, tx)
    jstep = jax.jit(jax_task.make_stage2_train_step(model.apply, tx, loss_type=loss_type))
    port = facilitator_from_jax(variables, port_config(CFG))
    state = TrainState(port, make_optimizer("AdamW", port.parameters(), 1e-2))
    step = stage2_task.make_stage2_train_step(state, loss_type=loss_type)
    for i in range(3):
        sl = slice(2 * i, 2 * i + 4)
        jstate, jaux = jstep(jstate, {"z_t": jnp.asarray(z_t[sl]), "z_p": jnp.asarray(z_p[sl])})
        aux = step({"z_t": torch.from_numpy(z_t[sl]), "z_p": torch.from_numpy(z_p[sl])})
        np.testing.assert_allclose(float(aux["loss"]), float(jaux["loss"]), atol=1e-5)
    assert state.step == 3 and not port.training
    want = facilitator_params_to_torch(jax.tree_util.tree_map(np.asarray, jstate.params), CFG)
    for k, v in port.state_dict().items():
        np.testing.assert_allclose(v.numpy(), np.asarray(want[k]).reshape(v.shape), atol=1e-5,
                                   err_msg=k)


def test_stage2_data_copy_equals_the_jax_package(tmp_path):
    """The port's ``data/stage2_data.py`` is the JAX module's numpy code (its
    loader aside): the same sources, arrays and split indices."""
    from biom3_tpu.data import stage2_data as jax_data
    from biom3_tpu_torch.data import stage2_data

    for name in ("__init__", "split", "__len__"):
        assert inspect.getsource(getattr(stage2_data.FacilitatorDataset, name)) == \
            inspect.getsource(getattr(jax_data.FacilitatorDataset, name)), name
    assert inspect.getsource(stage2_data._concat_field) == \
        inspect.getsource(jax_data._concat_field)
    assert stage2_data.OOD_PFAM_LABELS == jax_data.OOD_PFAM_LABELS
    rng = np.random.default_rng(1)
    for n, key in ((37, "sp"), (12, "pf")):
        torch.save({"text_embedding": [torch.randn(4) for _ in range(n)],
                    "protein_embedding": torch.from_numpy(rng.standard_normal((n, 4)))},
                   tmp_path / f"{key}.pt")
    for paths in ((tmp_path / "sp.pt", None), (tmp_path / "sp.pt", tmp_path / "pf.pt"),
                  (None, tmp_path / "pf.pt")):
        got = stage2_data.FacilitatorDataset.from_paths(*paths, valid_size=0.25, seed=7)
        want = jax_data.FacilitatorDataset.from_paths(*paths, valid_size=0.25, seed=7)
        for attr in ("z_t", "z_p", "train_idx", "val_idx"):
            a, b = getattr(got, attr), getattr(want, attr)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), attr
        assert len(got) == len(want)
    with pytest.raises(ValueError, match="both SwissProt and Pfam"):
        stage2_data.FacilitatorDataset.from_paths(None, "None")


def test_run_train_stage2_cli_cpu(tmp_path, capsys):
    """``run_train_stage2 --device cpu``: 2 epochs with ``--export_bin``,
    then ``--resume`` for one more; the exported .bin loads into
    ``run_facilitator_sample``."""
    from biom3_tpu_torch.cli import run_facilitator_sample, run_train_stage2

    rng = np.random.default_rng(2)
    n = 48
    z_t = rng.standard_normal((n, 16)).astype(np.float32)
    torch.save({"text_embedding": torch.from_numpy(z_t),
                "protein_embedding": torch.from_numpy(np.tanh(z_t @ rng.standard_normal(
                    (16, 16)).astype(np.float32)))}, tmp_path / "emb.pt")
    (tmp_path / "s2.json").write_text(json.dumps({
        "emb_dim": 16, "hid_dim": 32, "dropout": 0.1, "batch_size": 8, "valid_size": 0.25,
        "seed": 3, "loss_type": "MSE"}))
    common = ["--json_path", str(tmp_path / "s2.json"), "--output_dir", str(tmp_path / "out"),
              "--swissprot_data_path", str(tmp_path / "emb.pt"), "--device", "cpu",
              "--lr", "1e-2"]
    run_train_stage2.main(common + ["--epochs", "2", "--export_bin", str(tmp_path / "f.bin")])
    out = capsys.readouterr().out
    assert "train: 36, val: 12" in out and f"exported params to {tmp_path / 'f.bin'}" in out
    losses = [float(line.split("train_loss=")[1].split()[0]) for line in out.splitlines()
              if line.startswith("epoch ")]
    assert len(losses) == 2 and all(np.isfinite(losses)) and losses[1] < losses[0]
    assert "saved final checkpoint at step 8" in out
    run_train_stage2.main(common + ["--epochs", "1", "--resume"])
    out = capsys.readouterr().out
    assert "resumed from step 8" in out and "saved final checkpoint at step 12" in out
    sd = torch.load(tmp_path / "f.bin", weights_only=True)
    assert set(sd) == {f"main.{i}.{k}" for i in (0, 3) for k in ("weight_g", "weight_v", "bias")}
    torch.save({"z_t": torch.from_numpy(z_t[:4]), "z_p": torch.zeros(4, 16)},
               tmp_path / "in.pt")
    run_facilitator_sample.main(["--input_data_path", str(tmp_path / "in.pt"),
                                 "--output_data_path", str(tmp_path / "fo.pt"),
                                 "--model_path", str(tmp_path / "f.bin"),
                                 "--json_path", str(tmp_path / "s2.json"), "--device", "cpu"])
    z_c = torch.load(tmp_path / "fo.pt", weights_only=False)["z_c"]
    assert tuple(z_c.shape) == (4, 16) and np.isfinite(np.asarray(z_c)).all()
    lines = (tmp_path / "out" / "metrics.csv").read_text().splitlines()
    assert lines[0].split(",") == ["step", "train_loss", "val_loss"] and len(lines) == 4

"""The port's Stage-3 training CLI on the CPU (f32, the kernels' plain
versions): train, checkpoint, resume and export, and the exported ``.bin``
served by both packages.

``biom3_tpu_torch.cli.run_train_stage3.main`` runs in-process on a small
config (dim 64, 2 layers, L 64, W 16) and a seeded synthetic Stage-2
output, the data file the JAX CLI's test builds (``tests/test_cli.py``).
"""

import json

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from biom3_tpu.config import ProteoScribeConfig as JaxProteoScribeConfig
from biom3_tpu.io.convert import proteoscribe_params_from_torch
from biom3_tpu.models.proteoscribe import ProteoScribe as JaxProteoScribe
from biom3_tpu_torch.cli import run_train_stage3 as cli
from biom3_tpu_torch.config import Config, ProteoScribeConfig
from biom3_tpu_torch.io.state_dict import seeded_init_
from biom3_tpu_torch.models.proteoscribe import ProteoScribe

STAGE3 = {"diffusion_steps": 64, "image_size": 8, "num_classes": 29, "text_emb_dim": 16,
          "transformer_dim": 64, "transformer_heads": 4, "transformer_depth": 2,
          "transformer_blocks": 1, "transformer_local_heads": 2, "transformer_local_size": 16,
          "batch_size": 8, "epochs": 1, "valid_size": 0.25, "enter_eval": 2,
          "learning_rate": 1e-3, "acc_grad_batches": 2, "seed": 3, "facilitator": "MMD"}


def _files(root, **over):
    rng = np.random.default_rng(0)
    seqs = ["".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), int(n)))
            for n in rng.integers(5, 60, 24)]
    torch.save({"sequence": seqs, "text_to_protein_embedding": torch.from_numpy(
        rng.standard_normal((24, 16)).astype(np.float32))}, root / "data.pt")
    (root / "s3.json").write_text(json.dumps({**STAGE3, **over}))
    return ["--json_path", str(root / "s3.json"), "--output_dir", str(root / "out"),
            "--swissprot_data_root", str(root / "data.pt"), "--device", "cpu"]


def test_train_checkpoint_resume_export(tmp_path, capsys):
    args = _files(tmp_path)
    cli.main(args + ["--max_steps", "4", "--export_bin", str(tmp_path / "ema.bin")])
    out = capsys.readouterr().out
    for want in ("train examples: 18, val: 6", "step 1/4 loss=", "  val: current_hard_acc=",
                 f"exported ema params to {tmp_path / 'ema.bin'}", "finished at step 4"):
        assert want in out, out
    ckpts = tmp_path / "out" / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir()) == ["step_2.pt", "step_4.pt"]
    rows = (tmp_path / "out" / "metrics.csv").read_text().splitlines()
    assert rows[0].startswith("step,") and len(rows) == 4        # steps 1, 2, 4

    cli.main(args + ["--max_steps", "8", "--resume", "--layer-mode", "block",
                     "--export_bin", str(tmp_path / "final.bin"), "--export_params", "final"])
    out = capsys.readouterr().out
    assert "resumed from step 4" in out and "finished at step 8" in out, out
    assert sorted(p.name for p in ckpts.iterdir()) == ["step_4.pt", "step_6.pt", "step_8.pt"]
    header = (tmp_path / "out" / "metrics.csv").read_text().splitlines()[0].split(",")
    assert {"loss", "acc_unsampled", "val_loss"} <= set(header)

    cfg = ProteoScribeConfig.from_stage_config(Config(STAGE3))
    init = seeded_init_(ProteoScribe(cfg), STAGE3["seed"]).state_dict()
    for name in ("ema.bin", "final.bin"):
        sd = torch.load(tmp_path / name, weights_only=True)
        assert all(k.startswith("transformer.") for k in sd)
        ProteoScribe(cfg).load_state_dict(sd, strict=True)
        assert any(not torch.equal(sd[k], init[k]) for k in sd), name


def test_exported_bin_serves_the_same_logits_in_both_packages(tmp_path):
    """The exported ``.bin`` through the port and through the JAX package's
    converter (``biom3_tpu/io/convert.py:57``): logits atol 2e-4."""
    cli.main(_files(tmp_path) + ["--max_steps", "2", "--export_bin", str(tmp_path / "m.bin"),
                                 "--export_params", "final"])
    sd = torch.load(tmp_path / "m.bin", weights_only=True)
    cfg = ProteoScribeConfig.from_stage_config(Config(STAGE3))
    model = ProteoScribe(cfg)
    model.load_state_dict(sd, strict=True)
    jcfg = JaxProteoScribeConfig.from_stage_config(Config(STAGE3))
    params = proteoscribe_params_from_torch({k: v.numpy() for k, v in sd.items()}, jcfg)
    rng = np.random.default_rng(1)
    x = rng.integers(0, 29, (2, 64)).astype(np.int32)
    t = rng.integers(0, 64, (2,)).astype(np.int32)
    z = rng.standard_normal((2, 16)).astype(np.float32)
    want = JaxProteoScribe(jcfg).apply(params, jnp.asarray(x), jnp.asarray(t),
                                       jnp.asarray(z))
    with torch.no_grad():
        got = model.eval()(torch.from_numpy(x), torch.from_numpy(t), torch.from_numpy(z))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax.device_get(want)), atol=2e-4)


def test_layer_block_refuses_dropout_and_block_trains_with_it(tmp_path, capsys):
    args = _files(tmp_path, input_dp_rate=0.1)
    with pytest.raises(SystemExit, match="--layer-mode layer_block has no dropout path"):
        cli.main(args + ["--max_steps", "1"])
    cli.main(args + ["--max_steps", "1", "--layer-mode", "block"])
    assert "finished at step 1" in capsys.readouterr().out


def test_scan_remat_is_refused(tmp_path):
    with pytest.raises(SystemExit, match="unrolled_remat"):
        cli.main(_files(tmp_path) + ["--layer-mode", "scan_remat"])


def test_cuda_without_a_card_is_refused(tmp_path):
    """Nothing falls back to the CPU when no card is found."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(_files(tmp_path) + ["--device", "cuda"])


def test_unrolled_remat_trains(tmp_path, capsys):
    cli.main(_files(tmp_path) + ["--max_steps", "2", "--layer-mode", "unrolled_remat"])
    assert "finished at step 2" in capsys.readouterr().out

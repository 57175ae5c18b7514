"""The port's Stage-1 training CLI on the CPU (f32, the kernels' plain
versions): train, checkpoint, resume and export, and the exported ``.bin``
served by both packages.

``biom3_tpu_torch.cli.run_train_stage1.main`` runs in-process on a small
config (ESM2 E=64, 2 layers; BERT 32 wide, 2 layers; the synthetic
wordpiece vocab) and a seeded synthetic SwissProt CSV (one protein over
1022 residues, which the loader drops).
"""

import csv
import json

import numpy as np
import pytest
import torch

from biom3_tpu.cli.demo_data import DEMO_CAPTIONS, DEMO_SEQUENCES
from biom3_tpu.config import load_json_config
from biom3_tpu.pipeline.stage1 import PenCLEngine as JaxEngine
from biom3_tpu_torch.cli import run_pencl_inference
from biom3_tpu_torch.cli import run_train_stage1 as cli
from biom3_tpu_torch.config import PenCLConfig
from biom3_tpu_torch.config import load_json_config as port_load_json_config
from biom3_tpu_torch.io.state_dict import seeded_init_
from biom3_tpu_torch.models.pencl import PenCL, pencl_train_state_dict
from biom3_tpu_torch.tokenizers import write_synthetic_wordpiece

WORDS = ["protein", "enzyme", "binding", "membrane", "kinase", "the", "a", "of", "with",
         "activity", "catalyzes", "transport"]
TOL = dict(atol=2e-4, rtol=1e-3)   # tests/test_torch_pencl.py's tolerance


def _write_csv(path, n, seed, long_row=None):
    rng = np.random.default_rng(seed)
    with open(path, "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["primary_Accession", "protein_sequence", "[final]text_caption"])
        for i in range(n):
            length = 1100 if i == long_row else int(rng.integers(5, 60))
            w.writerow([f"P{i:05d}", "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"), length)),
                        " ".join(rng.choice(WORDS, int(rng.integers(3, 10))))])


def _files(root, **over):
    vocab = write_synthetic_wordpiece(root / "tok")
    cfg = {"protein_encoder_embedding": 64, "text_encoder_embedding": 32, "esm_num_layers": 2,
           "esm_attention_heads": 2, "bert_num_layers": 2, "bert_num_heads": 2,
           "bert_intermediate_size": 64, "bert_vocab_size": vocab,
           "bert_max_position_embeddings": 64, "proj_embedding_dim": 16, "text_max_length": 64,
           "text_model_path": str(root / "tok"), "batch_size": 4, "epochs": 1, "seed": 3,
           "dataset_type": "default", "model_type": "pfam", "weight_decay": 1e-4,
           "protein_encoder_lr": 1e-3, "text_encoder_lr": 1e-3, "head_lr": 1e-3, **over}
    (root / "s1.json").write_text(json.dumps(cfg))
    _write_csv(root / "sp.csv", 13, 0, long_row=3)
    return ["--json_path", str(root / "s1.json"), "--output_dir", str(root / "out"),
            "--data_path", str(root / "sp.csv"), "--device", "cpu"]


def test_train_checkpoint_resume_export(tmp_path, capsys):
    args = _files(tmp_path)
    cli.main(args + ["--max_steps", "3", "--export_bin", str(tmp_path / "a.bin")])
    out = capsys.readouterr().out
    for want in ("swissprot: 12 pairs", "layer-mode auto -> xla",
                 "model_type=pfam: mapping dataset_type 'default' -> 'pfam'",
                 "step 1/3 loss=", f"exported params to {tmp_path / 'a.bin'}",
                 "finished at step 3"):
        assert want in out, out
    ckpts = tmp_path / "out" / "checkpoints"
    assert sorted(p.name for p in ckpts.iterdir()) == ["step_3.pt"]
    header = (tmp_path / "out" / "metrics.csv").read_text().splitlines()[0].split(",")
    assert {"loss", "loss_align", "loss_intra", "loss_text_mask", "loss_seq_mask",
            "total_f1"} <= set(header)

    cli.main(args + ["--max_steps", "5", "--resume", "--layer-mode", "layer_block",
                     "--export_bin", str(tmp_path / "b.bin")])
    out = capsys.readouterr().out
    assert "resumed from step 3" in out and "finished at step 5" in out, out
    assert sorted(p.name for p in ckpts.iterdir()) == ["step_3.pt", "step_5.pt"]

    cfg = PenCLConfig.from_stage_config(port_load_json_config(tmp_path / "s1.json"))
    init = seeded_init_(PenCL(cfg, mlm_heads=True), 3).state_dict()
    a, b = (torch.load(tmp_path / n, weights_only=True) for n in ("a.bin", "b.bin"))
    assert torch.equal(a["protein_encoder.model.lm_head.weight"],
                       a["protein_encoder.model.embed_tokens.weight"])
    for sd in (a, b):
        PenCL(cfg, mlm_heads=True).load_state_dict(pencl_train_state_dict(sd), strict=True)
    assert all(any(not torch.equal(sd[k], init[k]) for k in init) for sd in (a, b))
    assert any(not torch.equal(a[k], b[k]) for k in init)


def test_exported_bin_serves_the_same_latents_in_both_packages(tmp_path):
    """``run_pencl_inference --device cpu`` on the exported ``.bin`` and the
    JAX ``PenCLEngine`` (``biom3_tpu/io/convert_stage1.py``) on the same
    file: the demo pairs' latents within atol 2e-4, rtol 1e-3."""
    args = _files(tmp_path)
    cli.main(args + ["--max_steps", "2", "--export_bin", str(tmp_path / "m.bin")])
    run_pencl_inference.main(["--json_path", str(tmp_path / "s1.json"), "--model_path",
                              str(tmp_path / "m.bin"), "--output_path", str(tmp_path / "o.pt"),
                              "--device", "cpu"])
    saved = torch.load(tmp_path / "o.pt", weights_only=False)
    want_t, want_p = JaxEngine(load_json_config(tmp_path / "s1.json"),
                               str(tmp_path / "m.bin")).embed(DEMO_CAPTIONS, DEMO_SEQUENCES)
    assert np.asarray(saved["z_p"]).shape == (5, 16)
    np.testing.assert_allclose(np.asarray(saved["z_t"]), want_t, **TOL)
    np.testing.assert_allclose(np.asarray(saved["z_p"]), want_p, **TOL)


def test_pfam_csv_trains_and_must_be_row_aligned(tmp_path, capsys):
    args = _files(tmp_path)
    _write_csv(tmp_path / "pfam.csv", 12, 1)
    cli.main(args + ["--pfam_data_path", str(tmp_path / "pfam.csv"), "--max_steps", "1"])
    out = capsys.readouterr().out
    assert "swissprot: 12 pairs, pfam: 12" in out and "finished at step 1" in out, out
    _write_csv(tmp_path / "short.csv", 7, 1)
    with pytest.raises(SystemExit, match="row-aligned"):
        cli.main(args + ["--pfam_data_path", str(tmp_path / "short.csv"), "--max_steps", "1"])


@pytest.mark.parametrize("flags,match", [(["--optimizer", "adafactor"], "Adafactor"),
                                         (["--moment_dtype", "bfloat16"], "moment_dtype")])
def test_unported_optimizer_options_are_refused(tmp_path, flags, match, capsys):
    """Once refused, both options train now (Adafactor; bf16 AdamW first
    moments): the CLI names the optimizer it built and takes a step.  What
    stays refused is their combination (adafactor keeps no first moment)."""
    cli.main(_files(tmp_path) + flags + ["--max_steps", "1"])
    out = capsys.readouterr().out
    assert "optimizer: " in out and match in out.split("optimizer: ", 1)[1].splitlines()[0]
    assert "finished at step 1" in out, out
    (tmp_path / "both").mkdir()
    with pytest.raises(SystemExit, match="moment_dtype applies to adamw only"):
        cli.main(_files(tmp_path / "both") + ["--optimizer", "adafactor", "--moment_dtype",
                                              "bfloat16", "--max_steps", "1"])


def test_remat_trains(tmp_path, capsys):
    cli.main(_files(tmp_path, dataset_type="masked", model_type="masked")
             + ["--max_steps", "1", "--remat", "--layer-mode", "xla"])
    assert "finished at step 1" in capsys.readouterr().out


def test_cuda_without_a_card_is_refused(tmp_path):
    """Nothing falls back to the CPU when no card is found."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(_files(tmp_path) + ["--device", "cuda"])

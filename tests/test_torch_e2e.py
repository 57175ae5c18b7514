"""The text→protein slice as a whole: biom3_tpu_torch engines vs the JAX
engines on the same prompts and weights (CPU, f32, temperature 0).

The JAX engines (``PenCLEngine(text_only)`` → ``FacilitatorEngine`` →
``ProteoScribeEngine``) start from their seeded inits; their parameters
are exported to reference-layout ``.bin`` files, which the port's engines
load.  z_t and z_c must agree to atol 1e-4 and the decoded sequences for
the same numpy sampling paths must be equal.  The port's CLI then runs as
a subprocess on those files with ``--device cpu``.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import pytest
import torch

from biom3_tpu.config import load_json_config
from biom3_tpu.io.export import (
    facilitator_params_to_torch,
    pencl_params_to_torch,
    proteoscribe_params_to_torch,
)
from biom3_tpu.io.torch_load import save_torch_file
from biom3_tpu.tokenizers.synthetic import write_synthetic_wordpiece

REPO = pathlib.Path(__file__).resolve().parent.parent
PROMPTS = ["membrane transport protein", "kinase with atp binding activity"]


@pytest.fixture(scope="module")
def stage_files(tmp_path_factory):
    """Three small stage configs, the JAX engines, and .bin exports."""
    from biom3_tpu.pipeline.stage1 import PenCLEngine
    from biom3_tpu.pipeline.stage2 import FacilitatorEngine
    from biom3_tpu.pipeline.stage3 import ProteoScribeEngine

    root = tmp_path_factory.mktemp("slice")
    vocab = write_synthetic_wordpiece(root / "tok")
    cfgs = {
        1: {"protein_encoder_embedding": 16, "text_encoder_embedding": 32,
            "esm_num_layers": 1, "esm_attention_heads": 2, "bert_num_layers": 2,
            "bert_num_heads": 2, "bert_intermediate_size": 64, "bert_vocab_size": vocab,
            "bert_max_position_embeddings": 32, "proj_embedding_dim": 16,
            "text_max_length": 32, "text_model_path": str(root / "tok")},
        2: {"emb_dim": 16, "hid_dim": 32, "dropout": 0.0},
        3: {"num_replicas": 2, "batch_size_sample": 2, "diffusion_steps": 64,
            "num_classes": 29, "text_emb_dim": 16, "transformer_dim": 32,
            "transformer_heads": 4, "transformer_depth": 2, "transformer_blocks": 1,
            "transformer_local_heads": 2, "transformer_local_size": 16},
    }
    for n, cfg in cfgs.items():
        (root / f"s{n}.json").write_text(json.dumps(cfg))
    s1 = PenCLEngine(load_json_config(root / "s1.json"), text_only=True)
    s2 = FacilitatorEngine(load_json_config(root / "s2.json"))
    s3 = ProteoScribeEngine(load_json_config(root / "s3.json"), temperature=0.0)
    save_torch_file(pencl_params_to_torch(s1.params, s1.config), root / "s1.bin")
    save_torch_file(facilitator_params_to_torch(s2.params, s2.config), root / "s2.bin")
    save_torch_file(proteoscribe_params_to_torch(s3.params, s3.config), root / "s3.bin")
    flags = {f"--stage{n}_{kind}": str(root / f"s{n}.{ext}")
             for n in (1, 2, 3) for kind, ext in (("json", "json"), ("model", "bin"))}
    return root, (s1, s2, s3), flags


def test_slice_matches_jax_engines(stage_files):
    from biom3_tpu_torch.pipeline.stage1 import PenCLEngine
    from biom3_tpu_torch.pipeline.stage2 import FacilitatorEngine
    from biom3_tpu_torch.config import load_json_config as port_load_json_config
    from biom3_tpu_torch.pipeline.stage3 import ProteoScribeEngine

    root, (j1, j2, j3), flags = stage_files
    p1 = PenCLEngine(port_load_json_config(root / "s1.json"), flags["--stage1_model"],
                     device="cpu", use_stack=True)
    p2 = FacilitatorEngine(port_load_json_config(root / "s2.json"), flags["--stage2_model"],
                           device="cpu")
    p3 = ProteoScribeEngine(port_load_json_config(root / "s3.json"), flags["--stage3_model"],
                            device="cpu", use_stack=True, temperature=0.0)

    z_t = np.asarray(j1.embed_text(PROMPTS))
    got_z_t = p1.embed_text(PROMPTS)
    np.testing.assert_allclose(got_z_t, z_t, atol=1e-4)
    z_c = np.asarray(j2(z_t))
    np.testing.assert_allclose(p2(z_t), z_c, atol=1e-4)

    rng = np.random.default_rng(0)
    L = j3.config.max_seq_len
    for z in z_c:
        zz = np.tile(z[None, :], (2, 1))
        paths = np.stack([rng.permutation(L) for _ in range(2)]).astype(np.int32)
        want = j3.sample_batch(zz, jax.random.key(0), paths=paths)
        got = p3.sample_batch(zz, None, paths=paths)
        np.testing.assert_array_equal(got, want)
        decode = lambda ids: [j3.vocab.clean_sequence(j3.vocab.decode_ids(r)) for r in ids]
        assert decode(got) == decode(want)


def test_generate_sequences_schema(stage_files):
    from biom3_tpu_torch.config import load_json_config as port_load_json_config
    from biom3_tpu_torch.pipeline.stage3 import ProteoScribeEngine

    root, _, flags = stage_files
    eng = ProteoScribeEngine(port_load_json_config(root / "s3.json"), flags["--stage3_model"],
                             device="cpu", use_stack=True, temperature=1.0,
                             positions_per_step=4)
    z_c = np.random.default_rng(1).standard_normal((2, 16)).astype(np.float32)
    out = eng.generate_sequences(z_c, num_replicas=3, batch_size=2, seed=3)
    assert set(out) == {"replica_0", "replica_1", "replica_2"}
    assert all(len(v) == 2 for v in out.values())
    again = eng.generate_sequences(z_c, num_replicas=3, batch_size=2, seed=3)
    assert again == out  # a seed reproduces the draw


def _run_cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:{env.get('PYTHONPATH', '')}"
    return subprocess.run([sys.executable, "-m", "biom3_tpu_torch.cli.run_e2e", *args],
                          capture_output=True, text=True, env=env, timeout=600)


def test_run_e2e_cli_cpu(stage_files, tmp_path):
    root, _, flags = stage_files
    (tmp_path / "prompts.txt").write_text("\n".join(PROMPTS) + "\n")
    out = tmp_path / "e2e.pt"
    r = _run_cli(*[a for kv in flags.items() for a in kv], "--prompts",
                 str(tmp_path / "prompts.txt"), "--output_path", str(out), "--device", "cpu",
                 "--positions_per_step", "8")
    assert r.returncode == 0, r.stderr[-2000:]
    for line in ("2 prompts", "z_t: (2, 16)", "z_c: (2, 16)", f"Saved {out}"):
        assert line in r.stdout
    saved = torch.load(out, weights_only=False)
    assert saved["prompts"] == PROMPTS
    assert tuple(saved["z_t"].shape) == (2, 16) and tuple(saved["z_c"].shape) == (2, 16)
    assert set(saved["sequences"]) == {"replica_0", "replica_1"}
    for seqs in saved["sequences"].values():
        assert len(seqs) == 2
        for s in seqs:
            assert "<START>" not in s and "<PAD>" not in s


def _e2e_args(*flag):
    from biom3_tpu_torch.cli import run_e2e

    return run_e2e.parse_arguments(
        [f for n in (1, 2, 3) for f in (f"--stage{n}_json", "x", f"--stage{n}_model", "x")]
        + ["--prompts", "p", "--output_path", "o", *flag])


@pytest.mark.parametrize("flag", [["--inpaint_sequence", "MK??"],
                                  ["--ff-quant", "int8", "--inpaint_sequence", "MK??"]])
def test_run_e2e_refuses_unported_flags(flag):
    """Nothing of the JAX CLI is left to refuse: the inpaint flags parse and
    reach the inpaint path."""
    from biom3_tpu_torch.cli import run_e2e

    args = _e2e_args(*flag)
    assert (args.inpaint_sequence, args.inpaint_unknown) == ("MK??", "?")
    assert not hasattr(run_e2e, "_refuse_unported")


def test_run_e2e_inpaint_sequence_equals_jax_cli(stage_files, tmp_path, monkeypatch):
    """``run_e2e --device cpu --inpaint_sequence`` at temperature 0 (f32: the
    Flax graph, the port's modules): the same filled designs as the JAX
    CLI for both prompts and replicas, the committed residues kept."""
    from biom3_tpu.cli import run_e2e as jax_cli
    from biom3_tpu_torch.cli import run_e2e

    root, _, flags = stage_files
    (tmp_path / "prompts.txt").write_text("\n".join(PROMPTS) + "\n")
    args = [*(a for kv in flags.items() for a in kv), "--prompts", str(tmp_path / "prompts.txt"),
            "--temperature", "0", "--inpaint_sequence", "MK??ACDE??LL?", "--seed", "2"]
    monkeypatch.setattr(sys, "argv", ["run_e2e", *args, "--output_path",
                                      str(tmp_path / "jax.pt")])
    jax_cli.main()
    run_e2e.main([*args, "--output_path", str(tmp_path / "port.pt"), "--device", "cpu"])
    want, got = (torch.load(tmp_path / f, weights_only=False)["sequences"]
                 for f in ("jax.pt", "port.pt"))
    assert got == want and set(got) == {"replica_0", "replica_1"}
    for seqs in got.values():
        assert len(seqs) == 2
        for s in seqs:
            assert "?" not in s and "<START>" not in s
            it = iter(s)
            assert all(c in it for c in "MKACDELL"), s


@pytest.mark.parametrize("flag", [["--sampler", "maskgit", "--maskgit_steps", "4"],
                                  ["--decode_order", "confidence", "--positions_per_step", "8"]])
def test_run_e2e_runs_the_fast_modes(stage_files, tmp_path, capsys, flag):
    """The fast modes run on the CPU (the PyTorch modules, f32): valid
    sequences for both prompts and replicas; the seeded run repeats."""
    from biom3_tpu_torch.cli import run_e2e

    root, _, flags = stage_files
    (tmp_path / "prompts.txt").write_text("\n".join(PROMPTS) + "\n")
    outs = []
    for i in range(2):
        run_e2e.main([*(a for kv in flags.items() for a in kv), "--prompts",
                      str(tmp_path / "prompts.txt"), "--output_path", str(tmp_path / f"{i}.pt"),
                      "--device", "cpu", "--seed", "4", *flag])
        outs.append(torch.load(tmp_path / f"{i}.pt", weights_only=False)["sequences"])
    assert f"Saved {tmp_path / '1.pt'}" in capsys.readouterr().out
    assert outs[0] == outs[1] and set(outs[0]) == {"replica_0", "replica_1"}
    for seqs in outs[0].values():
        assert len(seqs) == 2
        for s in seqs:
            assert isinstance(s, str) and "<START>" not in s and "<PAD>" not in s


def test_run_e2e_takes_the_int8_flags():
    """int8 is ported: the quant flags pass, and reach Stage 3 only."""
    from biom3_tpu_torch.cli import run_e2e

    args = _e2e_args("--ff-quant", "int8", "--proj-quant", "none")
    assert (args.ff_quant, args.proj_quant) == ("int8", "none")

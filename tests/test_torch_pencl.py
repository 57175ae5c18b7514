"""The PenCL inference slice: biom3_tpu_torch vs the JAX package (CPU, f32).

The full ``PenCL`` module (both towers, both heads) and ``compute_scores``
are held against ``PenCL.apply`` and the JAX ``compute_scores``; the
engine's two tower paths against each other; the port's
``run_pencl_inference --device cpu`` against the JAX ``PenCLEngine`` on
one ``.bin`` in the published layout — with fair-esm's LM and contact
heads, rotary buffers, BERT's MLM head and HF's buffers in it, which the
port must name and drop — within atol 2e-4 / rtol 1e-3.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from biom3_tpu.cli.demo_data import DEMO_CAPTIONS, DEMO_SEQUENCES
from biom3_tpu.config import BertConfig, ESM2Config, PenCLConfig, load_json_config
from biom3_tpu.io.export import pencl_params_to_torch
from biom3_tpu.io.torch_load import save_torch_file
from biom3_tpu.models.pencl import PenCL as JaxPenCL
from biom3_tpu.tokenizers.synthetic import write_synthetic_wordpiece
from biom3_tpu_torch.config import load_json_config as port_load_json_config
from biom3_tpu_torch.io.from_jax import pencl_from_jax, port_config
from biom3_tpu_torch.models.pencl import PenCL, pencl_state_dict, text_state_dict

REPO = pathlib.Path(__file__).resolve().parent.parent
TOL = dict(atol=2e-4, rtol=1e-3)


def _perturb(tree, seed):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32), tree)


@pytest.fixture(scope="module")
def pencl():
    cfg = PenCLConfig(
        esm=ESM2Config(num_layers=2, embed_dim=64, attention_heads=2),
        bert=BertConfig(num_layers=2, hidden_size=64, num_heads=2, intermediate_size=128,
                        vocab_size=100, max_position_embeddings=64),
        protein_embedding=64, text_embedding=64, proj_dim=32)
    model = JaxPenCL(cfg)
    params = model.init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32),
                        jnp.zeros((1, 8), jnp.int32), method=JaxPenCL.init_all_params)
    params = _perturb(params, 0)
    return cfg, model, params, pencl_from_jax(params, port_config(cfg))


def _inputs(rng, cfg, B=3, Lt=48, Lp=80):
    x_t = rng.integers(0, cfg.bert.vocab_size, (B, Lt)).astype(np.int32)
    x_p = np.full((B, Lp), 1, np.int32)
    for b, n in enumerate((Lp - 2, 30, 55)[:B]):
        x_p[b, 0], x_p[b, 1:n - 1], x_p[b, n - 1] = 0, rng.integers(4, 24, n - 2), 2
    x_p[0, 7] = 32
    return x_t, x_p


def test_pencl_latents_match_flax(pencl):
    cfg, model, params, port = pencl
    x_t, x_p = _inputs(np.random.default_rng(1), cfg)
    want = model.apply(params, jnp.asarray(x_t), jnp.asarray(x_p))
    with torch.no_grad():
        got = port(torch.from_numpy(x_t), torch.from_numpy(x_p))
        z_p = port.encode_protein(torch.from_numpy(x_p))
    for key in ("text_joint_latent", "seq_joint_latent"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), **TOL)
    np.testing.assert_allclose(z_p.numpy(), np.asarray(want["seq_joint_latent"]), **TOL)


def test_compute_scores_matches_jax():
    from biom3_tpu.pipeline.stage1 import compute_scores as jax_compute_scores
    from biom3_tpu_torch.pipeline.stage1 import compute_scores

    rng = np.random.default_rng(2)
    z_p, z_t = (rng.standard_normal((5, 16)).astype(np.float32) for _ in range(2))
    want = jax_compute_scores(jnp.asarray(z_p), jnp.asarray(z_t))
    got = compute_scores(z_p, z_t)
    assert got.keys() == want.keys()
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=1e-5,
                                   rtol=1e-5)


def test_pencl_state_dict_names_every_dropped_key(pencl):
    """The filter drops the reference keys no inference path holds, by
    name; anything else still fails the strict load."""
    cfg, _, params, _ = pencl
    sd = {k: torch.from_numpy(np.array(v)) for k, v in pencl_params_to_torch(params, cfg).items()}
    sd.update(_reference_only_keys(cfg))
    held = set(PenCL(port_config(cfg)).state_dict())
    assert set(pencl_state_dict(sd)) == held
    assert set(text_state_dict(sd)) == {k for k in held if k.startswith("text_")}
    PenCL(port_config(cfg)).load_state_dict(pencl_state_dict(sd), strict=True)
    with pytest.raises(RuntimeError, match="Unexpected key"):
        PenCL(port_config(cfg)).load_state_dict(pencl_state_dict({**sd, "protein_projection.stray":
                                                     torch.zeros(1)}), strict=True)


def _reference_only_keys(cfg) -> dict:
    """Keys of a published PenCL ``.bin`` beyond the Flax tree's export:
    fair-esm's contact head and rotary buffers, BERT's MLM decoder and
    HF's buffers (the export already carries both LM heads)."""
    esm, bert = cfg.esm, cfg.bert
    out = {"protein_encoder.model.contact_head.regression.weight":
           torch.zeros(1, esm.num_layers * esm.attention_heads),
           "protein_encoder.model.contact_head.regression.bias": torch.zeros(1),
           "text_encoder.model.cls.predictions.decoder.weight":
           torch.zeros(bert.vocab_size, bert.hidden_size),
           "text_encoder.model.cls.predictions.decoder.bias": torch.zeros(bert.vocab_size),
           "text_encoder.model.bert.embeddings.position_ids":
           torch.arange(bert.max_position_embeddings)[None]}
    inv_freq = 1.0 / 10000 ** (torch.arange(0, esm.head_dim, 2).float() / esm.head_dim)
    out.update({f"protein_encoder.model.layers.{i}.self_attn.rot_emb.inv_freq": inv_freq
                for i in range(esm.num_layers)})
    return out


@pytest.fixture(scope="module")
def stage1_files(tmp_path_factory):
    """A small stage-1 config and a ``.bin`` in the published layout, made
    from a seeded JAX engine."""
    from biom3_tpu.pipeline.stage1 import PenCLEngine as JaxEngine

    root = tmp_path_factory.mktemp("pencl")
    vocab = write_synthetic_wordpiece(root / "tok")
    cfg = {"protein_encoder_embedding": 64, "text_encoder_embedding": 64,
           "esm_num_layers": 2, "esm_attention_heads": 2, "bert_num_layers": 2,
           "bert_num_heads": 2, "bert_intermediate_size": 128, "bert_vocab_size": vocab,
           "bert_max_position_embeddings": 512, "proj_embedding_dim": 32,
           "text_max_length": 512, "text_model_path": str(root / "tok")}
    (root / "s1.json").write_text(json.dumps(cfg))
    seed_engine = JaxEngine(load_json_config(root / "s1.json"))
    params = _perturb(seed_engine.params, 3)
    sd = {k: torch.from_numpy(np.array(v))
          for k, v in pencl_params_to_torch(params, seed_engine.config).items()}
    sd.update(_reference_only_keys(seed_engine.config))
    save_torch_file(sd, root / "s1.bin")
    return root


def test_engine_tower_paths_agree(stage1_files):
    """fused-stack (the kernels' chain) and graph (the PenCL module with
    the flash kernel's wrapper) give the same latents."""
    from biom3_tpu_torch.pipeline.stage1 import PenCLEngine

    root = stage1_files
    cfg = port_load_json_config(root / "s1.json")
    pairs = (DEMO_CAPTIONS[:3], DEMO_SEQUENCES[:3])
    fused = PenCLEngine(cfg, root / "s1.bin", device="cpu", use_stack=True).embed(
        *pairs, batch_size=2)
    graph = PenCLEngine(cfg, root / "s1.bin", device="cpu", tower_impl="graph",
                        attn_impl="kernel").embed(*pairs)
    for a, b in zip(fused, graph):
        assert a.shape == (3, 32)
        np.testing.assert_allclose(a, b, **TOL)


def test_run_pencl_inference_cli_cpu(stage1_files, tmp_path):
    from biom3_tpu.pipeline.stage1 import PenCLEngine as JaxEngine

    root = stage1_files
    out = tmp_path / "pencl_out.pt"
    env = dict(os.environ)
    env["PYTHONPATH"] = f"{REPO}:{env.get('PYTHONPATH', '')}"
    r = subprocess.run([sys.executable, "-m", "biom3_tpu_torch.cli.run_pencl_inference",
                        "--json_path", str(root / "s1.json"), "--model_path",
                        str(root / "s1.bin"), "--output_path", str(out), "--device", "cpu"],
                       capture_output=True, text=True, env=env, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    for banner in ("=== Inference Results ===", "=== Dot Product Scores Matrix ===",
                   "=== Normalized Probabilities ===",
                   "=== Homology Matrix (Dot Product of Normalized z_p) ===",
                   f"Embeddings saved to {out}"):
        assert banner in r.stdout, banner
    saved = torch.load(out, weights_only=False)
    assert set(saved) == {"sequence", "text_prompts", "z_t", "z_p"}
    assert saved["sequence"] == DEMO_SEQUENCES and saved["text_prompts"] == DEMO_CAPTIONS

    want_t, want_p = JaxEngine(load_json_config(root / "s1.json"),
                               str(root / "s1.bin")).embed(DEMO_CAPTIONS, DEMO_SEQUENCES)
    z_t, z_p = np.asarray(saved["z_t"]), np.asarray(saved["z_p"])
    assert z_t.shape == z_p.shape == (5, 32)
    np.testing.assert_allclose(z_t, want_t, **TOL)
    np.testing.assert_allclose(z_p, want_p, **TOL)


def test_text_only_engine_refuses_protein_path(stage1_files):
    from biom3_tpu_torch.pipeline.stage1 import PenCLEngine

    root = stage1_files
    eng = PenCLEngine(port_load_json_config(root / "s1.json"), root / "s1.bin", device="cpu",
                      text_only=True)
    assert not hasattr(eng.model, "protein_encoder")
    with pytest.raises(ValueError, match="text_only"):
        eng.embed_tokens(np.zeros((1, 4), np.int32), np.zeros((1, 4), np.int32))
    with pytest.raises(ValueError, match="tower_impl"):
        PenCLEngine(port_load_json_config(root / "s1.json"), device="cpu", tower_impl="flax")


def test_full_width_stage1_config_matches_jax(tmp_path):
    """The full-width config that the card's smoke test and throughput
    measurement build reads as ESM2-650M and PubMedBERT-base, in the port
    and in the JAX package alike."""
    from biom3_tpu_torch.cli.measure_pencl import stage1_config
    from biom3_tpu_torch.config import Config as TorchConfig
    from biom3_tpu_torch.config import PenCLConfig as TorchPenCLConfig

    stage1_config(tmp_path)
    want = PenCLConfig.from_stage_config(load_json_config(tmp_path / "stage1.json"))
    got = TorchPenCLConfig.from_stage_config(
        TorchConfig(json.loads((tmp_path / "stage1.json").read_text())))
    assert (want.esm.num_layers, want.esm.embed_dim, want.esm.attention_heads) == (33, 1280, 20)
    assert (want.bert.num_layers, want.bert.hidden_size, want.bert.num_heads) == (12, 768, 12)
    for part in ("esm", "bert"):
        assert vars(getattr(got, part)) == vars(getattr(want, part)), part
    assert (got.proj_dim, got.seq_max_length, got.text_max_length) == (
        want.proj_dim, want.seq_max_length, want.text_max_length)


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: it would measure")
def test_measure_pencl_fails_without_cuda(tmp_path):
    out = tmp_path / "m.json"
    r = subprocess.run([sys.executable, "-m", "biom3_tpu_torch.cli.measure_pencl",
                        "--out", str(out)], cwd=REPO, capture_output=True, text=True,
                       timeout=300)
    assert r.returncode != 0 and "is_available() is false" in r.stderr
    assert not out.exists()

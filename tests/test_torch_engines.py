"""The engines' precision and fallback against the JAX engines (CPU).

* ``dtype=torch.float32``, the engines' default as in the JAX package,
  runs the graph modules (``ProteoScribe``; ``PenCL``/``PenCLText``) with
  erf GELU, no int8 and plain attention, and matches the JAX engine built
  with the same dtype on the same weights: Stage-3 ids at temperature 0
  equal for the same numpy sampling paths, PenCL latents within atol
  2e-4 / rtol 1e-3 (f32 sums taken in another order);
* configs the kernels cannot take — ``n_blocks=2``, head dims 16 and 48 —
  are served the same way, where the port's engines used to raise;
* the shape gates (``stack_supported``, ``tower_supported``), the
  ``use_stack`` override and the CLIs' ``--dtype auto|bf16|f32``.
"""

import json

import numpy as np
import jax
import pytest
import torch

from biom3_tpu.cli.demo_data import DEMO_CAPTIONS, DEMO_SEQUENCES
from biom3_tpu.config import load_json_config
from biom3_tpu.io.export import pencl_params_to_torch, proteoscribe_params_to_torch
from biom3_tpu.io.torch_load import save_torch_file
from biom3_tpu.tokenizers.synthetic import write_synthetic_wordpiece
from biom3_tpu_torch.config import load_json_config as port_load_json_config

TOL = dict(atol=2e-4, rtol=1e-3)
# Stage 3: head dim 32 and a window the kernels tile (the published shape
# class, cut down), then the same with two blocks
STAGE3 = {"num_replicas": 2, "batch_size_sample": 2, "diffusion_steps": 64, "num_classes": 29,
          "text_emb_dim": 16, "transformer_dim": 64, "transformer_heads": 2,
          "transformer_depth": 2, "transformer_blocks": 1, "transformer_local_heads": 1,
          "transformer_local_size": 16}
# PenCL: head dims 32 in both towers, then ESM2 48 and BERT 16
PENCL = {"published": {"protein_encoder_embedding": 64, "esm_attention_heads": 2,
                       "text_encoder_embedding": 64, "bert_num_heads": 2},
         "head_dims_48_16": {"protein_encoder_embedding": 96, "esm_attention_heads": 2,
                             "text_encoder_embedding": 32, "bert_num_heads": 2}}


@pytest.fixture(scope="module", params=[1, 2], ids=["n_blocks1", "n_blocks2"])
def stage3_files(request, tmp_path_factory):
    """A small Stage-3 config with ``n_blocks`` blocks, the seeded JAX f32
    engine at temperature 0 and its ``.bin`` export."""
    from biom3_tpu.pipeline.stage3 import ProteoScribeEngine

    root = tmp_path_factory.mktemp("stage3")
    (root / "s3.json").write_text(json.dumps({**STAGE3, "transformer_blocks": request.param}))
    engine = ProteoScribeEngine(load_json_config(root / "s3.json"), temperature=0.0)
    save_torch_file(proteoscribe_params_to_torch(engine.params, engine.config), root / "s3.bin")
    return root, engine


def test_stage3_f32_engine_takes_graph_and_matches_jax(stage3_files):
    from biom3_tpu_torch.pipeline.stage3 import ProteoScribeEngine

    root, jax_engine = stage3_files
    port = ProteoScribeEngine(port_load_json_config(root / "s3.json"), str(root / "s3.bin"),
                              device="cpu", temperature=0.0)
    assert not port.use_stack and not jax_engine.use_stack
    assert (port.dtype, port.gelu, port.ff_quant, port.proj_quant) == (
        torch.float32, "erf", "none", "none")
    assert port.model.attn_impl == "plain"
    if jax_engine.config.n_blocks == 2:
        assert "n_blocks=2" in port.gate_reason
    rng = np.random.default_rng(0)
    L = jax_engine.config.max_seq_len
    z_c = rng.standard_normal((2, STAGE3["text_emb_dim"])).astype(np.float32)
    paths = np.stack([rng.permutation(L) for _ in range(2)]).astype(np.int32)
    want = jax_engine.sample_batch(z_c, jax.random.key(0), paths=paths)
    got = port.sample_batch(z_c, None, paths=paths)
    np.testing.assert_array_equal(got, want)


def test_stage3_use_stack_and_bf16_on_cpu(stage3_files):
    """``use_stack=True`` forces the stack forward (on the CPU the kernels'
    plain versions in f32, erf, no int8) where one block allows it, and
    raises on two; bf16 on the CPU runs the module in bf16."""
    from biom3_tpu_torch.pipeline.stage3 import ProteoScribeEngine

    root, jax_engine = stage3_files
    cfg = port_load_json_config(root / "s3.json")
    if jax_engine.config.n_blocks == 2:
        with pytest.raises(ValueError, match="one block"):
            ProteoScribeEngine(cfg, str(root / "s3.bin"), device="cpu", use_stack=True)
    else:
        eng = ProteoScribeEngine(cfg, str(root / "s3.bin"), device="cpu", use_stack=True,
                                 temperature=0.0)
        assert eng.use_stack and (eng.dtype, eng.gelu, eng.ff_quant) == (
            torch.float32, "erf", "none")
    eng = ProteoScribeEngine(cfg, str(root / "s3.bin"), device="cpu", dtype=torch.bfloat16,
                             temperature=0.0)
    assert not eng.use_stack and eng.model.transformer.transformer_blocks[0][0].dtype == \
        torch.bfloat16
    ids = eng.sample_batch(np.zeros((2, STAGE3["text_emb_dim"]), np.float32),
                           torch.Generator().manual_seed(0))
    assert ids.shape == (2, jax_engine.config.max_seq_len) and ids.min() >= 0 and ids.max() < 29


@pytest.fixture(scope="module", params=sorted(PENCL))
def pencl_files(request, tmp_path_factory):
    """A small stage-1 config (``PENCL[param]``'s widths), the seeded JAX
    f32 engine and its ``.bin`` export."""
    from biom3_tpu.pipeline.stage1 import PenCLEngine

    root = tmp_path_factory.mktemp("pencl")
    vocab = write_synthetic_wordpiece(root / "tok")
    cfg = {**PENCL[request.param], "esm_num_layers": 2, "bert_num_layers": 2,
           "bert_intermediate_size": 128, "bert_vocab_size": vocab,
           "bert_max_position_embeddings": 512, "proj_embedding_dim": 32,
           "text_max_length": 512, "text_model_path": str(root / "tok")}
    (root / "s1.json").write_text(json.dumps(cfg))
    engine = PenCLEngine(load_json_config(root / "s1.json"))
    save_torch_file(pencl_params_to_torch(engine.params, engine.config), root / "s1.bin")
    return request.param, root, engine


def test_pencl_f32_engine_takes_graph_and_matches_jax(pencl_files):
    from biom3_tpu_torch.pipeline.stage1 import PenCLEngine

    name, root, jax_engine = pencl_files
    port = PenCLEngine(port_load_json_config(root / "s1.json"), str(root / "s1.bin"),
                       device="cpu")
    assert not port.use_fused_stack and port.tower_impl == "graph"
    assert (port.dtype, port.gelu, port.attn_impl) == (torch.float32, "erf", "plain")
    assert {port.ff_quant, port.proj_quant, port.bert_ff_quant, port.bert_proj_quant} == {"none"}
    assert (port.gate_reason == "") == (name == "published")
    pairs = (DEMO_CAPTIONS[:3], DEMO_SEQUENCES[:3])
    want = jax_engine.embed(*pairs)
    got = port.embed(*pairs)
    for a, b in zip(got, want):
        assert a.shape == (3, 32)
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    text = PenCLEngine(port_load_json_config(root / "s1.json"), str(root / "s1.bin"),
                       device="cpu", text_only=True)
    np.testing.assert_allclose(text.embed_text(pairs[0]), np.asarray(want[0]), **TOL)


@pytest.mark.parametrize("kw, ok, reason", [
    ({}, True, ""),
    ({"n_blocks": 2}, False, "n_blocks=2"),
    ({"heads": 1, "local_window": 64, "max_seq_len": 128}, True, ""),
    ({"heads": 4}, False, "head dim 16"),
    ({"dim": 96, "heads": 2}, False, "head dim 48"),
    ({"dim": 128, "heads": 2}, True, ""),
    ({"local_window": 4}, False, "does not tile by 4"),
    ({"local_window": 12, "max_seq_len": 96}, False, "does not tile"),
    ({"local_heads": 0, "max_seq_len": 200}, True, ""),
    ({"dim": 4096, "heads": 64}, True, ""),
])
def test_stack_supported_rules(kw, ok, reason):
    from biom3_tpu_torch.config import ProteoScribeConfig
    from biom3_tpu_torch.models.fused_forward import stack_supported

    base = dict(num_classes=29, dim=64, depth=2, n_blocks=1, heads=2, local_heads=1,
                local_window=16, max_seq_len=64, num_timesteps=64, cond_dim=16)
    got_ok, got_reason = stack_supported(ProteoScribeConfig(**{**base, **kw}))
    assert got_ok == ok and reason in got_reason and (got_reason == "") == ok


@pytest.mark.parametrize("esm, bert, text_only, ok, reason", [
    ((1280, 20), (768, 12, 3072), False, True, ""),        # ESM2-650M, PubMedBERT-base
    ((96, 2), (64, 2, 128), False, False, "ESM2 head dim 48"),
    ((96, 2), (64, 2, 128), True, True, ""),                # the text side alone
    ((64, 2), (32, 2, 128), True, False, "BERT head dim 16"),
    ((64, 2), (64, 2, 136), False, False, "BERT FF width 136"),
    ((2560, 40), (768, 12, 3072), False, True, ""),         # ESM2-3B
    ((2560, 40), (1024, 16, 4096), True, True, ""),         # BERT-large
])
def test_tower_supported_rules(esm, bert, text_only, ok, reason):
    from biom3_tpu_torch.config import BertConfig, ESM2Config, PenCLConfig
    from biom3_tpu_torch.pipeline.stage1 import tower_supported

    cfg = PenCLConfig(esm=ESM2Config(num_layers=1, embed_dim=esm[0], attention_heads=esm[1]),
                      bert=BertConfig(num_layers=1, hidden_size=bert[0], num_heads=bert[1],
                                      intermediate_size=bert[2]),
                      protein_embedding=esm[0], text_embedding=bert[0], proj_dim=32)
    got_ok, got_reason = tower_supported(cfg, text_only=text_only)
    assert got_ok == ok and reason in got_reason


def test_kernel_paths_refuse_f32_on_cuda():
    """The kernels run bf16 on the card: forcing them in f32 raises before
    anything reaches the device."""
    from biom3_tpu_torch.config import Config
    from biom3_tpu_torch.pipeline.stage1 import PenCLEngine
    from biom3_tpu_torch.pipeline.stage3 import ProteoScribeEngine

    with pytest.raises(ValueError, match="bf16"):
        ProteoScribeEngine(Config(STAGE3), device="cuda", use_stack=True)
    with pytest.raises(ValueError, match="bf16"):
        PenCLEngine(Config({"protein_encoder_embedding": 64, "text_encoder_embedding": 64}),
                    device="cuda", tower_impl="fused-stack")
    with pytest.raises(ValueError, match="contradicts"):
        PenCLEngine(Config({}), device="cpu", use_stack=True, tower_impl="graph")


@pytest.mark.parametrize("engine", ["PenCLEngine", "FacilitatorEngine", "ProteoScribeEngine"])
def test_engines_default_to_the_card(engine, monkeypatch):
    """Without ``device`` an engine runs on the card, as the JAX engines on
    the first accelerator; with no card it raises, naming the CPU option,
    and never carries on on the CPU."""
    import importlib

    from biom3_tpu_torch.config import Config

    module = {"PenCLEngine": "stage1", "FacilitatorEngine": "stage2",
              "ProteoScribeEngine": "stage3"}[engine]
    cls = getattr(importlib.import_module(f"biom3_tpu_torch.pipeline.{module}"), engine)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(STAGE3 if engine == "ProteoScribeEngine" else PENCL["published"])
    with pytest.raises(RuntimeError, match='device="cpu"'):
        cls(cfg)
    assert cls(cfg, device="cpu").device == torch.device("cpu")


CLIS = ("run_e2e", "run_server", "run_pencl_inference")


def _cli_args(cli: str) -> list[str]:
    if cli == "run_pencl_inference":
        return ["--json_path", "s1.json", "--model_path", "m.bin", "--output_path", "o.pt"]
    args = [f"--stage{n}_{k}" for n in (1, 2, 3) for k in ("json", "model")]
    args = [a for flag in args for a in (flag, "x")]
    return args + (["--prompts", "p.txt", "--output_path", "o.pt"] if cli == "run_e2e" else [])


@pytest.mark.parametrize("cli", CLIS)
@pytest.mark.parametrize("flag, device, want", [
    (None, "cuda", torch.bfloat16), (None, "cpu", torch.float32),
    ("auto", "cuda:0", torch.bfloat16), ("bf16", "cpu", torch.bfloat16),
    ("f32", "cuda", torch.float32),
])
def test_cli_dtype_flag(cli, flag, device, want):
    """``--dtype`` parses on each inference CLI and resolves as the JAX
    flag does: ``auto`` (the default) is bf16 on cuda, f32 on the CPU."""
    import importlib

    from biom3_tpu_torch.cli.dtype import resolve_dtype

    mod = importlib.import_module(f"biom3_tpu_torch.cli.{cli}")
    args = mod.parse_arguments(_cli_args(cli) + ["--device", device]
                               + ([] if flag is None else ["--dtype", flag]))
    assert args.dtype == (flag or "auto")
    assert resolve_dtype(args.dtype, args.device) == want


@pytest.mark.parametrize("cli", CLIS)
def test_cli_dtype_help_and_choices(cli, capsys):
    import importlib

    mod = importlib.import_module(f"biom3_tpu_torch.cli.{cli}")
    with pytest.raises(SystemExit):
        mod.parse_arguments(["--help"])
    assert "auto = bf16 on cuda, f32 on cpu" in " ".join(capsys.readouterr().out.split())
    with pytest.raises(SystemExit):
        mod.parse_arguments(_cli_args(cli) + ["--dtype", "fp16"])

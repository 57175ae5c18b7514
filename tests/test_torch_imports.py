"""biom3_tpu_torch: import hygiene, its own copies of the JAX package's
pure-Python modules, wrapper argument checks, kernel build setup.

The port must import no JAX and nothing of ``biom3_tpu``; the copies it
keeps (config, tokenizers, torch file I/O, demo data, the export mapping)
must equal the JAX package's modules; its kernel wrappers must refuse
inputs the kernels do not take (on the CPU too, before the plain version
runs); and the kernel build must target sm_90a and write under the
git-ignored ``build/`` directory.
"""

import pathlib
import subprocess
import sys

import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent

SLICE_MODULES = [
    "biom3_tpu_torch",
    "biom3_tpu_torch.config",
    "biom3_tpu_torch.tokenizers",
    "biom3_tpu_torch.io.torch_io",
    "biom3_tpu_torch.io.checkpoint",
    "biom3_tpu_torch.cli.demo_data",
    "biom3_tpu_torch.ops.attn_block",
    "biom3_tpu_torch.ops.layer_block",
    "biom3_tpu_torch.diffusion.oa_ardm",
    "biom3_tpu_torch.training.metrics",
    "biom3_tpu_torch.training.optim",
    "biom3_tpu_torch.training.ema",
    "biom3_tpu_torch.training.state",
    "biom3_tpu_torch.training.stage3_task",
    "biom3_tpu_torch.data.stage3_data",
    "biom3_tpu_torch.data.loader",
    "biom3_tpu_torch.utils.logging",
    "biom3_tpu_torch.cli.run_train_stage3",
    "biom3_tpu_torch.ops._build",
    "biom3_tpu_torch.ops.kernels",
    "biom3_tpu_torch.ops.local_attention",
    "biom3_tpu_torch.ops.linear_attention",
    "biom3_tpu_torch.ops.stage3_layer",
    "biom3_tpu_torch.ops.stack",
    "biom3_tpu_torch.ops.bert_stack",
    "biom3_tpu_torch.ops.rotary",
    "biom3_tpu_torch.ops.attention",
    "biom3_tpu_torch.ops.esm2_stack",
    "biom3_tpu_torch.models.proteoscribe",
    "biom3_tpu_torch.models.fused_forward",
    "biom3_tpu_torch.models.facilitator",
    "biom3_tpu_torch.models.bert",
    "biom3_tpu_torch.models.esm2",
    "biom3_tpu_torch.models.pencl",
    "biom3_tpu_torch.diffusion.sampler",
    "biom3_tpu_torch.io.state_dict",
    "biom3_tpu_torch.io.from_jax",
    "biom3_tpu_torch.pipeline.stage1",
    "biom3_tpu_torch.pipeline.stage2",
    "biom3_tpu_torch.pipeline.stage3",
    "biom3_tpu_torch.cli.run_e2e",
    "biom3_tpu_torch.cli.run_pencl_inference",
    "biom3_tpu_torch.cli.measure_pencl",
    "biom3_tpu_torch.cli.measure_attention",
    "biom3_tpu_torch.cli.measure_rowwise",
    "biom3_tpu_torch.models.layers",
    "biom3_tpu_torch.ops.esm2_block",
    "biom3_tpu_torch.training.stage1_task",
    "biom3_tpu_torch.data.stage1_data",
    "biom3_tpu_torch.cli.run_train_stage1",
    "biom3_tpu_torch.cli.measure_stage1",
    "biom3_tpu_torch.ops.quant",
    "biom3_tpu_torch.serving",
    "biom3_tpu_torch.serving.batcher",
    "biom3_tpu_torch.serving.continuous",
    "biom3_tpu_torch.serving.trajectory",
    "biom3_tpu_torch.serving.server",
    "biom3_tpu_torch.cli.run_server",
    "biom3_tpu_torch.diffusion.inpainting",
    "biom3_tpu_torch.data.stage2_data",
    "biom3_tpu_torch.training.stage2_task",
    "biom3_tpu_torch.cli.run_train_stage2",
    "biom3_tpu_torch.pipeline.sweep",
    "biom3_tpu_torch.cli.run_eval",
    "biom3_tpu_torch.cli.run_supervised",
    "biom3_tpu_torch.parallel",
    "biom3_tpu_torch.parallel.mesh",
    "biom3_tpu_torch.parallel.sharding",
    "biom3_tpu_torch.ops.ring_attention",
    "biom3_tpu_torch.parallel.distributed",
    "biom3_tpu_torch.parallel.tensor",
    "biom3_tpu_torch.training.sharded",
    "biom3_tpu_torch.utils.profiling",
    "biom3_tpu_torch.utils.flops",
    "biom3_tpu_torch.utils.figures",
    "biom3_tpu_torch.utils.animation",
    "biom3_tpu_torch.data.mnist_data",
    "biom3_tpu_torch.tools",
    "biom3_tpu_torch.tools.certify_task",
    "biom3_tpu_torch.tools.certify_int8",
    "biom3_tpu_torch.tools.certify_blocked",
    "biom3_tpu_torch.tools.certify_inpaint",
    "biom3_tpu_torch.tools.parity_check",
    "biom3_tpu_torch.tools.run_sweep",
]


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {SLICE_MODULES!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'flax'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0 and r.stdout.strip() == "ok", r.stderr[-2000:]


def test_port_never_imports_the_jax_package():
    """No ``.py`` under ``biom3_tpu_torch/`` imports ``biom3_tpu`` (not even
    a module of it that loads no JAX), ``jax`` or ``flax``, at any depth."""
    import ast

    bad = []
    for path in sorted((REPO / "biom3_tpu_torch").rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names] if isinstance(node, ast.Import)
                     else [node.module] if isinstance(node, ast.ImportFrom) and node.module
                     else [])
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}" for n in names
                    if n.split(".")[0] in ("biom3_tpu", "jax", "flax", "jaxlib")]
    assert not bad, bad


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py drives the port: besides the standard library, numpy
    and torch it imports biom3_tpu_torch only, never the JAX package."""
    import ast

    tree = ast.parse((REPO / "chip_smoke.py").read_text())
    roots = {a.name.split(".")[0] for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names}
    roots |= {n.module.split(".")[0] for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.module}
    assert roots - set(sys.stdlib_module_names) == {"numpy", "torch", "biom3_tpu_torch"}


@pytest.mark.skipif(torch.cuda.is_available(), reason="a card is present: the smoke would run")
def test_chip_smoke_fails_without_cuda():
    """Without a card the smoke test exits non-zero and prints no result."""
    r = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout and "is_available() is false" in r.stderr


def test_build_targets_sm90a_under_ignored_build_dir():
    from biom3_tpu_torch.ops import _build

    names = {p.name for p in _build.sources()}
    assert {"gemm_bf16.cu", "stage3_attn.cu", "dense_attn.cu", "rowwise.cu", "esm2_attn.cu",
            "flash_attn.cu", "stage3_attn_bwd.cu", "esm2_attn_bwd.cu", "gemm_i8.cu",
            "local_attn.cu"} <= names
    # one nvcc per source (run together), then one link
    for src in _build.sources():
        cmd = _build.compile_command(src, "out.o")
        assert "arch=compute_90a,code=sm_90a" in cmd
        assert {"-c", "-O3", "-fPIC", str(src)} <= set(cmd)
    link = _build.link_command("out.so", ["a.o", "b.o"])
    assert "arch=compute_90a,code=sm_90a" in link and "-shared" in link
    rel = _build.LIB_PATH.relative_to(REPO)
    assert rel.parts[0] == "build" and rel.name == "libbiom3_kernels.so"
    ignored = (REPO / ".gitignore").read_text().split()
    assert "build/" in ignored
    # every C entry point the wrappers call has a declared signature
    src = "".join(p.read_text() for p in _build.sources())
    for name in _build.SIGNATURES:
        assert f"B3_EXPORT int {name}(" in src


def test_c_entry_points_take_their_declared_argument_count():
    """Each C entry point's parameter list is as long as the ctypes
    signature the wrappers call it with (a mismatch shifts every argument
    after it on the card)."""
    from biom3_tpu_torch.ops import _build

    src = "".join(p.read_text() for p in _build.sources())
    for name, argtypes in _build.SIGNATURES.items():
        start = src.index(f"B3_EXPORT int {name}(") + len(f"B3_EXPORT int {name}(")
        params = src[start:src.index(")", start)].strip()
        count = len(params.split(",")) if params and params != "void" else 0
        assert count == len(argtypes), (name, count, len(argtypes))


# --- wrapper argument checks ----------------------------------------------

def _t(*shape, dtype=torch.float32):
    return torch.randn(shape).to(dtype)


def _gemm(**over):
    from biom3_tpu_torch.ops.kernels import gemm_bias_act

    a = dict(a=_t(8, 16), w=_t(16, 24), bias=_t(24))
    a.update(over)
    return gemm_bias_act(a["a"], a["w"], a["bias"])


def _attn3(**over):
    from biom3_tpu_torch.ops.kernels import stage3_attention_core

    a = dict(qkv=_t(2, 32, 48))
    a.update(over)
    return stage3_attention_core(a["qkv"], heads=2, local_heads=1, window=8)


def _attn3_i8(**over):
    from biom3_tpu_torch.ops.kernels import stage3_attention_core_i8

    a = dict(qkv=_t(2, 32, 48))
    a.update(over)
    return stage3_attention_core_i8(a["qkv"], heads=2, local_heads=1, window=8)


def _dense(**over):
    from biom3_tpu_torch.ops.kernels import dense_attention

    a = dict(qkv=_t(2, 16, 48))
    a.update(over)
    return dense_attention(a["qkv"], heads=2)


def _bias_ln(**over):
    from biom3_tpu_torch.ops.kernels import bias_layernorm

    a = dict(h=_t(2, 8, 16), bias=_t(2, 16), scale=_t(16), shift=_t(16))
    a.update(over)
    return bias_layernorm(a["h"], a["bias"], a["scale"], a["shift"])


def _ln(**over):
    from biom3_tpu_torch.ops.kernels import layernorm

    a = dict(x=_t(8, 16), scale=_t(16), shift=_t(16))
    a.update(over)
    return layernorm(a["x"], a["scale"], a["shift"], eps=1e-6, out_dtype=torch.float32)


def _embed(**over):
    from biom3_tpu_torch.ops.kernels import embed_tokens

    a = dict(ids=torch.randint(0, 5, (2, 8), dtype=torch.int32), tok=_t(5, 16),
             pos=_t(8, 16))
    a.update(over)
    return embed_tokens(a["ids"], a["tok"], a["pos"])


def _esm_attn(**over):
    from biom3_tpu_torch.ops.kernels import esm2_attention

    a = dict(qkv=_t(2, 16, 96), pad=torch.zeros(2, 16, dtype=torch.int32), cos=_t(16, 16),
             sin=_t(16, 16))
    a.update(over)
    return esm2_attention(a["qkv"], a["pad"], a["cos"], a["sin"], heads=2)


def _flash(**over):
    from biom3_tpu_torch.ops.kernels import flash_attention

    a = dict(q=_t(2, 2, 16, 32), k=_t(2, 2, 16, 32), v=_t(2, 2, 16, 32),
             mask=torch.zeros(2, 16, dtype=torch.int32))
    a.update(over)
    return flash_attention(a["q"], a["k"], a["v"], a["mask"])


def _esm_embed(**over):
    from biom3_tpu_torch.ops.kernels import esm2_embed

    a = dict(ids=torch.randint(0, 33, (2, 8), dtype=torch.int32), table=_t(33, 16))
    a.update(over)
    return esm2_embed(a["ids"], a["table"])


def _head(**over):
    from biom3_tpu_torch.ops.kernels import gather_head

    a = dict(h=_t(2, 8, 16), pos=torch.randint(0, 8, (2, 3), dtype=torch.int32),
             scale=_t(16), shift=_t(16), head_w=_t(16, 5), head_b=_t(5))
    a.update(over)
    return gather_head(a["h"], a["pos"], a["scale"], a["shift"], a["head_w"], a["head_b"])


def _gemm_dx(**over):
    from biom3_tpu_torch.ops.kernels import gemm_dx

    a = dict(dy=_t(8, 16), w=_t(24, 16), h=_t(8, 24))
    a.update(over)
    return gemm_dx(a["dy"], a["w"], gelu_of=a["h"])


def _gemm_dw(**over):
    from biom3_tpu_torch.ops.kernels import gemm_dw

    a = dict(x=_t(8, 16), dy=_t(8, 24))
    a.update(over)
    return gemm_dw(a["x"], a["dy"])


def _ln_bwd(**over):
    from biom3_tpu_torch.ops.kernels import layernorm_bwd

    a = dict(x=_t(8, 16), dy=_t(8, 16), scale=_t(16), res=_t(8, 16))
    a.update(over)
    return layernorm_bwd(a["x"], a["dy"], a["scale"], residual=a["res"],
                         out_dtype=torch.float32)


def _col_sum(**over):
    from biom3_tpu_torch.ops.kernels import col_sum

    a = dict(x=_t(8, 16))
    a.update(over)
    return col_sum(a["x"])


def _attn3_bwd(**over):
    from biom3_tpu_torch.ops.kernels import stage3_attention_bwd

    a = dict(qkv=_t(2, 32, 48), da=_t(2, 32, 16))
    a.update(over)
    return stage3_attention_bwd(a["qkv"], a["da"], heads=2, local_heads=1, window=8)


def _esm_attn_bwd(**over):
    from biom3_tpu_torch.ops.kernels import esm2_attention_bwd

    a = dict(qkv=_t(2, 16, 96), da=_t(2, 16, 32), pad=torch.zeros(2, 16, dtype=torch.int32),
             cos=_t(16, 16), sin=_t(16, 16))
    a.update(over)
    return esm2_attention_bwd(a["qkv"], a["da"], a["pad"], a["cos"], a["sin"], heads=2)


def _gemm_i8(**over):
    from biom3_tpu_torch.ops.kernels import gemm_i8

    a = dict(a=torch.randint(-127, 128, (8, 32), dtype=torch.int8), sa=_t(8),
             w=torch.randint(-127, 128, (24, 32), dtype=torch.int8), sw=_t(24), bias=_t(24))
    a.update(over)
    return gemm_i8(a["a"], a["sa"], a["w"], a["sw"], a["bias"], out_dtype=torch.float32)


def _quant_rows(**over):
    from biom3_tpu_torch.ops.kernels import quant_rows

    a = dict(x=_t(8, 16))
    a.update(over)
    return quant_rows(a["x"])


def _local(**over):
    from biom3_tpu_torch.ops.kernels import local_window_attention

    a = dict(q=_t(2, 2, 32, 16), k=_t(2, 2, 32, 16), v=_t(2, 2, 32, 16))
    a.update(over)
    return local_window_attention(a["q"], a["k"], a["v"], window=8)


# (wrapper, bad dtype, bad shape, non-contiguous) as keyword overrides
BAD_INPUTS = {
    "gemm_bias_act": (_gemm, dict(a=_t(8, 16, dtype=torch.float64)), dict(w=_t(12, 24)),
                      dict(a=_t(16, 8).t())),
    "stage3_attention_core": (_attn3, dict(qkv=_t(2, 32, 48).int()), dict(qkv=_t(2, 32, 47)),
                              dict(qkv=_t(32, 2, 48).transpose(0, 1))),
    "stage3_attention_core_i8": (_attn3_i8, dict(qkv=_t(2, 32, 48).half()),
                                 dict(qkv=_t(2, 32, 50)), dict(qkv=_t(32, 2, 48).transpose(0, 1))),
    "dense_attention": (_dense, dict(qkv=_t(2, 16, 48).half()), dict(qkv=_t(2, 16, 50)),
                        dict(qkv=_t(16, 2, 48).transpose(0, 1))),
    "bias_layernorm": (_bias_ln, dict(bias=_t(2, 16, dtype=torch.float64)),
                       dict(bias=_t(3, 16)), dict(h=_t(8, 2, 16).transpose(0, 1))),
    "layernorm": (_ln, dict(scale=_t(16, dtype=torch.bfloat16)), dict(shift=_t(15)),
                  dict(x=_t(16, 8).t())),
    "embed_tokens": (_embed, dict(ids=torch.randint(0, 5, (2, 8))), dict(pos=_t(4, 16)),
                     dict(tok=_t(16, 5).t())),
    "gather_head": (_head, dict(head_b=_t(5, dtype=torch.float64)), dict(head_w=_t(15, 5)),
                    dict(h=_t(8, 2, 16).transpose(0, 1))),
    "esm2_attention": (_esm_attn, dict(pad=torch.zeros(2, 16)), dict(cos=_t(16, 32)),
                       dict(qkv=_t(16, 2, 96).transpose(0, 1))),
    "flash_attention": (_flash, dict(k=_t(2, 2, 16, 32, dtype=torch.bfloat16)),
                        dict(v=_t(2, 2, 8, 32)), dict(q=_t(2, 2, 32, 16).transpose(2, 3))),
    "esm2_embed": (_esm_embed, dict(table=_t(33, 16, dtype=torch.float64)),
                   dict(ids=torch.zeros(16, dtype=torch.int32)),
                   dict(table=_t(16, 33).t())),
    "gemm_dx": (_gemm_dx, dict(h=_t(8, 24, dtype=torch.bfloat16)), dict(w=_t(24, 12)),
                dict(dy=_t(16, 8).t())),
    "gemm_dw": (_gemm_dw, dict(dy=_t(8, 24, dtype=torch.float64)), dict(dy=_t(9, 24)),
                dict(x=_t(16, 8).t())),
    "layernorm_bwd": (_ln_bwd, dict(dy=_t(8, 16, dtype=torch.bfloat16)),
                      dict(scale=_t(12)), dict(res=_t(16, 8).t())),
    "col_sum": (_col_sum, dict(x=_t(8, 16).int()), dict(x=_t(16)), dict(x=_t(16, 8).t())),
    "stage3_attention_bwd": (_attn3_bwd, dict(da=_t(2, 32, 16).half()),
                             dict(da=_t(2, 32, 15)), dict(da=_t(32, 2, 16).transpose(0, 1))),
    "esm2_attention_bwd": (_esm_attn_bwd, dict(pad=torch.zeros(2, 16, dtype=torch.int64)),
                           dict(da=_t(2, 16, 48)), dict(da=_t(16, 2, 32).transpose(0, 1))),
    "gemm_i8": (_gemm_i8, dict(a=_t(8, 32)), dict(sw=_t(23)),
                dict(w=torch.randint(-127, 128, (32, 24), dtype=torch.int8).t())),
    "quant_rows": (_quant_rows, dict(x=_t(8, 16).int()), dict(x=_t(16)), dict(x=_t(16, 8).t())),
    "local_window_attention": (_local, dict(k=_t(2, 2, 32, 16, dtype=torch.float64)),
                               dict(q=_t(2, 2, 30, 16)), dict(v=_t(2, 2, 16, 32).transpose(2, 3))),
}


@pytest.mark.parametrize("name", sorted(BAD_INPUTS))
@pytest.mark.parametrize("kind", ["dtype", "shape", "contiguity"])
def test_wrapper_rejects_bad_input(name, kind):
    call, bad_dtype, bad_shape, non_contig = BAD_INPUTS[name]
    call()  # the unmodified arguments are accepted
    override = {"dtype": bad_dtype, "shape": bad_shape, "contiguity": non_contig}[kind]
    with pytest.raises((TypeError, ValueError)) as exc:
        call(**override)
    if kind == "contiguity":
        assert "contiguous" in str(exc.value)


def test_launch_counts_untouched_on_cpu():
    """CPU tensors run the plain versions: no kernel launch is counted."""
    from biom3_tpu_torch.ops import kernels

    kernels.reset_launches()
    for call, *_ in BAD_INPUTS.values():
        call()
    assert set(kernels.launch_counts().values()) == {0}


# --- the port's copies equal the JAX package's modules ----------------------

def test_batcher_copy_equals_the_jax_package():
    """``serving/batcher.py`` is pure Python: the port keeps the classes
    verbatim."""
    import inspect

    from biom3_tpu.serving import batcher as jax_batcher
    from biom3_tpu_torch.serving import batcher

    for name in ("BatcherStats", "MicroBatcher"):
        assert inspect.getsource(getattr(batcher, name)) == \
            inspect.getsource(getattr(jax_batcher, name)), name


def test_supervisor_copy_equals_the_jax_package():
    """``cli/run_supervised.py`` is pure Python: the port's file is the JAX
    package's, its package name aside."""
    jax_src = (REPO / "biom3_tpu" / "cli" / "run_supervised.py").read_text()
    port_src = (REPO / "biom3_tpu_torch" / "cli" / "run_supervised.py").read_text()
    assert port_src == jax_src.replace("biom3_tpu.", "biom3_tpu_torch.")
    r = subprocess.run([sys.executable, "-m", "biom3_tpu_torch.cli.run_supervised",
                        "--max_restarts", "1", "--backoff_s", "0", "--", sys.executable, "-c",
                        "import sys; sys.exit(0 if '--resume' in sys.argv else 3)"],
                       cwd=REPO, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "attempt 1" in r.stdout and "--resume" in r.stdout
    assert "training finished cleanly" in r.stdout


def test_quant_copy_equals_the_jax_package():
    """``ops/quant.py`` is jnp in the JAX package and torch in the port: the
    same functions, bit for bit (and ``tests/test_torch_quant.py`` on ties
    and zero rows)."""
    import jax.numpy as jnp
    import numpy as np

    from biom3_tpu.ops.pallas import quant as jax_quant
    from biom3_tpu_torch.ops import quant

    x = np.random.default_rng(0).standard_normal((4, 32, 24)).astype(np.float32)
    for name, arg in (("quantize_weight_int8", x), ("quant_rows", x[0]), ("quant_cols", x[0])):
        want = getattr(jax_quant, name)(jnp.asarray(arg))
        got = getattr(quant, name)(torch.from_numpy(arg))
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    assert [n for n in dir(jax_quant) if n.startswith("quant")] == \
        [n for n in dir(quant) if n.startswith("quant")]


def test_config_copy_parses_like_the_jax_package(tmp_path):
    import dataclasses
    import json

    from biom3_tpu import config as jax_config
    from biom3_tpu_torch import config

    raw = {"transformer_dim": "256", "transformer_heads": 8, "transformer_local_heads": 3,
           "transformer_local_size": 64, "diffusion_steps": 512, "text_emb_dim": 128,
           "input_dp_rate": "0.1", "emb_dim": 256, "hid_dim": "None",
           "protein_encoder_embedding": 640, "esm_num_layers": 6, "bert_num_layers": 4,
           "weight_decay": "5e-7", "flag": "true", "nested": {"a": 1}}
    (tmp_path / "c.json").write_text(json.dumps(raw))
    got, want = config.load_json_config(tmp_path / "c.json"), jax_config.load_json_config(
        tmp_path / "c.json")
    assert got.to_dict() == want.to_dict()
    assert (got.float("weight_decay"), got.int("hid_dim", 7), got.bool("flag")) == (
        want.float("weight_decay"), want.int("hid_dim", 7), want.bool("flag"))
    for name in ("ProteoScribeConfig", "FacilitatorConfig", "PenCLConfig"):
        mine = getattr(config, name).from_stage_config(got)
        theirs = getattr(jax_config, name).from_stage_config(want)
        assert dataclasses.asdict(mine) == dataclasses.asdict(theirs), name
    for name in ("ESM2Config", "BertConfig", "ProteoScribeConfig", "FacilitatorConfig",
                 "PenCLConfig"):
        assert ([f.name for f in dataclasses.fields(getattr(config, name))]
                == [f.name for f in dataclasses.fields(getattr(jax_config, name))]), name
    with pytest.raises(ValueError):
        config.ProteoScribeConfig(dim=30, heads=4)
    with pytest.raises(ValueError):
        config.ProteoScribeConfig.from_stage_config(config.Config({"transformer_reversible": 1}))


def test_tokenizer_copies_encode_like_the_jax_package(tmp_path):
    from biom3_tpu import native
    from biom3_tpu.tokenizers.stage3_vocab import Stage3Vocab as JaxStage3Vocab
    from biom3_tpu.tokenizers.synthetic import write_synthetic_wordpiece as jax_write
    from biom3_tpu.tokenizers.text import TextTokenizer as JaxTextTokenizer
    from biom3_tpu_torch import tokenizers
    from biom3_tpu_torch.cli.demo_data import DEMO_CAPTIONS, DEMO_SEQUENCES

    proteins = list(DEMO_SEQUENCES) + ["ACDEFGHIKLMNPQRSTVWYXBUZO", "AC-DE-", "", "MKJ?"]
    assert (tokenizers.esm_batch_encode(proteins, 1024)
            == native.esm_batch_encode(proteins, 1024)).all()
    stage3 = [s for s in proteins if "?" not in s and "J" not in s]
    assert (tokenizers.stage3_batch_encode(stage3, 1024)
            == native.stage3_batch_encode(stage3, 1024)).all()
    with pytest.raises(ValueError):
        tokenizers.stage3_batch_encode(["MKJ"], 16)
    with pytest.raises(ValueError):
        tokenizers.stage3_batch_encode(["A" * 15], 16)
    mine, theirs = tokenizers.Stage3Vocab(), JaxStage3Vocab()
    assert (mine.train_tokens, mine.decode_tokens) == (theirs.train_tokens, theirs.decode_tokens)
    assert mine.decode_ids(range(29)) == theirs.decode_ids(range(29))
    assert tokenizers.write_synthetic_wordpiece(tmp_path / "a") == jax_write(tmp_path / "b")
    for f in ("vocab.txt", "tokenizer_config.json"):
        assert (tmp_path / "a" / f).read_text() == (tmp_path / "b" / f).read_text()
    captions = list(DEMO_CAPTIONS) + ["Ünïcödé protein [MASK] kinase!", "x" * 300]
    got = tokenizers.TextTokenizer(str(tmp_path / "a"), max_length=64).batch_encode(captions)
    want = JaxTextTokenizer(str(tmp_path / "b"), max_length=64).batch_encode(captions)
    for k in ("input_ids", "attention_mask"):
        assert (got[k] == want[k]).all(), k


def test_io_and_demo_copies_equal_the_jax_package(tmp_path):
    import numpy as np

    from biom3_tpu.cli import demo_data as jax_demo
    from biom3_tpu.io import torch_load
    from biom3_tpu_torch.cli import demo_data
    from biom3_tpu_torch.io import torch_io

    assert (demo_data.DEMO_ACCESSIONS, demo_data.DEMO_SEQUENCES, demo_data.DEMO_CAPTIONS) == (
        jax_demo.DEMO_ACCESSIONS, jax_demo.DEMO_SEQUENCES, jax_demo.DEMO_CAPTIONS)
    obj = {"model.a": np.arange(6, dtype=np.float32).reshape(2, 3), "model.b": [torch.ones(2)],
           "s": "text", "t": (np.zeros(1), 3)}
    torch_io.save_torch_file(obj, tmp_path / "x.pt")
    got, want = torch_io.load_torch_file(tmp_path / "x.pt"), torch_load.load_torch_file(
        tmp_path / "x.pt")
    assert got.keys() == want.keys() and (got["model.a"] == want["model.a"]).all()
    assert torch_io.strip_prefix(got, "model.").keys() == torch_load.strip_prefix(
        want, "model.").keys()
    wrapped = {"state_dict": {"k": 1}}
    assert torch_io.unwrap_checkpoint(wrapped) == torch_load.unwrap_checkpoint(wrapped)


@pytest.mark.parametrize("which", ["proteoscribe", "facilitator", "esm2", "bert", "pencl"])
def test_export_mapping_copy_equals_the_jax_package(which):
    """The port's numpy Flax → state-dict mapping against
    ``biom3_tpu/io/export.py`` on a random tree of each model: the same keys,
    the same arrays."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from biom3_tpu import config as jc
    from biom3_tpu.io import export
    from biom3_tpu.models.facilitator import Facilitator
    from biom3_tpu.models.pencl import PenCL
    from biom3_tpu.models.proteoscribe import ProteoScribe
    from biom3_tpu_torch.io import from_jax

    key = jax.random.key(0)
    esm = jc.ESM2Config(num_layers=1, embed_dim=32, attention_heads=2)
    bert = jc.BertConfig(num_layers=1, hidden_size=32, num_heads=2, intermediate_size=64,
                         vocab_size=50, max_position_embeddings=16)
    pencl = jc.PenCLConfig(esm=esm, bert=bert, protein_embedding=32, text_embedding=32,
                           proj_dim=16, rep_layer=1, text_max_length=16, seq_max_length=16)
    if which == "proteoscribe":
        cfg = jc.ProteoScribeConfig(dim=32, depth=2, heads=4, local_heads=2, local_window=8,
                                    max_seq_len=16, num_timesteps=16, cond_dim=8)
        tree = ProteoScribe(cfg).init(key, jnp.zeros((1, 16), jnp.int32), jnp.zeros((1,)),
                                      jnp.zeros((1, 8)))
    elif which == "facilitator":
        cfg = jc.FacilitatorConfig(in_dim=8, hid_dim=16, out_dim=8)
        tree = Facilitator(cfg).init(key, jnp.zeros((1, 8)))
    else:
        tree = PenCL(pencl).init(key, jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 8), jnp.int32))
        cfg = {"esm2": esm, "bert": bert, "pencl": pencl}[which]
        sub = {"esm2": "protein_encoder", "bert": "text_encoder"}.get(which)
        tree = tree["params"][sub] if sub else tree
    tree = jax.tree_util.tree_map(np.asarray, tree)
    got = getattr(from_jax, f"{which}_params_to_torch")(tree, cfg)
    want = getattr(export, f"{which}_params_to_torch")(tree, cfg)
    assert got.keys() == want.keys()
    for k in got:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)

"""biom3_tpu_torch: import hygiene, wrapper argument checks, kernel build setup.

The port must import no JAX; its kernel wrappers must refuse inputs the
kernels do not take (on the CPU too, before the plain version runs); and
the kernel build must target sm_90a and write under the git-ignored
``build/`` directory.
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
            "flash_attn.cu"} <= names
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


# (wrapper, bad dtype, bad shape, non-contiguous) as keyword overrides
BAD_INPUTS = {
    "gemm_bias_act": (_gemm, dict(a=_t(8, 16, dtype=torch.float64)), dict(w=_t(12, 24)),
                      dict(a=_t(16, 8).t())),
    "stage3_attention_core": (_attn3, dict(qkv=_t(2, 32, 48).int()), dict(qkv=_t(2, 32, 47)),
                              dict(qkv=_t(32, 2, 48).transpose(0, 1))),
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

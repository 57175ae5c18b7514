"""Build and load the port's CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` into one shared library with a plain C
interface, ``build/biom3_tpu_torch/libbiom3_kernels.so`` at the repository
root (git-ignored).  Each source compiles to an object in its own ``nvcc``
process, all started together, and one more ``nvcc`` links them, so a cold
build takes about as long as the slowest source.  The build runs on first
use only and is keyed on a hash of the sources: a stamp file beside the
library records the hash it was built from.  The library is loaded with
``ctypes``; every pointer and the stream pass as ``c_void_p``.  No PyTorch
header is compiled.

Nothing here runs at import time, so the CPU tests import every module
without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import time

PACKAGE_DIR = pathlib.Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "biom3_tpu_torch"
LIB_PATH = BUILD_DIR / "libbiom3_kernels.so"
PTXAS_REPORT = BUILD_DIR / "ptxas.txt"  # registers, spills, shared memory per kernel
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]

# C entry points: name → argument types (every one returns an int: the
# launches cudaGetLastError(), the ``_grid``/``_capacity`` queries a block count,
# the ``stage3_bwd`` queries a pair count and a workspace size)
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "b3_gemm_bias_act": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "b3_gemm_dx": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "b3_gemm_dw": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "b3_col_sum": [_P, _I, _I, _I, _P, _P, _I, _I, _P],
    "b3_col_sum_capacity": [_I],
    "b3_layernorm_bwd": [_P, _I, _P, _P, _P, _I, _P, _I, _P, _P, _P, _I, _I, _I, _I, _F, _P],
    "b3_layernorm_bwd_grid": [_I, _I, _I, _I, _I],
    "b3_stage3_attention_bwd": [_P] * 5 + [_I] * 7 + [_P],
    "b3_stage3_bwd_lin_max_pairs": [],
    "b3_stage3_bwd_ws_floats": [_I, _I],
    "b3_stage3_attention_core": [_P, _P, _P] + [_I] * 10 + [_P],
    "b3_stage3_attention_i8": [_P] * 10 + [_I] * 11 + [_P],
    "b3_dense_attention": [_P, _P, _I, _I, _I, _I, _P],
    "b3_bias_layernorm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "b3_layernorm": [_P, _I, _P, _P, _P, _P, _I, _I, _F, _P],
    "b3_embed_tokens": [_P, _P, _P, _P, _I, _I, _I, _P],
    "b3_gather_head": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
    "b3_esm2_attention": [_P] * 6 + [_I] * 4 + [_P],
    "b3_esm2_attention_bwd": [_P] * 8 + [_I] * 4 + [_P],
    "b3_flash_attention": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    "b3_esm2_embed": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "b3_gemm_i8": [_P] * 7 + [_I] * 6 + [_P],
    "b3_quant_rows": [_P, _I, _P, _P, _I, _I, _P],
    "b3_local_window_attention": [_P] * 4 + [_I] * 5 + [_F, _I, _P],
}


def sources() -> list[pathlib.Path]:
    return sorted(CSRC_DIR.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256()
    for p in sorted(CSRC_DIR.glob("*.cu*")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()


def nvcc_path() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def compile_command(src: pathlib.Path | str, obj: pathlib.Path | str,
                    nvcc: str = "nvcc") -> list[str]:
    """One source → one relocatable object; ``-Xptxas -v`` reports each
    kernel's registers, spills and shared memory on stderr."""
    return [nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
            "-c", "-o", str(obj), str(src)]


def link_command(out_path: pathlib.Path | str, objs, nvcc: str = "nvcc") -> list[str]:
    return [nvcc, *ARCH_FLAGS, "-shared", "-o", str(out_path), *map(str, objs)]


def build(force: bool = False) -> dict:
    """Compile the library unless the stamp matches the sources: one
    ``nvcc`` per source, all at once, then the link.  The compilers'
    per-kernel reports go to ``PTXAS_REPORT``.  Returns ``{"built": bool,
    "seconds": float}``."""
    digest = source_hash()
    stamp = LIB_PATH.with_suffix(".so.sha256")
    if (not force and LIB_PATH.is_file() and stamp.is_file()
            and stamp.read_text().strip() == digest):
        return {"built": False, "seconds": 0.0}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = pathlib.Path(tmpdir)
        srcs = sources()
        objs = [tmp / f"{src.stem}.o" for src in srcs]
        procs = [subprocess.Popen(compile_command(src, obj, nvcc), stdout=subprocess.PIPE,
                                  stderr=subprocess.PIPE, text=True)
                 for src, obj in zip(srcs, objs)]
        report, failed = [], []
        for src, proc in zip(srcs, procs):
            _, err = proc.communicate()
            report.append(f"== {src.name}\n{err}")
            if proc.returncode != 0:
                failed.append(f"{src.name} ({proc.returncode}):\n{err[-8000:]}")
        if failed:
            raise RuntimeError("nvcc failed: " + "\n".join(failed))
        # link into a temporary name and rename: a concurrent loader never
        # sees a half-written library
        lib_tmp = tmp / LIB_PATH.name
        proc = subprocess.run(link_command(lib_tmp, objs, nvcc), capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
        os.replace(lib_tmp, LIB_PATH)
    stamp.write_text(digest)
    PTXAS_REPORT.write_text("\n".join(report))
    return {"built": True, "seconds": time.perf_counter() - t0}


@functools.cache
def library() -> ctypes.CDLL:
    """Build on first use, load once per process."""
    build()
    lib = ctypes.CDLL(str(LIB_PATH))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def launch(name: str, *args) -> None:
    """Call one C entry point; raise if the launch was refused."""
    err = getattr(library(), name)(*args)
    if err != 0:
        raise RuntimeError(f"{name}: CUDA error {err}")

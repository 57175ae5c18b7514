"""Build and load the port's CUDA kernels.

``csrc/*.cu`` compile with ``nvcc`` into one shared library with a plain C
interface, ``build/biom3_tpu_torch/libbiom3_kernels.so`` at the repository
root (git-ignored).  The build runs on first use only and is keyed on a
hash of the sources: a stamp file beside the library records the hash it
was built from.  The library is loaded with ``ctypes``; every pointer and
the stream pass as ``c_void_p``.  No PyTorch header is compiled, which
keeps a cold build of all the sources to about a minute.

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

# C entry points: name → argument types (every one returns cudaGetLastError())
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
SIGNATURES = {
    "b3_gemm_bias_act": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "b3_stage3_attention_core": [_P, _P, _I, _I, _I, _I, _I, _I, _P],
    "b3_dense_attention": [_P, _P, _I, _I, _I, _I, _P],
    "b3_bias_layernorm": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P],
    "b3_layernorm": [_P, _I, _P, _P, _P, _P, _I, _I, _F, _P],
    "b3_embed_tokens": [_P, _P, _P, _P, _I, _I, _I, _P],
    "b3_gather_head": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _F, _P],
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


def build_command(out_path: pathlib.Path | str, nvcc: str = "nvcc") -> list[str]:
    return [
        nvcc, *ARCH_FLAGS, "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
        "-Xptxas", "-v", "-o", str(out_path), *map(str, sources()),
    ]


def build(force: bool = False) -> dict:
    """Compile the library unless the stamp matches the sources; the
    compiler's per-kernel report goes to ``PTXAS_REPORT``.  Returns
    ``{"built": bool, "seconds": float}``."""
    digest = source_hash()
    stamp = LIB_PATH.with_suffix(".so.sha256")
    if (not force and LIB_PATH.is_file() and stamp.is_file()
            and stamp.read_text().strip() == digest):
        return {"built": False, "seconds": 0.0}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # build into a temporary name and rename: a concurrent loader never
    # sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    t0 = time.perf_counter()
    proc = subprocess.run(build_command(tmp, nvcc_path()), capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr[-8000:]}")
    os.replace(tmp, LIB_PATH)
    stamp.write_text(digest)
    PTXAS_REPORT.write_text(proc.stderr)
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

"""Online text→protein serving daemon on PyTorch/CUDA.

Port of ``biom3_tpu/cli/run_server.py``: the same flags and presets, plus
``--device`` (default ``cuda``, with no CPU fallback) and ``--dtype``
(``cli/dtype.py``: ``auto`` = bf16 on cuda, f32 on cpu).  It loads the three
stages once and serves concurrent HTTP requests (``serving.BioM3Server``)
with chunk-boundary continuous batching for exact mode and the
row-granular trajectory scheduler for the fast modes (blocked path order,
confidence order, MaskGIT); in bf16 the engines
serve on the kernels in int8 by default, in f32 through the PyTorch
modules.  On ``cuda`` the kernels are built and loaded
before the server binds its port, so no client waits on the build.

  python -m biom3_tpu_torch.cli.run_server --device cuda \\
      --stage1_json ... --stage1_model ... \\
      --stage2_json ... --stage2_model ... \\
      --stage3_json ... --stage3_model ... \\
      --port 8000 --rows_per_dispatch 16

  curl -s localhost:8000/healthz
  curl -s -X POST localhost:8000/v1/generate \\
      -d '{"prompt": "membrane transport protein", "num_replicas": 3}'
  curl -s -X POST localhost:8000/v1/inpaint \\
      -d '{"prompt": "membrane transport protein", "sequence": "MK??LLV?A"}'

``/v1/inpaint`` runs the packed confidence-order inpainter, or, with
``--continuous_inpaint``, rows on the continuous generate scheduler (exact
mode only); under ``--preset throughput`` (MaskGIT) its rows share the
generate dispatches.

``--mesh_dp``/``--mesh_fsdp`` above 1 spread each Stage-3 dispatch's rows
over a (dp, fsdp) mesh (``parallel/mesh.py``; ``--rows_per_dispatch`` must
be a multiple of their product): with ``--device cuda`` over that many
cards, which must be there; with ``--device cpu`` over positions that share
the CPU, as the JAX CLI's CPU runs get virtual devices.
"""

from __future__ import annotations

import argparse
import signal

from biom3_tpu_torch.cli.dtype import add_dtype_argument, resolve_dtype
from biom3_tpu_torch.config import load_json_config

# Serving bundles, as the JAX CLI's: each sets the flags below unless the
# flag was given.  quality = the reference's exact OA-ARDM semantics;
# latency = blocked k=8 at temperature 0 on the trajectory scheduler;
# throughput = MaskGIT, 16 forwards a design, on the trajectory scheduler.
PRESETS = {
    "quality": {
        "sampler": "ardm", "decode_order": "path", "temperature": 1.0,
        "positions_per_step": 1, "chunk_steps": 64,
        "rows_per_dispatch": 32, "continuous": "on",
    },
    "latency": {
        "sampler": "ardm", "decode_order": "path", "temperature": 0.0,
        "positions_per_step": 8, "chunk_steps": 16,
        "rows_per_dispatch": 32, "continuous": "off",
    },
    "throughput": {
        "sampler": "maskgit", "maskgit_steps": 16, "temperature": 1.0,
        "rows_per_dispatch": 32, "continuous": "off",
    },
}

# The flags a preset may set: parsed with a None sentinel, so a flag given
# explicitly — even at its default value — is told apart from one left out
# and beats the preset; these defaults fill what neither set.
DEFAULTS = {
    "rows_per_dispatch": 16, "temperature": 1.0, "positions_per_step": 1,
    "decode_order": "path", "sampler": "ardm", "maskgit_steps": 16, "chunk_steps": 64,
    "continuous": "auto",
}


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(description="BioM3 serving daemon (PyTorch/CUDA)")
    for stage in (1, 2, 3):
        p.add_argument(f"--stage{stage}_json", type=str, required=True)
        p.add_argument(f"--stage{stage}_model", type=str, required=True)
    p.add_argument("--preset", choices=sorted(PRESETS), default=None,
                   help="config bundle (quality: exact reference ARDM; latency: blocked "
                        "k=8 temperature 0; throughput: maskgit, 16 steps).  Explicit flags "
                        "override preset values")
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--rows_per_dispatch", type=int, default=None,
                   help="fixed Stage-3 device batch (prompt×replica rows); default 16")
    p.add_argument("--num_replicas", type=int, default=2,
                   help="default replicas per prompt when the request doesn't specify")
    p.add_argument("--max_wait_ms", type=float, default=50.0,
                   help="batch coalescing window after the first request")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--embed_cache", type=int, default=4096,
                   help="prompt → (z_t, z_c) LRU entries; 0 disables")
    p.add_argument("--temperature", type=float, default=None, help="default 1.0")
    p.add_argument("--positions_per_step", type=int, default=None,
                   help=">1 enables blocked fast decoding; default 1")
    p.add_argument("--ff-quant", choices=["auto", "none", "int8"], default="auto",
                   help="Stage-3 FF matmuls in int8 (auto: int8 in bf16 on cuda)")
    p.add_argument("--proj-quant", choices=["auto", "none", "int8"], default="auto",
                   help="Stage-3 q/k/v/out projections in int8 (auto: int8 in bf16 on cuda)")
    p.add_argument("--decode_order", choices=["path", "confidence"], default=None)
    p.add_argument("--sampler", choices=["ardm", "maskgit"], default=None)
    p.add_argument("--maskgit_steps", type=int, default=None)
    p.add_argument("--mesh_dp", type=int, default=1)
    p.add_argument("--mesh_fsdp", type=int, default=1)
    p.add_argument("--chunk_steps", type=int, default=None,
                   help="sampler chunk (outer steps): the continuous batcher's admission "
                        "granularity; default 64")
    p.add_argument("--continuous", choices=["auto", "on", "off"], default=None,
                   help="chunk-boundary continuous batching for generate (auto: on for exact "
                        "path-order ARDM, off for the maskgit/confidence fast modes)")
    p.add_argument("--continuous_inpaint", action="store_true",
                   help="route inpaint through the continuous scheduler (random-order "
                        "resume, sharing dispatches with generate; default: the packed "
                        "confidence-order inpainter)")
    p.add_argument("--packed_scheduler", choices=["trajectory", "micro"],
                   default="trajectory",
                   help="scheduler for non-continuous generate: the row-granular "
                        "TrajectoryBatcher (default) or the request-granular MicroBatcher")
    p.add_argument("--warmup", action="store_true",
                   help="one dummy dispatch of every serving path before accepting traffic")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels in bf16, int8 by default) or cpu")
    add_dtype_argument(p)
    args = p.parse_args(argv)
    for flag, value in {**DEFAULTS, **PRESETS.get(args.preset, {})}.items():
        if getattr(args, flag) is None:
            setattr(args, flag, value)
    return args


def build_mesh(args):
    """The Stage-3 mesh of ``--mesh_dp``/``--mesh_fsdp``, or None for one
    device (JAX run_server.py:157-161): every position a card of its own on
    ``cuda`` (too few cards raise), the CPU for every position on ``cpu``."""
    n = args.mesh_dp * args.mesh_fsdp
    if n == 1:
        return None
    import torch

    from biom3_tpu_torch.parallel.mesh import MeshConfig, make_mesh

    device = torch.device(args.device)
    cfg = MeshConfig(dp=args.mesh_dp, fsdp=args.mesh_fsdp)
    return make_mesh(cfg, None if device.type == "cuda" else [device] * n)


def build_server(args, mesh=None):
    """Engines → ``ServingPipeline`` → ``BioM3Server`` (bound to its port).
    ``mesh`` serves Stage 3 on it in place of the flags' mesh (positions
    that share a card, say)."""
    import torch

    from biom3_tpu_torch.pipeline.stage1 import PenCLEngine
    from biom3_tpu_torch.pipeline.stage2 import FacilitatorEngine
    from biom3_tpu_torch.pipeline.stage3 import ProteoScribeEngine
    from biom3_tpu_torch.serving import BioM3Server, ServingPipeline

    if torch.device(args.device).type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--device cuda: no CUDA device is available")
        from biom3_tpu_torch.ops import _build

        _build.library()   # build and load the kernels before the port is bound
    dtype = resolve_dtype(args.dtype, args.device)
    s1 = PenCLEngine(load_json_config(args.stage1_json), args.stage1_model, device=args.device,
                     dtype=dtype, text_only=True)
    s2 = FacilitatorEngine(load_json_config(args.stage2_json), args.stage2_model,
                           device=args.device)
    s3 = ProteoScribeEngine(
        load_json_config(args.stage3_json), args.stage3_model, device=args.device, dtype=dtype,
        temperature=args.temperature, chunk_steps=args.chunk_steps,
        positions_per_step=args.positions_per_step,
        ff_quant=None if args.ff_quant == "auto" else args.ff_quant,
        proj_quant=None if args.proj_quant == "auto" else args.proj_quant,
        decode_order=args.decode_order, sampler_mode=args.sampler,
        maskgit_steps=args.maskgit_steps)
    pipeline = ServingPipeline(s1, s2, s3, rows_per_dispatch=args.rows_per_dispatch,
                               default_replicas=args.num_replicas, seed=args.seed,
                               embed_cache=args.embed_cache,
                               mesh=build_mesh(args) if mesh is None else mesh)
    return BioM3Server(pipeline, host=args.host, port=args.port,
                       max_wait_s=args.max_wait_ms / 1000.0,
                       continuous=None if args.continuous == "auto" else args.continuous == "on",
                       continuous_inpaint=args.continuous_inpaint,
                       packed_scheduler=args.packed_scheduler)


def main(argv=None) -> None:
    args = parse_arguments(argv)
    server = build_server(args)
    if args.warmup:
        print("warming up...", flush=True)
        print(f"warmup done: {server.warmup()}", flush=True)
    print(f"serving on http://{server.host}:{server.port}", flush=True)

    def shutdown(signum, frame):
        # leave serve_forever on this thread; close() runs after it returns
        print(f"signal {signum}: shutting down", flush=True)
        raise SystemExit(0)

    signal.signal(signal.SIGTERM, shutdown)
    try:
        server.serve_forever()
    except (KeyboardInterrupt, SystemExit):
        pass
    finally:
        server.close()   # drains in-flight work, fails stranded futures


if __name__ == "__main__":
    main()

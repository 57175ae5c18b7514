"""Unified text→protein pipeline CLI on PyTorch/CUDA.

Port of ``biom3_tpu/cli/run_e2e.py``: the same flags, prints and ``.pt``
output, plus ``--device`` (default ``cuda``).  On ``cuda`` the engines run
bf16 on the port's kernels; on ``cpu`` they run f32 on the kernels' plain
versions.

  python -m biom3_tpu_torch.cli.run_e2e --device cuda \\
      --stage1_json ... --stage1_model ... \\
      --stage2_json ... --stage2_model ... \\
      --stage3_json ... --stage3_model ... \\
      --prompts prompts.txt --output_path out.pt
"""

from __future__ import annotations

import argparse

from biom3_tpu.io.torch_load import save_torch_file
from biom3_tpu_torch.config import load_json_config


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(description="BioM3 end-to-end text→protein (PyTorch/CUDA)")
    for stage in (1, 2, 3):
        p.add_argument(f"--stage{stage}_json", type=str, required=True)
        p.add_argument(f"--stage{stage}_model", type=str, required=True)
    p.add_argument("--prompts", type=str, required=True,
                   help="text file, one caption per line")
    p.add_argument("--output_path", type=str, required=True)
    p.add_argument("--num_replicas", type=int, default=None)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--positions_per_step", type=int, default=1,
                   help=">1 enables blocked fast decoding (k-fold fewer forwards)")
    p.add_argument("--ff-quant", choices=["auto", "none", "int8"], default="auto",
                   help="Stage-3 FF matmuls in int8 (not ported: only auto/none run)")
    p.add_argument("--proj-quant", choices=["auto", "none", "int8"], default="auto",
                   help="Stage-3 q/k/v/out projections in int8 (not ported: only "
                        "auto/none run)")
    p.add_argument("--decode_order", choices=["path", "confidence"], default="path")
    p.add_argument("--sampler", choices=["ardm", "maskgit"], default="ardm")
    p.add_argument("--maskgit_steps", type=int, default=16)
    p.add_argument("--inpaint_sequence", type=str, default=None,
                   help="partial design to fill (not ported yet)")
    p.add_argument("--inpaint_unknown", type=str, default="?")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda: bf16 on the port's kernels; cpu: f32 plain versions")
    return p.parse_args(argv)


def _refuse_unported(args) -> None:
    """The JAX CLI's paths that the port does not have yet, and where they wait."""
    if args.inpaint_sequence is not None:
        raise NotImplementedError("--inpaint_sequence is not ported yet (ROADMAP queue 1, item 7)")
    if args.sampler == "maskgit":
        raise NotImplementedError("--sampler maskgit is not ported yet (ROADMAP queue 1, item 2)")
    if args.decode_order == "confidence":
        raise NotImplementedError("--decode_order confidence is not ported yet "
                                  "(ROADMAP queue 1, item 2)")
    if "int8" in (args.ff_quant, args.proj_quant):
        raise NotImplementedError("int8 serving quantization is not ported yet "
                                  "(ROADMAP queue 2, item 2)")


def main(argv=None) -> None:
    from biom3_tpu_torch.pipeline.stage1 import PenCLEngine
    from biom3_tpu_torch.pipeline.stage2 import FacilitatorEngine
    from biom3_tpu_torch.pipeline.stage3 import ProteoScribeEngine

    args = parse_arguments(argv)
    _refuse_unported(args)
    with open(args.prompts) as f:
        prompts = [line.strip() for line in f if line.strip()]
    print(f"{len(prompts)} prompts")

    s1 = PenCLEngine(load_json_config(args.stage1_json), args.stage1_model,
                     device=args.device, text_only=True)
    z_t = s1.embed_text(prompts)
    print(f"z_t: {z_t.shape}")

    s2 = FacilitatorEngine(load_json_config(args.stage2_json), args.stage2_model,
                           device=args.device)
    z_c = s2(z_t)
    print(f"z_c: {z_c.shape}")

    s3 = ProteoScribeEngine(load_json_config(args.stage3_json), args.stage3_model,
                            device=args.device, temperature=args.temperature,
                            positions_per_step=args.positions_per_step)
    sequences = s3.generate_sequences(z_c, num_replicas=args.num_replicas, seed=args.seed)

    result = {"prompts": prompts, "z_t": z_t, "z_c": z_c, "sequences": sequences}
    save_torch_file(result, args.output_path)
    print(f"Saved {args.output_path}")


if __name__ == "__main__":
    main()

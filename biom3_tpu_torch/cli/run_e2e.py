"""Unified text→protein pipeline CLI on PyTorch/CUDA.

Port of ``biom3_tpu/cli/run_e2e.py``: the same flags, prints and ``.pt``
output, plus ``--device`` (default ``cuda``) and ``--dtype`` (``cli/dtype.py``:
``auto`` = bf16 on cuda, f32 on cpu).  In bf16 on ``cuda`` the engines run
the port's kernels, in int8 by default (``--ff-quant`` and ``--proj-quant``
reach Stage 3 only, as in the JAX CLI; the text tower's int8 is its
engine's default); in f32 they run the PyTorch modules (erf GELU, no int8)
on either device.  ``--sampler maskgit`` (``--maskgit_steps`` forwards) and
``--decode_order confidence`` run the fast modes.  ``--inpaint_sequence``
fills each ``--inpaint_unknown`` character of a partial design, keeping its
residues and length, for every prompt (``ProteoScribeEngine.inpaint_batch``:
the confidence-order inpainter, or MaskGIT resuming from it); prompt i's
replicas draw from the seed ``--seed`` + i.

  python -m biom3_tpu_torch.cli.run_e2e --device cuda \\
      --stage1_json ... --stage1_model ... \\
      --stage2_json ... --stage2_model ... \\
      --stage3_json ... --stage3_model ... \\
      --prompts prompts.txt --output_path out.pt
"""

from __future__ import annotations

import argparse

import numpy as np

from biom3_tpu_torch.cli.dtype import add_dtype_argument, resolve_dtype
from biom3_tpu_torch.config import load_json_config
from biom3_tpu_torch.io.torch_io import save_torch_file


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
                   help="Stage-3 FF matmuls in int8 (auto: int8 in bf16 on cuda, else none)")
    p.add_argument("--proj-quant", choices=["auto", "none", "int8"], default="auto",
                   help="Stage-3 q/k/v/out projections in int8 (auto: int8 in bf16 on cuda)")
    p.add_argument("--decode_order", choices=["path", "confidence"], default="path",
                   help="confidence = easy-first decoding (with --positions_per_step > 1)")
    p.add_argument("--sampler", choices=["ardm", "maskgit"], default="ardm",
                   help="maskgit = parallel iterative re-masking (--maskgit_steps forwards "
                        "instead of L)")
    p.add_argument("--maskgit_steps", type=int, default=16)
    p.add_argument("--inpaint_sequence", type=str, default=None,
                   help="partial design: fill each --inpaint_unknown character conditioned "
                        "on the prompt, keeping the committed residues and the length "
                        "(instead of free generation)")
    p.add_argument("--inpaint_unknown", type=str, default="?",
                   help="single character marking unknowns in --inpaint_sequence")
    p.add_argument("--device", type=str, default="cuda",
                   help="cuda (the kernels in bf16) or cpu")
    add_dtype_argument(p)
    return p.parse_args(argv)


def inpaint(s3, z_c: np.ndarray, sequence: str, unknown: str, num_replicas: int | None,
            seed: int) -> dict:
    """One ``encode_partial`` row, repeated once a replica, filled for each
    prompt's z_c with a generator seeded ``seed + i`` → replica → one
    cleaned sequence a prompt."""
    import torch

    L = s3.config.max_seq_len
    n_rep = num_replicas or s3.stage_config.int("num_replicas", 5)
    masked = np.stack([s3.vocab.encode_partial(sequence, L, unknown)] * n_rep)
    sequences = {f"replica_{k}": [] for k in range(n_rep)}
    for i, z in enumerate(np.atleast_2d(z_c)):
        generator = torch.Generator(device=s3.device).manual_seed(seed + i)
        ids = s3.inpaint_batch(masked, np.tile(z[None, :], (n_rep, 1)), generator)
        for k in range(n_rep):
            sequences[f"replica_{k}"].append(s3.vocab.clean_sequence(s3.vocab.decode_ids(ids[k])))
    return sequences


def main(argv=None) -> None:
    from biom3_tpu_torch.pipeline.stage1 import PenCLEngine
    from biom3_tpu_torch.pipeline.stage2 import FacilitatorEngine
    from biom3_tpu_torch.pipeline.stage3 import ProteoScribeEngine

    args = parse_arguments(argv)
    dtype = resolve_dtype(args.dtype, args.device)
    with open(args.prompts) as f:
        prompts = [line.strip() for line in f if line.strip()]
    print(f"{len(prompts)} prompts")

    s1 = PenCLEngine(load_json_config(args.stage1_json), args.stage1_model,
                     device=args.device, dtype=dtype, text_only=True)
    z_t = s1.embed_text(prompts)
    print(f"z_t: {z_t.shape}")

    s2 = FacilitatorEngine(load_json_config(args.stage2_json), args.stage2_model,
                           device=args.device)
    z_c = s2(z_t)
    print(f"z_c: {z_c.shape}")

    s3 = ProteoScribeEngine(load_json_config(args.stage3_json), args.stage3_model,
                            device=args.device, dtype=dtype, temperature=args.temperature,
                            positions_per_step=args.positions_per_step,
                            ff_quant=None if args.ff_quant == "auto" else args.ff_quant,
                            proj_quant=None if args.proj_quant == "auto" else args.proj_quant,
                            decode_order=args.decode_order, sampler_mode=args.sampler,
                            maskgit_steps=args.maskgit_steps)
    if args.inpaint_sequence is not None:
        sequences = inpaint(s3, z_c, args.inpaint_sequence, args.inpaint_unknown,
                            args.num_replicas, args.seed)
    else:
        sequences = s3.generate_sequences(z_c, num_replicas=args.num_replicas, seed=args.seed)

    result = {"prompts": prompts, "z_t": z_t, "z_c": z_c, "sequences": sequences}
    save_torch_file(result, args.output_path)
    print(f"Saved {args.output_path}")


if __name__ == "__main__":
    main()

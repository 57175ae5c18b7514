"""Stage-3 CLI on PyTorch/CUDA: ProteoScribe conditional sequence generation.

Port of ``biom3_tpu/cli/run_proteoscribe_sample.py``: the reference's flags
(--json_path --model_path --input_path --output_path), the JAX CLI's
sampling flags and prints, and the sequences saved to ``--output_path``
(the reference accepts it but never writes it, SURVEY.md Q4); plus
``--device`` (default ``cuda``).  ``--dtype`` (``cli/dtype.py``): ``auto``
is bf16 on cuda — the stack forward on the port's kernels, int8 unless
``--ff-quant``/``--proj-quant`` say otherwise — and f32 on the CPU, the
``ProteoScribe`` module.  ``--legacy-batch-update`` needs the full logit
grid and runs the module.

  python -m biom3_tpu_torch.cli.run_proteoscribe_sample --device cuda \\
      --json_path stage3.json --model_path proteoscribe.bin \\
      --input_path facilitator_out.pt --output_path designs.pt --sampler maskgit
"""

from __future__ import annotations

import argparse

from biom3_tpu_torch.cli.dtype import add_dtype_argument, resolve_dtype
from biom3_tpu_torch.config import load_json_config
from biom3_tpu_torch.io.torch_io import load_torch_file, save_torch_file


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="BioM3 Inference Script (Stage 3, PyTorch/CUDA)")
    parser.add_argument("--json_path", type=str, required=True)
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--input_path", type=str, required=True)
    parser.add_argument("--output_path", type=str, required=True)
    parser.add_argument("--seed", type=int, default=None,
                        help="sampling seed (defaults to config 'seed')")
    parser.add_argument("--temperature", type=float, default=1.0,
                        help="0 = deterministic argmax decoding")
    parser.add_argument("--legacy-batch-update", action="store_true",
                        help="reproduce the reference's batched-update quirk (Q5)")
    parser.add_argument("--positions-per-step", type=int, default=1,
                        help=">1 enables blocked any-order decoding (k-fold fewer forwards)")
    parser.add_argument("--ff-quant", choices=["auto", "none", "int8"], default="auto",
                        help="Stage-3 FF matmuls in int8 (auto: int8 in bf16 on cuda)")
    parser.add_argument("--proj-quant", choices=["auto", "none", "int8"], default="auto",
                        help="q/k/v/out projections in int8 (auto: int8 in bf16 on cuda)")
    parser.add_argument("--top-k", type=int, default=None,
                        help="truncate sampling to the k most likely tokens")
    parser.add_argument("--top-p", type=float, default=None, help="nucleus sampling threshold")
    parser.add_argument("--decode-order", choices=["path", "confidence"], default="path",
                        help="path = the reference's random order; confidence = easy-first")
    parser.add_argument("--sampler", choices=["ardm", "maskgit"], default="ardm",
                        help="ardm = the reference's L sequential steps; maskgit = parallel "
                             "iterative re-masking (--maskgit-steps forwards in all)")
    parser.add_argument("--maskgit-steps", type=int, default=16)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda (the kernels in bf16) or cpu")
    add_dtype_argument(parser)
    return parser.parse_args(argv)


def main(argv=None) -> None:
    from biom3_tpu_torch.pipeline.stage3 import ProteoScribeEngine

    args = parse_arguments(argv)
    config = load_json_config(args.json_path)
    engine = ProteoScribeEngine(
        config, args.model_path, device=args.device,
        dtype=resolve_dtype(args.dtype, args.device),
        temperature=args.temperature, legacy_batch_update=args.legacy_batch_update,
        positions_per_step=args.positions_per_step,
        ff_quant=None if args.ff_quant == "auto" else args.ff_quant,
        proj_quant=None if args.proj_quant == "auto" else args.proj_quant,
        top_k=args.top_k, top_p=args.top_p, decode_order=args.decode_order,
        sampler_mode=args.sampler, maskgit_steps=args.maskgit_steps)

    embedding_dataset = load_torch_file(args.input_path)
    seed = args.seed if args.seed is not None else config.int("seed", 0)
    design_sequence_dict = engine.generate_sequences(embedding_dataset["z_c"], seed=seed)

    print(f"{design_sequence_dict=}")
    save_torch_file(design_sequence_dict, args.output_path)
    print(f"Generated sequences saved to {args.output_path}")


if __name__ == "__main__":
    main()

"""Stage-2 CLI on PyTorch/CUDA: Facilitator inference (z_t → z_c) with
diagnostics.

Port of ``biom3_tpu/cli/run_facilitator_sample.py``: the reference's flags
(--input_data_path --output_data_path --model_path --json_path), the same
norm / MSE / MMD block, and the dataset saved with 'z_c' added; plus
``--device`` (default ``cuda``).  The Facilitator runs in f32 on any device.

  python -m biom3_tpu_torch.cli.run_facilitator_sample --device cuda \\
      --json_path stage2.json --model_path facilitator.bin \\
      --input_data_path pencl_out.pt --output_data_path facilitator_out.pt
"""

from __future__ import annotations

import argparse

from biom3_tpu_torch.config import load_json_config
from biom3_tpu_torch.io.torch_io import load_torch_file, save_torch_file


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="BioM3 Facilitator Model (Stage 2, PyTorch/CUDA)")
    parser.add_argument("--input_data_path", type=str, required=True)
    parser.add_argument("--output_data_path", type=str, required=True)
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--json_path", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda", help="cuda or cpu")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    from biom3_tpu_torch.pipeline.stage2 import FacilitatorEngine

    args = parse_arguments(argv)
    engine = FacilitatorEngine(load_json_config(args.json_path), args.model_path,
                               device=args.device)
    out, m = engine.run_dataset(load_torch_file(args.input_data_path))

    z_t, z_p, z_c = out["z_t"], out["z_p"], out["z_c"]
    print("\n=== Facilitator Model Output ===")
    print(f"Shape of z_t (Text Embeddings): {tuple(z_t.shape)}")
    print(f"Shape of z_p (Protein Embeddings): {tuple(z_p.shape)}")
    print(f"Shape of z_c (Facilitated Embeddings): {tuple(z_c.shape)}\n")
    print("=== Norm (L2 Magnitude) Results for Batch Index 0 ===")
    print(f"Norm of z_t (Text Embedding): {m['norm_z_t']:.6f}")
    print(f"Norm of z_p (Protein Embedding): {m['norm_z_p']:.6f}")
    print(f"Norm of z_c (Facilitated Embedding): {m['norm_z_c']:.6f}")
    print("\n=== Mean Squared Error (MSE) Results ===")
    print(f"MSE between Facilitated Embeddings (z_c) and Protein Embeddings (z_p): {m['mse_zc_zp']:.6f}")
    print(f"MSE between Text Embeddings (z_t) and Protein Embeddings (z_p): {m['mse_zt_zp']:.6f}")
    print("\n=== Max Mean Discrepancy (MMD) Results ===")
    print(f"MMD between Facilitated Embeddings (z_c) and Protein Embeddings (z_p): {m['mmd_zc_zp']:.6f}")
    print(f"MMD between Text Embeddings (z_t) and Protein Embeddings (z_p): {m['mmd_zp_zt']:.6f}")

    save_torch_file(out, args.output_data_path)
    print(f"\nFacilitator embeddings saved to {args.output_data_path}")


if __name__ == "__main__":
    main()

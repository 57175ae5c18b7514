"""Stage-1 CLI on PyTorch/CUDA: PenCL inference on the built-in 5-pair demo.

Port of ``biom3_tpu/cli/run_pencl_inference.py``: the same flags
(--json_path --model_path --output_path), prints and
``{'sequence','text_prompts','z_t','z_p'}`` ``.pt`` dict, plus ``--device``
(default ``cuda``).  On ``cuda`` both towers run bf16 on the port's kernels;
on ``cpu`` they run f32 on the kernels' plain versions.

  python -m biom3_tpu_torch.cli.run_pencl_inference --device cuda \\
      --json_path stage1.json --model_path pencl.bin --output_path pencl_out.pt
"""

from __future__ import annotations

import argparse

from biom3_tpu.cli.demo_data import DEMO_CAPTIONS, DEMO_SEQUENCES
from biom3_tpu.io.torch_load import save_torch_file
from biom3_tpu_torch.config import load_json_config


def parse_arguments(argv=None):
    parser = argparse.ArgumentParser(description="BioM3 Inference Script (Stage 1, PyTorch/CUDA)")
    parser.add_argument("--json_path", type=str, required=True)
    parser.add_argument("--model_path", type=str, required=True)
    parser.add_argument("--output_path", type=str, required=True)
    parser.add_argument("--device", type=str, default="cuda",
                        help="cuda: bf16 on the port's kernels; cpu: f32 plain versions")
    return parser.parse_args(argv)


def main(argv=None) -> None:
    from biom3_tpu_torch.pipeline.stage1 import PenCLEngine, compute_scores

    args = parse_arguments(argv)
    engine = PenCLEngine(load_json_config(args.json_path), args.model_path, device=args.device)

    z_t, z_p = engine.embed(DEMO_CAPTIONS, DEMO_SEQUENCES)
    scores = {k: v.cpu().numpy() for k, v in compute_scores(z_p, z_t).items()}

    embedding_dict = {
        "sequence": list(DEMO_SEQUENCES),
        "text_prompts": list(DEMO_CAPTIONS),
        "z_t": z_t,
        "z_p": z_p,
    }

    print("\n=== Inference Results ===")
    print(f"Shape of z_p (protein latent): {z_p.shape}")
    print(f"Shape of z_t (text latent): {z_t.shape}")
    print(f"\nMagnitudes of z_p vectors: {scores['z_p_magnitude']}")
    print(f"Magnitudes of z_t vectors: {scores['z_t_magnitude']}")
    print("\n=== Dot Product Scores Matrix ===")
    print(scores["dot_product_scores"])
    print("\n=== Normalized Probabilities ===")
    print("Protein-Normalized Probabilities (Softmax across Proteins for each Text):")
    print(scores["protein_given_text_probs"])
    print("\nText-Normalized Probabilities (Softmax across Texts for each Protein):")
    print(scores["text_given_protein_probs"])
    print("\n=== Homology Matrix (Dot Product of Normalized z_p) ===")
    print(scores["homology_matrix"])

    save_torch_file(embedding_dict, args.output_path)
    print(f"\nEmbeddings saved to {args.output_path}")


if __name__ == "__main__":
    main()

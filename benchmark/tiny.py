"""Tiny configurations and mixes of the benchmark's cells, for the CPU tests:
the same code paths at sizes a CPU runs in seconds."""

from __future__ import annotations

import copy

STAGE3 = {"num_classes": 29, "transformer_dim": 64, "transformer_depth": 2,
          "transformer_blocks": 1, "transformer_heads": 2, "transformer_local_heads": 1,
          "transformer_local_size": 16, "diffusion_steps": 64, "text_emb_dim": 32,
          "input_dp_rate": 0.0}
STAGE1 = {"protein_encoder_embedding": 64, "esm_num_layers": 2, "esm_attention_heads": 2,
          "text_encoder_embedding": 64, "bert_num_layers": 2, "bert_num_heads": 2,
          "bert_intermediate_size": 256, "bert_vocab_size": 200,
          "bert_max_position_embeddings": 64, "proj_embedding_dim": 32, "text_max_length": 64}
STAGE2 = {"emb_dim": 32, "hid_dim": 64, "dropout": 0.0}

MIX = {
    "sweep": {"prompts": 2, "replicas": 2, "chunk_steps": 16, "warmup_forwards": 4,
              "check_steps": 16},
    "embed": {"device_batch": 4, "protein_pad": 64, "caption_pad": 64, "pool_slabs": 2,
              "protein_length": {"median": 20, "sigma": 0.6, "low": 5, "high": 62},
              "caption_length": {"median": 20, "sigma": 0.6, "low": 4, "high": 64}},
    "serve": {"prompt_pool": 16, "rate_per_s": 40.0,
              "caption_length": {"median": 20, "sigma": 0.6, "low": 4, "high": 64}},
    "train": {"batch": 4, "pool_batches": 4,
              "length": {"median": 20, "sigma": 0.6, "low": 5, "high": 62}},
}


def shrink(cell):
    """``cell`` (a ``harness.spec.Cell``) at the tiny sizes, a copy."""
    cell = copy.deepcopy(cell)
    cell.config = {"stage1": dict(STAGE1), "stage2": dict(STAGE2), "stage3": dict(STAGE3)}
    cell.mix = {**cell.mix, **MIX[cell.mix["kind"]]}
    return cell

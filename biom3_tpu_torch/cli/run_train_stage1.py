"""Stage-1 training CLI on PyTorch/CUDA: PenCL contrastive + MLM training.

Port of ``biom3_tpu/cli/run_train_stage1.py``: the same flags and prints
(``swissprot: … pairs``, ``layer-mode auto -> …``, ``step …/… loss=…
f1=…``, ``resumed from step …``, ``exported params to …``, ``finished at
step …``), ``metrics.csv``, the ``default`` → ``pfam`` dataset-type mapping
of a ``model_type: pfam`` config and the row-aligned Pfam check — plus
``--device`` (default ``cuda``).

  python -m biom3_tpu_torch.cli.run_train_stage1 --json_path s1.json \\
      --output_dir out --data_path swissprot.csv [--pfam_data_path pfam.csv] \\
      [--max_steps N] [--batch_size B] [--layer-mode auto|xla|layer_block] \\
      [--remat] [--resume] [--export_bin pencl.bin] [--device cuda|cpu]

Master parameters are f32.  On ``cuda`` the towers compute in ``--dtype``
(default bf16) and ``layer_block`` runs every ESM2 layer on the port's
kernels, forward and backward; on ``cpu`` everything is f32 on the
kernels' plain versions.  ``--export_bin`` writes the parameters as a
published pfam_PEN_CL ``.bin``, which ``run_pencl_inference`` serves.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from biom3_tpu_torch.config import PenCLConfig, load_json_config
from biom3_tpu_torch.data.loader import BatchLoader
from biom3_tpu_torch.data.stage1_data import TextSeqPairingDataset, read_csv
from biom3_tpu_torch.io.checkpoint import CheckpointManager
from biom3_tpu_torch.io.state_dict import seeded_init_, to_tensors
from biom3_tpu_torch.io.torch_io import load_torch_file, strip_prefix, unwrap_checkpoint
from biom3_tpu_torch.models.esm2 import esm2_train_state_dict
from biom3_tpu_torch.models.pencl import PenCL, published_state_dict
from biom3_tpu_torch.training.optim import describe
from biom3_tpu_torch.training.stage1_task import make_stage1_optimizer, make_stage1_train_step
from biom3_tpu_torch.training.state import TrainState
from biom3_tpu_torch.utils.logging import MetricLogger

ATTN_IMPLS = {"xla": "plain", "layer_block": "layer-block", "layer_block_bf16dq": "layer-block"}


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(description="BioM3 Stage-1 training (PyTorch/CUDA)")
    p.add_argument("--json_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--data_path", type=str, default=None,
                   help="SwissProt CSV (overrides config data_path)")
    p.add_argument("--pfam_data_path", type=str, default=None,
                   help="Pfam CSV, row-aligned with the SwissProt CSV")
    p.add_argument("--esm_weights", type=str, default=None,
                   help="fair-esm .pt to seed the protein tower")
    p.add_argument("--bert_weights", type=str, default=None,
                   help="HF pytorch_model.bin to seed the text tower")
    p.add_argument("--max_steps", type=int, default=None)
    p.add_argument("--batch_size", type=int, default=None,
                   help="override the config's batch_size (pairs per step)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--optimizer", choices=["adamw", "adafactor"], default=None,
                   help="override the config's optimizer; adafactor keeps factored second "
                        "moments and no first moment")
    p.add_argument("--moment_dtype", choices=["float32", "bfloat16"], default=None,
                   help="adamw first-moment dtype; bfloat16 halves it")
    p.add_argument("--remat", action="store_true",
                   help="rematerialise each tower layer in the backward (xla mode only: "
                        "layer_block already saves only each layer's input)")
    p.add_argument("--layer-mode", default="auto", choices=["auto", *ATTN_IMPLS],
                   help="layer_block: every ESM2 layer on the port's kernels, forward and "
                        "backward, recomputing from the layer input (BERT on torch ops); "
                        "layer_block_bf16dq: the same kernels, since the port stages the "
                        "attention backward's dqkv in the compute dtype in both; xla: torch "
                        "ops; auto (default): layer_block on cuda in bf16 when the ESM2 "
                        "head dim is 32 or 64, else xla")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--export_bin", type=str, default=None,
                   help="after training, also write the params as a published "
                        "pfam_PEN_CL-layout .bin, servable by run_pencl_inference")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def _load_tower(module: torch.nn.Module, sd: dict, what: str) -> None:
    """Load the keys ``module`` holds from ``sd``; every one must be there."""
    held = module.state_dict()
    missing = sorted(set(held) - set(sd))
    if missing:
        raise SystemExit(f"{what}: {len(missing)} keys missing, e.g. {missing[:3]}")
    module.load_state_dict({k: sd[k] for k in held}, strict=True)


def _reference_weights(path: str) -> dict:
    sd = unwrap_checkpoint(load_torch_file(path))
    if isinstance(sd.get("model"), dict):   # a raw fair-esm .pt
        sd = sd["model"]
    # fair-esm's own loader strips these trunk prefixes
    sd = strip_prefix(strip_prefix(sd, "encoder.sentence_encoder."), "encoder.")
    return to_tensors({k: v for k, v in sd.items() if isinstance(v, np.ndarray)})


def main(argv=None) -> None:
    args = parse_arguments(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu to run on the CPU)")
    dev = torch.device(args.device)
    cfg = load_json_config(args.json_path)
    if args.data_path:
        cfg.data_path = args.data_path
    model_cfg = PenCLConfig.from_stage_config(cfg)

    dataset = TextSeqPairingDataset(cfg, TextSeqPairingDataset.load_swissprot_csv(cfg))
    pfam_dataset = None
    if args.pfam_data_path or cfg.str_or_none("pfam_data_path"):
        pfam_dataset = TextSeqPairingDataset(cfg, read_csv(args.pfam_data_path or
                                                           cfg.pfam_data_path),
                                             text_tokenizer=dataset.text_tokenizer)
    print(f"swissprot: {len(dataset)} pairs"
          + (f", pfam: {len(pfam_dataset)}" if pfam_dataset else ""))
    # the loss pairs swiss row i with pfam row i as same-family positives
    if pfam_dataset is not None and len(pfam_dataset) != len(dataset):
        raise SystemExit("pfam CSV must be row-aligned with the SwissProt CSV "
                         f"(got {len(pfam_dataset)} vs {len(dataset)} rows)")

    dtype = torch.bfloat16 if args.dtype == "bfloat16" and dev.type == "cuda" else torch.float32
    layer_mode = args.layer_mode
    if layer_mode == "auto":
        esm = model_cfg.esm
        qualifies = (dev.type == "cuda" and dtype == torch.bfloat16
                     and esm.embed_dim % esm.attention_heads == 0 and esm.head_dim in (32, 64))
        layer_mode = "layer_block" if qualifies else "xla"
        print(f"layer-mode auto -> {layer_mode}")
    seed = cfg.int("seed", 42)
    torch.manual_seed(seed)  # dropout draws from the default generator
    model = PenCL(model_cfg, attn_impl=ATTN_IMPLS[layer_mode], dtype=dtype,
                  remat=args.remat and layer_mode == "xla", mlm_heads=True)
    seeded_init_(model, seed)
    if args.esm_weights:
        _load_tower(model.esm, esm2_train_state_dict(_reference_weights(args.esm_weights)),
                    "--esm_weights")
    if args.bert_weights:
        _load_tower(model.bert, _reference_weights(args.bert_weights), "--bert_weights")
    model.to(dev)

    # the reference config carries dataset_type='default' (a DataModule
    # selector) next to model_type='pfam', whose wrapper trains the pfam
    # objective (PL_wrapper.py:1078-1089)
    dataset_type = cfg.get("dataset_type", "pfam")
    if cfg.get("model_type", "pfam") == "pfam" and dataset_type not in ("pfam", "pfam_ablated"):
        print(f"model_type=pfam: mapping dataset_type {dataset_type!r} -> 'pfam'")
        dataset_type = "pfam"
    if args.optimizer:
        cfg.optimizer = args.optimizer
    if args.moment_dtype:
        cfg.moment_dtype = args.moment_dtype
    try:
        tx = make_stage1_optimizer(cfg, model)
    except ValueError as e:
        raise SystemExit(str(e)) from e
    print(f"optimizer: {describe(tx)}")
    state = TrainState(model, tx)
    step_fn = make_stage1_train_step(
        state, temperature=model_cfg.temperature, dataset_type=dataset_type,
        text_mask_id=dataset.text_tokenizer.mask_token_id,
        protein_mask_id=dataset.alphabet.mask_idx)

    rng = np.random.default_rng(seed)
    keys = ("text_tokens", "protein_tokens", "text_tokens_masked", "protein_tokens_masked")

    def make_batch(idx):
        b = dataset.get_batch(idx, with_masks=True, rng=rng)
        # the same indices of the pfam CSV: aligned family positives (the
        # SwissProt pairs themselves when no pfam CSV is given)
        pb = (pfam_dataset or dataset).get_batch(idx, with_masks=True, rng=rng)
        out = {k: torch.from_numpy(b[k]) for k in keys}
        out.update({"pfam_" + k: torch.from_numpy(pb[k]) for k in keys})
        return out

    batch_size = args.batch_size or cfg.int("batch_size", 80)
    loader = BatchLoader(len(dataset), batch_size, make_batch, seed=seed)
    logger = MetricLogger(args.output_dir)
    ckpt = CheckpointManager(f"{args.output_dir}/checkpoints")
    if args.resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        print(f"resumed from step {state.step}")
    total = args.max_steps or cfg.int("epochs", 10) * len(loader)
    done = state.step >= total
    t0 = time.time()
    while not done:
        for batch in loader:
            aux = step_fn({k: v.to(dev, non_blocking=True) for k, v in batch.items()})
            step = state.step
            if step % 20 == 0 or step == 1:
                print(f"step {step}/{total} loss={float(aux['loss']):.4f} "
                      f"f1={float(aux['total_f1']):.3f} ({time.time() - t0:.0f}s)")
                logger.log(step, {k: float(v) for k, v in aux.items()})
            if step % 500 == 0:
                ckpt.save(step, state)
            if step >= total:
                done = True
                break
    ckpt.save(state.step, state)
    ckpt.close()
    logger.close()
    if args.export_bin:
        torch.save(published_state_dict(model), args.export_bin)
        print(f"exported params to {args.export_bin}")
    print(f"finished at step {state.step}")


if __name__ == "__main__":
    main()

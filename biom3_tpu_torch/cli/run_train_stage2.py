"""Stage-2 training CLI on PyTorch/CUDA: the Facilitator (z_t → z_p) on
Stage-1 embedding dicts.

Port of ``biom3_tpu/cli/run_train_stage2.py``: the same flags and prints
(``train: …, val: …``, ``epoch …: train_loss=… val_loss=…``, ``resumed
from step …``, ``exported params to …``, ``saved final checkpoint at step
…``), ``metrics.csv``, the config's ``loss_type`` (MSE or MMD),
``batch_size``, ``valid_size`` and ``seed``, plus ``--device`` (default
``cuda``).  The Facilitator trains in f32 with dropout off, as the JAX CLI
does; its two products are plain ``F.linear`` calls (no kernel of the port's,
as no Pallas kernel on the TPU).

  python -m biom3_tpu_torch.cli.run_train_stage2 --json_path s2.json \\
      --output_dir out --swissprot_data_path embeddings.pt [--epochs N] \\
      [--resume] [--export_bin facilitator.bin] [--device cuda|cpu]

The data file is a Stage-1 output dict (``text_embedding``,
``protein_embedding``).  ``--export_bin`` writes the module's state dict,
whose keys are the published ``main.{0,3}.weight_g/weight_v/bias``:
``run_facilitator_sample`` and ``FacilitatorEngine`` load it.
"""

from __future__ import annotations

import argparse

import torch

from biom3_tpu_torch.config import FacilitatorConfig, load_json_config
from biom3_tpu_torch.data.loader import BatchLoader
from biom3_tpu_torch.data.stage2_data import FacilitatorDataset
from biom3_tpu_torch.io.checkpoint import CheckpointManager
from biom3_tpu_torch.io.state_dict import seeded_init_
from biom3_tpu_torch.models.facilitator import Facilitator
from biom3_tpu_torch.training.optim import make_optimizer
from biom3_tpu_torch.training.stage2_task import make_stage2_train_step, stage2_loss_fn
from biom3_tpu_torch.training.state import TrainState
from biom3_tpu_torch.utils.logging import MetricLogger


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(description="BioM3 Stage-2 training (PyTorch/CUDA)")
    p.add_argument("--json_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--swissprot_data_path", type=str, default=None)
    p.add_argument("--pfam_data_path", type=str, default=None)
    p.add_argument("--epochs", type=int, default=20)
    p.add_argument("--lr", type=float, default=1e-4)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--export_bin", type=str, default=None,
                   help="after training, also write the params as a published main.* "
                        "weight-norm .bin, servable by run_facilitator_sample")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> None:
    args = parse_arguments(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu to run on the CPU)")
    dev = torch.device(args.device)
    cfg = load_json_config(args.json_path)
    model_cfg = FacilitatorConfig.from_stage_config(cfg)
    seed = cfg.int("seed", 42)

    dataset = FacilitatorDataset.from_paths(
        args.swissprot_data_path or cfg.str_or_none("stage1_dataset_path"),
        args.pfam_data_path, valid_size=cfg.float("valid_size", 0.2), seed=seed)
    z_t_train, z_p_train = dataset.split("train")
    z_t_val, z_p_val = dataset.split("val")
    print(f"train: {len(z_t_train)}, val: {len(z_t_val)}")

    model = seeded_init_(Facilitator(model_cfg), seed).to(dev)
    state = TrainState(model, make_optimizer("AdamW", model.parameters(), args.lr))
    ckpt = CheckpointManager(f"{args.output_dir}/checkpoints")
    if args.resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        print(f"resumed from step {state.step}")
    loss_type = cfg.get("loss_type", "MMD")
    step_fn = make_stage2_train_step(state, loss_type=loss_type)
    zv = (torch.from_numpy(z_t_val).to(dev), torch.from_numpy(z_p_val).to(dev))

    def make_batch(idx):
        return {"z_t": torch.from_numpy(z_t_train[idx]), "z_p": torch.from_numpy(z_p_train[idx])}

    loader = BatchLoader(len(z_t_train), cfg.int("batch_size", 64), make_batch, seed=seed)
    logger = MetricLogger(args.output_dir)
    for epoch in range(args.epochs):
        for batch in loader:
            aux = step_fn({k: v.to(dev, non_blocking=True) for k, v in batch.items()})
        if len(z_t_val):
            with torch.no_grad():
                val = float(stage2_loss_fn(model, *zv, loss_type=loss_type)[0])
        else:
            val = float("nan")
        print(f"epoch {epoch}: train_loss={float(aux['loss']):.6f} val_loss={val:.6f}")
        logger.log(state.step, {"train_loss": aux["loss"], "val_loss": val})

    ckpt.save(state.step, state)
    ckpt.close()
    logger.close()
    if args.export_bin:
        torch.save({k: v.detach().float().cpu() for k, v in model.state_dict().items()},
                   args.export_bin)
        print(f"exported params to {args.export_bin}")
    print(f"saved final checkpoint at step {state.step}")


if __name__ == "__main__":
    main()

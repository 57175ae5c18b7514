"""Stage-3 training CLI on PyTorch/CUDA: OA-ARDM training of ProteoScribe.

Port of ``biom3_tpu/cli/run_train_stage3.py:43-222``: the same flags,
prints (``step …/… loss=…``, ``val: …``, ``exported ema params to …``,
``finished at step …``), ``metrics.csv`` and data handling — the +1 shift
into model ids, the train/val split, ``acc_grad_batches`` accumulation,
the EMA (β 0.9999), evaluation and checkpoints every ``enter_eval``
steps — plus ``--device`` (default ``cuda``).

  python -m biom3_tpu_torch.cli.run_train_stage3 --json_path s3.json \\
      --output_dir out --swissprot_data_root data.pt --max_steps N \\
      [--layer-mode layer_block|block|unrolled|unrolled_remat] [--resume] \\
      [--export_bin f.bin] [--export_params ema|final] \\
      [--dtype bfloat16|float32] [--device cuda|cpu]

Master parameters are f32.  On ``cuda`` the model computes in ``--dtype``
(default bf16) and ``layer_block`` (the default) / ``block`` run the
port's kernels; on ``cpu`` everything is f32 on the kernels' plain
versions.  ``--export_bin`` writes the EMA (or final) module's state dict
in the published ``transformer.*`` layout.
"""

from __future__ import annotations

import argparse
import time

import torch

from biom3_tpu_torch.config import ProteoScribeConfig, load_json_config
from biom3_tpu_torch.data.loader import BatchLoader
from biom3_tpu_torch.data.stage3_data import Stage3Dataset, merge_data_dicts, prepare_protein_data
from biom3_tpu_torch.io.checkpoint import CheckpointManager
from biom3_tpu_torch.io.state_dict import seeded_init_
from biom3_tpu_torch.io.torch_io import load_torch_file
from biom3_tpu_torch.models.proteoscribe import ProteoScribe
from biom3_tpu_torch.training.optim import (
    coswarmup_schedule,
    exponential_epoch_schedule,
    make_optimizer,
)
from biom3_tpu_torch.training.stage3_task import make_stage3_eval_step, make_stage3_train_step
from biom3_tpu_torch.training.state import TrainState
from biom3_tpu_torch.utils.logging import MetricLogger

LAYER_MODES = {
    "layer_block": {"attn_impl": "layer-block"},
    "block": {"attn_impl": "block"},
    "unrolled": {},
    "unrolled_remat": {"remat": True},
}


def parse_arguments(argv=None):
    p = argparse.ArgumentParser(description="BioM3 Stage-3 training (PyTorch/CUDA)")
    p.add_argument("--json_path", type=str, required=True)
    p.add_argument("--output_dir", type=str, required=True)
    p.add_argument("--swissprot_data_root", type=str, default=None)
    p.add_argument("--pfam_data_root", type=str, default=None)
    p.add_argument("--max_steps", type=int, default=None,
                   help="stop after N optimizer steps (default: epochs×data)")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--export_bin", type=str, default=None,
                   help="after training, also write the params as a published-layout .bin "
                        "('transformer.*' keys)")
    p.add_argument("--export_params", choices=["ema", "final"], default="ema",
                   help="which weights go into --export_bin (the reference serves the EMA)")
    p.add_argument("--dtype", choices=["float32", "bfloat16"], default="bfloat16")
    p.add_argument("--layer-mode", choices=[*LAYER_MODES, "scan_remat"], default="layer_block",
                   help="layer_block: the whole layer on the port's kernels (no dropout "
                        "path); block: the attention sub-block on the kernels; unrolled: "
                        "torch ops; unrolled_remat: torch ops, each layer rematerialised")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def load_training_data(cfg, args) -> Stage3Dataset:
    sp = args.swissprot_data_root or cfg.str_or_none("swissprot_data_root")
    pf = args.pfam_data_root or cfg.str_or_none("pfam_data_root")
    dicts = [load_torch_file(p) for p in (sp, pf) if p]
    if not dicts:
        raise SystemExit("no training data: set --swissprot_data_root/--pfam_data_root")
    data = dicts[0] if len(dicts) == 1 else merge_data_dicts(*dicts)
    tokens, emb = prepare_protein_data(cfg, data)
    return Stage3Dataset(tokens, emb, valid_size=cfg.float("valid_size", 0.1),
                         seed=cfg.int("seed", 42))


def main(argv=None) -> None:
    args = parse_arguments(argv)
    if args.layer_mode == "scan_remat":
        raise SystemExit("--layer-mode scan_remat (a scan over layers, a TPU compile-size "
                         "device) is not ported; use unrolled_remat for the same memory saving")
    if args.device == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu to run on the CPU)")
    dev = torch.device(args.device)
    cfg = load_json_config(args.json_path)
    model_cfg = ProteoScribeConfig.from_stage_config(cfg)
    if args.layer_mode == "layer_block" and (model_cfg.attn_layer_dropout > 0
                                             or model_cfg.ff_dropout > 0):
        raise SystemExit("--layer-mode layer_block has no dropout path "
                         f"(attn_layer_dropout={model_cfg.attn_layer_dropout}, "
                         f"ff_dropout={model_cfg.ff_dropout}); use 'block' or 'unrolled'")

    dataset = load_training_data(cfg, args)
    tok_train, emb_train = dataset.split("train")
    tok_val, emb_val = dataset.split("val")
    print(f"train examples: {len(tok_train)}, val: {len(tok_val)}")

    seed = cfg.int("seed", 42)
    batch_size = cfg.int("batch_size", 16)
    epochs = cfg.int("epochs", 1)
    steps_per_epoch = max(1, len(tok_train) // batch_size)
    total_steps = args.max_steps or steps_per_epoch * epochs

    sched_cfg = cfg.get("scheduler_gamma")
    schedule = None
    if isinstance(sched_cfg, str) and sched_cfg.lower() == "coswarmup":
        schedule = coswarmup_schedule(steps_per_epoch, steps_per_epoch * epochs)
    elif sched_cfg is not None and not isinstance(sched_cfg, str):
        schedule = exponential_epoch_schedule(float(sched_cfg), steps_per_epoch)

    dtype = torch.bfloat16 if args.dtype == "bfloat16" and dev.type == "cuda" else torch.float32
    torch.manual_seed(seed)  # dropout draws from the default generator
    model = ProteoScribe(model_cfg, dtype=dtype, **LAYER_MODES[args.layer_mode])
    model = seeded_init_(model, seed).to(dev)
    tx = make_optimizer(cfg.get("choose_optim", "AdamW"), model.parameters(),
                        cfg.float("learning_rate", 1e-4), schedule,
                        weight_decay=cfg.float("weight_decay", 0.0))
    state = TrainState(model, tx, with_ema=True)
    step_fn = make_stage3_train_step(state, accum_steps=cfg.int("acc_grad_batches", 1))
    eval_fn = make_stage3_eval_step(model)

    ckpt = CheckpointManager(f"{args.output_dir}/checkpoints")
    if args.resume and ckpt.latest_step() is not None:
        ckpt.restore(state)
        print(f"resumed from step {state.step}")

    # +1-shift into model ids happens here, once, on the host
    tok_train = tok_train + 1

    def make_batch(idx):
        return {"tokens": torch.from_numpy(tok_train[idx]).long(),
                "z_c": torch.from_numpy(emb_train[idx]).float()}

    loader = BatchLoader(len(tok_train), batch_size, make_batch, seed=seed)
    logger = MetricLogger(args.output_dir)
    enter_eval = cfg.int("enter_eval", 1000)
    gen = torch.Generator(device=dev).manual_seed(seed + state.step)

    done = state.step >= total_steps
    t0 = time.time()
    while not done:
        for batch in loader:
            batch = {k: v.to(dev, non_blocking=True) for k, v in batch.items()}
            aux = step_fn(batch, gen)
            step = state.step
            if step % 50 == 0 or step == 1:
                loss = float(aux["loss"])
                print(f"step {step}/{total_steps} loss={loss:.4f} ({(time.time() - t0):.0f}s)")
                logger.log(step, {k: float(v) for k, v in aux.items()})
            if step % enter_eval == 0:
                if len(tok_val):
                    vb = {"tokens": torch.from_numpy(tok_val[:batch_size] + 1).long().to(dev),
                          "z_c": torch.from_numpy(emb_val[:batch_size]).float().to(dev)}
                    vm = eval_fn(vb, gen)
                    print("  val: " + " ".join(f"{k}={float(v):.4f}"
                                               for k, v in sorted(vm.items())))
                    logger.log(step, {f"val_{k}": float(v) for k, v in vm.items()})
                ckpt.save(step, state)
            if step >= total_steps:
                done = True
                break
    ckpt.save(state.step, state)
    ckpt.close()
    logger.close()
    if args.export_bin:
        sd = (state.ema_state_dict() if args.export_params == "ema" else model.state_dict())
        torch.save({k: v.detach().float().cpu() for k, v in sd.items()}, args.export_bin)
        print(f"exported {args.export_params} params to {args.export_bin}")
    print(f"finished at step {state.step}")


if __name__ == "__main__":
    main()

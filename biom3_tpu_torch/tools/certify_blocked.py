"""Certify blocked any-order decoding on the trained copy-task toy.

Port of the JAX package's ``tools/certify_blocked.py``.  Blocked decoding
(``positions_per_step=k>1``) samples the next k path positions
*independently from the same conditional* — exact only when those
positions are conditionally independent given the revealed context.  The
copy task (``certify_task``) makes that dependence real and measurable:
every sequence is ONE token repeated, drawn from its class's 4-token mode
set, so a perfect any-order sampler commits to one mode with its first
position and copies it everywhere, while independent in-block samples can
mix modes.

Metrics per (order, temperature, k): coherence = fraction of positions
equal to the row's majority token (1.0 = fully coherent); frac_coherent_99
= rows with coherence > 0.99; class_acc = rows whose majority token is in
the class's mode set.  ``--maskgit-steps`` adds the parallel re-masking
sampler (rows ``order='maskgit-S'``).  The samplers run over the
``ProteoScribe`` module forward in f32 (``certify_task.serving_model``), as
the JAX tool runs ``model.apply``.

  python -m biom3_tpu_torch.tools.certify_blocked --steps 600 --batch 64 \\
      --ks 1 2 4 8 --temps 1.0 0.5 0.0 [--state-path toy.pt] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from biom3_tpu_torch.diffusion.sampler import (
    make_maskgit_sampler,
    make_sampler,
    sample_permutations,
)
from biom3_tpu_torch.tools.certify_task import build_and_train, coherence_stats, make_batch


def quality(seqs: np.ndarray, cls: np.ndarray) -> dict:
    """The row's task metrics of temp-k samples ``seqs`` (B, L)."""
    cons, class_ok, mode_entropy = coherence_stats(seqs, cls)
    return {
        "coherence_mean": round(float(cons.mean()), 4),
        "coherence_p10": round(float(np.percentile(cons, 10)), 4),
        "frac_coherent_99": round(float((cons > 0.99).mean()), 3),
        "class_acc": round(float(class_ok.mean()), 3),
        "mode_entropy": round(mode_entropy, 3),
    }


def blocked_ids(model, z_c: torch.Tensor, path: torch.Tensor, *, order: str, temp: float,
                k: int, seed: int = 5) -> np.ndarray:
    """One cell's sequences (B, L): the k-positions-a-step sampler over the
    module forward, its draws from a generator seeded ``seed``."""
    sampler = make_sampler(model, model.config.num_timesteps, temperature=temp,
                           positions_per_step=k, chunk_steps=None, order=order)
    gen = torch.Generator(device=z_c.device).manual_seed(seed)
    return sampler(z_c, path, gen).cpu().numpy()


def maskgit_ids(model, z_c: torch.Tensor, *, steps: int, temp: float,
                seed: int = 5) -> np.ndarray:
    sampler = make_maskgit_sampler(model, model.config.max_seq_len, steps=steps,
                                   temperature=temp)
    return sampler(z_c, None, torch.Generator(device=z_c.device).manual_seed(seed)).cpu().numpy()


def certify(model, z_c, cls, path, *, orders, temps, ks, maskgit_steps=()) -> list[dict]:
    """Every (order, temperature, k) cell, then the MaskGIT cells; each row
    printed as it is made → the rows."""
    results = []

    def record(row, make):
        t0 = time.time()
        row.update(quality(make(), cls))
        row["wall_s"] = round(time.time() - t0, 1)
        results.append(row)
        print(json.dumps(row), flush=True)

    for order in orders:
        for temp in temps:
            for k in ks:
                record({"order": order, "temp": temp, "k": k},
                       lambda: blocked_ids(model, z_c, path, order=order, temp=temp, k=k))
    for S in maskgit_steps:
        for temp in temps:
            record({"order": f"maskgit-{S}", "temp": temp, "k": None},
                   lambda: maskgit_ids(model, z_c, steps=S, temp=temp))
    return results


def summary(results: list[dict], orders, B: int) -> list[str]:
    """The JAX tool's closing table: coherence mean per (order, temp, k)."""
    lines = ["", f"Summary (coherence mean over {B} samples):"]
    temps = sorted({r["temp"] for r in results}, reverse=True)
    # maskgit rows carry k=None and live outside the per-order tables
    ks = sorted({r["k"] for r in results if r["k"] is not None})
    for order in orders:
        lines += ["", f"order={order}", "| temp | " + " | ".join(f"k={k}" for k in ks) + " |",
                  "|" + "---|" * (len(ks) + 1)]
        for t in temps:
            vals = [r for k in ks for r in results
                    if r["order"] == order and r["temp"] == t and r["k"] == k]
            lines.append(f"| {t} | " + " | ".join(f"{v['coherence_mean']:.3f}" for v in vals)
                         + " |")
    return lines


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="certify blocked decoding on the trained toy")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--sample-batch", type=int, default=64)
    ap.add_argument("--ks", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--temps", type=float, nargs="*", default=[1.0, 0.5, 0.0])
    ap.add_argument("--orders", nargs="*", default=["path"], choices=["path", "confidence"],
                    help="decode orderings to A/B: 'confidence' decodes the k most certain "
                         "positions each step")
    ap.add_argument("--maskgit-steps", type=int, nargs="*", default=[],
                    help="also certify the parallel re-masking sampler at these step counts")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--state-path", default=None,
                    help="torch file of the trained params: load if present, save after "
                         "training otherwise")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return ap.parse_args(argv)


def main(argv=None) -> list[dict]:
    args = parse_args(argv)
    cfg, model, _ = build_and_train(args.steps, args.batch, args.seq_len,
                                    state_path=args.state_path, device=args.device)
    dev = torch.device(args.device)
    B = args.sample_batch
    _, z_c, cls = make_batch(np.random.default_rng(7), B, cfg.max_seq_len, cfg.cond_dim, dev)
    path = sample_permutations(torch.Generator(device=dev).manual_seed(42), B, cfg.max_seq_len)
    results = certify(model, z_c, cls, path, orders=args.orders, temps=args.temps, ks=args.ks,
                      maskgit_steps=args.maskgit_steps)
    print("\n".join(summary(results, args.orders, B)), flush=True)
    return results


if __name__ == "__main__":
    main()

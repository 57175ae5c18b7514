"""Certify the inpainting surface: does filling respect committed context?

Port of the JAX package's ``tools/certify_inpaint.py``.  The copy task
(``certify_task``) makes restoration exactly scorable: every sequence is
one token repeated, so ANY single revealed position determines every
masked one.  A context-respecting inpainter restores the original token
at 100% (temp 0); an inpainter that ignores the committed residues reverts
to unconditional generation (~25% per-class mode chance).

Methods certified (all take the same corrupted inputs, from
``diffusion/inpainting.corrupt_samples``):
  * ``inpaint-confidence`` — the serving path's order
    (``make_inpainter(order="confidence")``),
  * ``inpaint-path`` — the reference-faithful resume-from-t trajectory,
  * ``autocomplete`` — the reference's one-shot fill,
  * ``maskgit-S`` — the parallel sampler resuming from the partial
    sequence (``make_maskgit_sampler`` with ``x0``).
Each runs over the ``ProteoScribe`` module forward in f32, as the JAX tool
runs ``model.apply``.

Metrics per (method, revealed fraction, temperature):
  restore_acc  — fraction of ORIGINALLY-MASKED positions whose fill equals
                 the source token;
  row_perfect  — fraction of rows fully restored;
  committed_ok — invariant: revealed positions never change (must be 1.0).

  python -m biom3_tpu_torch.tools.certify_inpaint --steps 600 --batch 64 \\
      --fracs 0.5 0.25 0.05 --temps 0.0 1.0 [--state-path toy.pt] [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from biom3_tpu_torch.diffusion.inpainting import autocomplete, corrupt_samples, make_inpainter
from biom3_tpu_torch.diffusion.sampler import make_maskgit_sampler
from biom3_tpu_torch.tools.certify_task import build_and_train, make_batch


def restore_stats(out, real, masked):
    out, real, masked = map(np.asarray, (out, real, masked))
    was_masked = masked == 0
    hit = (out == real) & was_masked
    restore_acc = hit.sum() / was_masked.sum()
    row_perfect = float(
        ((hit.sum(1) == was_masked.sum(1)) | (was_masked.sum(1) == 0)).mean()
    )
    committed_ok = float((out[~was_masked] == masked[~was_masked]).all())
    return float(restore_acc), row_perfect, committed_ok


def make_methods(model, temps, maskgit_steps) -> dict:
    """(method, temperature) → its fill function, built once: the revealed
    fraction only changes the inputs."""
    L = model.config.max_seq_len
    methods = {}
    for temp in temps:
        for order in ("confidence", "path"):
            methods[(f"inpaint-{order}", temp)] = make_inpainter(model, L, temperature=temp,
                                                                 order=order)
        for S in maskgit_steps:
            methods[(f"maskgit-{S}", temp)] = make_maskgit_sampler(model, L, steps=S,
                                                                   temperature=temp)
    return methods


def fill(name: str, fn, masked, z_c, path, t, generator) -> np.ndarray:
    """One method's fills (B, L) of ``masked`` (its path and t from
    ``corrupt_samples``)."""
    if name.startswith("maskgit"):
        return fn(z_c, None, generator, x0=masked).cpu().numpy()
    return fn(masked, z_c, path, t, generator).cpu().numpy()


def certify(model, real, z_c, *, fracs, temps, maskgit_steps, seed: int = 5) -> list[dict]:
    """Every (revealed fraction, temperature, method) cell on the same
    corruptions (a generator seeded 3 for each fraction's), each row
    printed as it is made → the rows."""
    dev = z_c.device
    L = model.config.max_seq_len
    results = []
    methods = make_methods(model, temps, maskgit_steps)

    def record(method, frac, temp, out, masked, wall):
        acc, perfect, committed = restore_stats(out, real.cpu().numpy(), masked.cpu().numpy())
        row = {"method": method, "revealed_frac": frac, "temp": temp,
               "restore_acc": round(acc, 4), "row_perfect": round(perfect, 3),
               "committed_ok": committed, "wall_s": round(wall, 1)}
        results.append(row)
        print(json.dumps(row), flush=True)

    for frac in fracs:
        masked, path, t = corrupt_samples(torch.Generator(device=dev).manual_seed(3), real,
                                          frac, L)
        for temp in temps:
            for (name, mtemp), fn in methods.items():
                if mtemp != temp:
                    continue
                t0 = time.time()
                out = fill(name, fn, masked, z_c, path, t,
                           torch.Generator(device=dev).manual_seed(seed))
                record(name, frac, temp, out, masked, time.time() - t0)
            t0 = time.time()
            gen = None if temp == 0.0 else torch.Generator(device=dev).manual_seed(seed)
            out, _ = autocomplete(model, masked, z_c, t, generator=gen)
            record("autocomplete", frac, temp, out.cpu().numpy(), masked, time.time() - t0)
    return results


def summary(results: list[dict], fracs, temps) -> list[str]:
    """The JAX tool's restore_acc table and the committed-positions
    invariant line."""
    methods = sorted({r["method"] for r in results})
    lines = ["", "Summary (restore_acc):", "| frac | temp | " + " | ".join(methods) + " |",
             "|" + "---|" * (len(methods) + 2)]
    for frac in fracs:
        for temp in temps:
            vals = []
            for m in methods:
                v = [r for r in results if r["method"] == m
                     and r["revealed_frac"] == frac and r["temp"] == temp]
                vals.append(f"{v[0]['restore_acc']:.3f}" if v else "—")
            lines.append(f"| {frac} | {temp} | " + " | ".join(vals) + " |")
    bad = [r for r in results if r["committed_ok"] != 1.0]
    lines += ["", "committed-positions invariant: "
              + ("VIOLATED: " + json.dumps(bad) if bad else "held in all cells")]
    return lines


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description="certify inpainting on the trained toy")
    ap.add_argument("--steps", type=int, default=600)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--sample-batch", type=int, default=64)
    ap.add_argument("--fracs", type=float, nargs="*", default=[0.5, 0.25, 0.05])
    ap.add_argument("--temps", type=float, nargs="*", default=[0.0, 1.0])
    ap.add_argument("--maskgit-steps", type=int, nargs="*", default=[16])
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
    real, z_c, _ = make_batch(np.random.default_rng(7), args.sample_batch, cfg.max_seq_len,
                              cfg.cond_dim, dev)
    results = certify(model, real, z_c, fracs=args.fracs, temps=args.temps,
                      maskgit_steps=args.maskgit_steps)
    print("\n".join(summary(results, args.fracs, args.temps)), flush=True)
    return results


if __name__ == "__main__":
    main()

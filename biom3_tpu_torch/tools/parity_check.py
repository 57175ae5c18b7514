"""Parity-gate harness: verify the published README numbers with real weights.

Port of the JAX package's ``tools/parity_check.py``: the same gates,
expected values, flags, PASS/FAIL lines and exit codes (0 when every gate
passes, 1 when one fails, 2 when no weights are given), on the port's
engines, plus ``--device`` (default ``cuda``; ``cpu`` on a machine without a
card).  The published checkpoints are not in the repository (WEIGHTS.md):
on seeded checkpoints in the published layouts the harness runs every gate
and FAILs.

  python -m biom3_tpu_torch.tools.parity_check \\
      --pencl BioM3_PenCL_epoch20.bin \\
      --facilitator BioM3_Facilitator_epoch20.bin \\
      --proteoscribe BioM3_ProteoScribe_pfam_epoch20_v1.bin \\
      --stage1_json stage1_config.json --stage2_json stage2_config.json \\
      --stage3_json stage3_config.json

The three north-star gates, each against the reference README's published
outputs (README.md:222-326):

  1. z_t/z_p norms, the dot-product diagonal and two homology entries of
     the 5 demo pairs (``PenCLEngine`` in f32);
  2. the Facilitator's z_c norms, MSE and MMD (``FacilitatorEngine``);
  3. bit-faithful temperature-0 Stage-3 ids: ``ProteoScribeEngine(dtype=
     float32, temperature=0.0).sample_batch`` with injected permutations
     against the torch golden oracle ``tests/torch_golden.py`` (the
     reference loop, Stage3_source/sampling_analysis.py:152-201) on the same
     checkpoint, or against a captured run (``--reference_trajectory``:
     an .npz/.pt with ``path`` (B, L), ``z_c`` (B, C), ``expected_ids``
     (B, L)); 0 ids may differ.

The engines run in f32; on the card TF32 is off for the run
(``torch.backends.cuda.matmul.allow_tf32`` and ``cudnn.allow_tf32``), the
counterpart of JAX's ``jax_default_matmul_precision="highest"``.  The
oracle is imported only inside gate 3, through a ``sys.path`` entry to the
repository's ``tests/`` directory, as the JAX tool reaches it:
``torch_golden`` imports torch alone.  The config defaults are the
reference configs' names under ``reference/``; pass the real paths.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

# Published values (reference README.md:222-233, 315-326)
EXPECTED = {
    "z_p_norms": [4.2894, 4.0314, 4.2747, 4.0478, 3.9959],
    "z_t_norms": [33.3649, 32.5055, 31.6935, 33.3630, 29.6486],
    "dot_diag": [28.8613, 28.2294, 30.3760, 30.2053, 27.7488],
    "homology_0_3": 0.1752,
    "homology_1_4": 0.2951,
    "fac_norm_z_t": 33.364857,
    "fac_norm_z_p": 4.289446,
    "fac_norm_z_c": 3.976427,
    "fac_mse_zc_zp": 0.013486,
    "fac_mse_zt_zp": 1.937837,
    "fac_mmd_zc_zp": 0.000009,
    "fac_mmd_zp_zt": 0.004736,
}
TESTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir, os.pardir,
                         "tests")


def check(name: str, actual, expected, tol: float) -> bool:
    actual = np.asarray(actual, np.float64)
    expected = np.asarray(expected, np.float64)
    ok = bool(np.all(np.abs(actual - expected) <= tol))
    status = "PASS" if ok else "FAIL"
    print(f"[{status}] {name}: got {np.round(actual, 6)} want {expected} (tol {tol})")
    return ok


def _stage3_gate(args) -> bool:
    """Gate 3: bit-faithful temperature-0 sequences under an injected
    permutation (``ProteoScribeEngine.sample_batch(..., paths=...)``)."""
    from biom3_tpu_torch.config import load_json_config
    from biom3_tpu_torch.io.torch_io import load_torch_file
    from biom3_tpu_torch.pipeline.stage3 import ProteoScribeEngine

    engine = ProteoScribeEngine(load_json_config(args.stage3_json), args.proteoscribe,
                                device=args.device, dtype=torch.float32, temperature=0.0)
    L = engine.config.max_seq_len

    if args.reference_trajectory:
        if args.reference_trajectory.endswith(".npz"):
            rec = dict(np.load(args.reference_trajectory))
        else:
            rec = {k: np.asarray(v) for k, v in load_torch_file(args.reference_trajectory).items()}
        paths = np.asarray(rec["path"], np.int32)
        z_c = np.asarray(rec["z_c"], np.float32)
        expected = np.asarray(rec["expected_ids"], np.int64)
        source = f"captured trajectory {args.reference_trajectory}"
    else:
        # the torch golden oracle (CPU, f32) on deterministic synthetic z_c
        sys.path.insert(0, TESTS_DIR)
        import torch_golden

        cfg = engine.config
        tm = torch_golden.GoldenDiffTransformer(
            num_classes=cfg.num_classes, dim=cfg.dim, depth=cfg.depth, n_blocks=cfg.n_blocks,
            max_seq_len=cfg.max_seq_len, num_timesteps=cfg.num_timesteps, heads=cfg.heads,
            n_local_attn_heads=cfg.local_heads, local_attn_window_size=cfg.local_window,
            cond_dim=cfg.cond_dim)
        sd = load_torch_file(args.proteoscribe)
        stripped = {k[len("transformer."):] if k.startswith("transformer.") else k:
                    torch.as_tensor(np.array(v)) for k, v in sd.items()}
        missing, _ = tm.load_state_dict(stripped, strict=False)
        if missing:
            print(f"[FAIL] stage3 oracle load: missing keys {missing}")
            return False
        rng = np.random.default_rng(0)
        B = args.stage3_batch
        paths = np.stack([rng.permutation(L) for _ in range(B)]).astype(np.int32)
        z_c = rng.standard_normal((B, cfg.cond_dim)).astype(np.float32)
        expected = torch_golden.golden_temp0_denoise(tm, paths, z_c)
        source = "in-process torch golden oracle"

    got = engine.sample_batch(z_c, torch.Generator(device=engine.device).manual_seed(0),
                              paths=paths)
    mismatched = int((np.asarray(got, np.int64) != expected).sum())
    total = int(expected.size)
    ok = mismatched == 0
    status = "PASS" if ok else "FAIL"
    print(f"[{status}] stage3 temp-0 sequences vs {source}: "
          f"{mismatched}/{total} ids differ (gate: 0)")
    return ok


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="the published-weights parity gates")
    p.add_argument("--pencl", type=str, default=None)
    p.add_argument("--facilitator", type=str, default=None)
    p.add_argument("--proteoscribe", type=str, default=None)
    p.add_argument("--stage1_json", type=str, default="reference/stage1_config.json")
    p.add_argument("--stage2_json", type=str, default="reference/stage2_config.json")
    p.add_argument("--stage3_json", type=str, default="reference/stage3_config.json")
    p.add_argument("--reference_trajectory", type=str, default=None,
                   help="captured reference run (.npz/.pt with path, z_c, expected_ids) "
                        "replacing the in-process oracle")
    p.add_argument("--stage3_batch", type=int, default=2,
                   help="oracle-mode rows (each is a full L-step denoise on CPU torch — keep "
                        "small)")
    p.add_argument("--tol", type=float, default=5e-3,
                   help="absolute tolerance on published 4-decimal values")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if not args.pencl and not args.facilitator and not args.proteoscribe:
        print("no weights given — nothing to check (see WEIGHTS.md)")
        return 2
    tf32 = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        return _gates(args)
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = tf32


def _gates(args) -> int:
    from biom3_tpu_torch.cli.demo_data import DEMO_CAPTIONS, DEMO_SEQUENCES
    from biom3_tpu_torch.config import load_json_config

    ok = True
    z_t = z_p = None

    if args.pencl:
        from biom3_tpu_torch.pipeline.stage1 import PenCLEngine, compute_scores

        engine = PenCLEngine(load_json_config(args.stage1_json), args.pencl, device=args.device)
        z_t, z_p = engine.embed(DEMO_CAPTIONS, DEMO_SEQUENCES)
        scores = {k: v.cpu().numpy() for k, v in compute_scores(z_p, z_t).items()}
        ok &= check("z_p norms", scores["z_p_magnitude"], EXPECTED["z_p_norms"], args.tol)
        ok &= check("z_t norms", scores["z_t_magnitude"], EXPECTED["z_t_norms"], args.tol)
        ok &= check("dot diag", np.diag(scores["dot_product_scores"]), EXPECTED["dot_diag"],
                    args.tol)
        hm = scores["homology_matrix"]
        ok &= check("homology[0,3]", hm[0, 3], EXPECTED["homology_0_3"], args.tol)
        ok &= check("homology[1,4]", hm[1, 4], EXPECTED["homology_1_4"], args.tol)

    if args.facilitator:
        from biom3_tpu_torch.pipeline.stage2 import FacilitatorEngine

        if z_t is None:
            print("(facilitator gate needs --pencl for fresh z_t/z_p)")
            return 2
        engine = FacilitatorEngine(load_json_config(args.stage2_json), args.facilitator,
                                   device=args.device)
        _, m = engine.run_dataset({"z_t": z_t, "z_p": z_p})
        for key, exp_key, tol in [
            ("norm_z_t", "fac_norm_z_t", 1e-3),
            ("norm_z_p", "fac_norm_z_p", 1e-3),
            ("norm_z_c", "fac_norm_z_c", 1e-3),
            ("mse_zc_zp", "fac_mse_zc_zp", 1e-4),
            ("mse_zt_zp", "fac_mse_zt_zp", 1e-3),
            ("mmd_zc_zp", "fac_mmd_zc_zp", 5e-6),
            ("mmd_zp_zt", "fac_mmd_zp_zt", 5e-5),
        ]:
            ok &= check(key, m[key], EXPECTED[exp_key], tol)

    if args.proteoscribe:
        ok &= _stage3_gate(args)

    print("\nOVERALL:", "PASS" if ok else "FAIL")
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

"""Stage-2 inference engine: z_t → z_c, with the evaluation metrics.

Port of ``biom3_tpu/pipeline/stage2.py``: the Facilitator MLP in f32 on the
engine's device (two small matrix products; no kernel of its own, as on
the TPU, where it compiles to one XLA fusion), and ``run_dataset``, the
reference CLI's MSE / MMD / norm diagnostics (run_Facilitator_sample.py).
"""

from __future__ import annotations

import numpy as np
import torch

from biom3_tpu_torch.config import Config, FacilitatorConfig
from biom3_tpu_torch.io.state_dict import load_reference_state_dict, seeded_init_
from biom3_tpu_torch.models.facilitator import Facilitator, mmd_loss, mse_loss
from biom3_tpu_torch.pipeline import require_device


class FacilitatorEngine:
    def __init__(self, stage_config: Config, model_path: str | None = None, *,
                 device: str | torch.device = "cuda"):
        self.config = FacilitatorConfig.from_stage_config(stage_config)
        self.device = torch.device(device)
        require_device(self.device, "FacilitatorEngine")
        model = Facilitator(self.config)
        if model_path is not None:
            # the MLP's keys with or without the module's ``main.`` prefix, as
            # the JAX converter takes them (io/convert.py:28-40)
            sd = {k if k.startswith("main.") else f"main.{k}": v
                  for k, v in load_reference_state_dict(model_path).items()}
            model.load_state_dict(sd, strict=True)
        else:
            seeded_init_(model, seed=0)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, z_t: np.ndarray) -> np.ndarray:
        z = torch.as_tensor(np.asarray(z_t, np.float32), device=self.device)
        return self.model(z).cpu().numpy()

    @torch.no_grad()
    def run_dataset(self, embedding_dataset: dict) -> tuple[dict, dict]:
        """Returns (the dataset with 'z_c' added, metrics dict) — the
        reference CLI's printed diagnostics (run_Facilitator_sample.py:85-118)."""
        z_t = torch.as_tensor(np.asarray(embedding_dataset["z_t"], np.float32),
                              device=self.device)
        z_p = torch.as_tensor(np.asarray(embedding_dataset["z_p"], np.float32),
                              device=self.device)
        z_c = self.model(z_t)
        metrics = {
            "mse_zc_zp": float(mse_loss(z_c, z_p)),
            "mse_zt_zp": float(mse_loss(z_t, z_p)),
            "mmd_zc_zp": float(mmd_loss(z_c, z_p)),
            "mmd_zp_zt": float(mmd_loss(z_p, z_t)),
            "norm_z_t": float(z_t[0].norm()),
            "norm_z_p": float(z_p[0].norm()),
            "norm_z_c": float(z_c[0].norm()),
        }
        out = dict(embedding_dataset)
        out["z_c"] = z_c.cpu().numpy()
        return out, metrics

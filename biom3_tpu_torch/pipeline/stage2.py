"""Stage-2 inference engine: z_t → z_c.

Port of ``biom3_tpu/pipeline/stage2.py``'s forward: the Facilitator MLP in
f32 on the engine's device (two small matrix products; no kernel of its
own, as on the TPU, where it compiles to one XLA fusion).
"""

from __future__ import annotations

import numpy as np
import torch

from biom3_tpu_torch.config import Config, FacilitatorConfig
from biom3_tpu_torch.io.state_dict import load_reference_state_dict, seeded_init_
from biom3_tpu_torch.models.facilitator import Facilitator


class FacilitatorEngine:
    def __init__(self, stage_config: Config, model_path: str | None = None, *,
                 device: str | torch.device = "cpu"):
        self.config = FacilitatorConfig.from_stage_config(stage_config)
        self.device = torch.device(device)
        model = Facilitator(self.config)
        if model_path is not None:
            model.load_state_dict(load_reference_state_dict(model_path), strict=True)
        else:
            seeded_init_(model, seed=0)
        self.model = model.to(self.device).eval()

    @torch.no_grad()
    def __call__(self, z_t: np.ndarray) -> np.ndarray:
        z = torch.as_tensor(np.asarray(z_t, np.float32), device=self.device)
        return self.model(z).cpu().numpy()

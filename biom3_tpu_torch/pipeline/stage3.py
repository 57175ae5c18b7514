"""Stage-3 inference engine: conditional sequence generation.

Port of ``biom3_tpu/pipeline/stage3.py:31-217,609-654`` for the
path-ordered ARDM sampler: for each conditioning vector z_c, generate
``num_replicas`` sequences, ``batch_size_sample`` at a time, decode with
the 29-token table and strip the markers.

On ``cuda`` the engine runs bf16 through the kernels of the whole-stack
forward (``models/fused_forward.make_stack_apply``) with tanh GELU, the
JAX engine's accelerator choice (stage3.py:122-124); on ``cpu`` the same
path runs f32 on the kernels' plain versions with exact GELU.
"""

from __future__ import annotations

import numpy as np
import torch

from biom3_tpu_torch.config import Config, ProteoScribeConfig
from biom3_tpu_torch.diffusion.sampler import make_sampler, sample_permutations
from biom3_tpu_torch.io.state_dict import load_reference_state_dict, seeded_init_
from biom3_tpu_torch.models.fused_forward import make_stack_apply
from biom3_tpu_torch.models.proteoscribe import ProteoScribe
from biom3_tpu_torch.tokenizers import Stage3Vocab


class ProteoScribeEngine:
    def __init__(
        self,
        stage_config: Config,
        model_path: str | None = None,
        *,
        device: str | torch.device = "cpu",
        temperature: float = 1.0,
        chunk_steps: int | None = 128,
        positions_per_step: int = 1,
        top_k: int | None = None,
        top_p: float | None = None,
    ):
        self.stage_config = stage_config
        self.config = ProteoScribeConfig.from_stage_config(stage_config)
        self.device = torch.device(device)
        self.vocab = Stage3Vocab()
        if model_path is not None:
            sd = load_reference_state_dict(model_path)
            model = ProteoScribe(self.config,
                                 conditional="transformer.y_mlp.0.weight" in sd)
            model.load_state_dict(sd, strict=True)
        else:
            model = seeded_init_(ProteoScribe(self.config), seed=0)
        self.model = model.to(self.device).eval()
        on_cuda = self.device.type == "cuda"
        self.dtype = torch.bfloat16 if on_cuda else torch.float32
        self.gelu = "tanh" if on_cuda else "erf"
        outer = self.config.num_timesteps // positions_per_step
        chunk = chunk_steps or None
        if chunk and (chunk > outer or outer % chunk != 0):
            chunk = None
        self.sampler = make_sampler(
            make_stack_apply(self.model, dtype=self.dtype, gelu=self.gelu),
            self.config.num_timesteps, temperature=temperature, chunk_steps=chunk,
            positions_per_step=positions_per_step, top_k=top_k, top_p=top_p,
            apply_takes_positions=True,
        )

    def sample_batch(self, z_c: np.ndarray, generator: torch.Generator, *,
                     paths: np.ndarray | None = None) -> np.ndarray:
        """z_c (B, cond_dim) → (B, L) decode-table ids.  ``paths`` may inject
        externally made permutations (parity replay)."""
        B = z_c.shape[0]
        if paths is None:
            paths = sample_permutations(generator, B, self.config.max_seq_len)
        else:
            paths = torch.as_tensor(np.asarray(paths), dtype=torch.int32, device=self.device)
        zc = torch.as_tensor(np.asarray(z_c, np.float32), device=self.device)
        return self.sampler(zc, paths, generator).cpu().numpy()

    def generate_sequences(self, z_c_all: np.ndarray, *, num_replicas: int | None = None,
                           batch_size: int | None = None, seed: int = 0) -> dict:
        """Reference CLI semantics: replica → list of cleaned sequences, one
        per prompt (run_ProteoScribe_sample.py:94-126)."""
        cfg = self.stage_config
        num_replicas = num_replicas or cfg.int("num_replicas", 5)
        batch_size = batch_size or cfg.int("batch_size_sample", 32)
        z_c_all = np.atleast_2d(np.asarray(z_c_all, np.float32))
        out = {f"replica_{i}": [] for i in range(num_replicas)}
        generator = torch.Generator(device=self.device).manual_seed(seed)
        for z in z_c_all:
            for start in range(0, num_replicas, batch_size):
                n = min(batch_size, num_replicas - start)
                ids = self.sample_batch(np.tile(z[None, :], (n, 1)), generator)
                for i in range(n):
                    seq = self.vocab.clean_sequence(self.vocab.decode_ids(ids[i]))
                    out[f"replica_{start + i}"].append(seq)
        return out

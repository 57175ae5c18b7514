"""Stage-3 inference engine: conditional sequence generation.

Port of ``biom3_tpu/pipeline/stage3.py:31-431,609-654`` for the
path-ordered ARDM sampler: for each conditioning vector z_c, generate
``num_replicas`` sequences, ``batch_size_sample`` at a time, decode with
the 29-token table and strip the markers; and the serving schedulers'
device halves (``make_continuous_stepper``, ``make_trajectory_row_fn``).

On ``cuda`` the engine runs bf16 through the kernels of the whole-stack
forward (``models/fused_forward.make_stack_apply``) with tanh GELU, the
JAX engine's accelerator choice (stage3.py:122-124), and with ``ff_quant``
and ``proj_quant`` left at ``None`` (auto) in int8, as the JAX engine
serves on an accelerator (stage3.py:131-134); on ``cpu`` the same path runs
f32 on the kernels' plain versions with exact GELU and auto means
``"none"``.  ``decode_order="confidence"`` and ``sampler_mode="maskgit"``
are not ported (ROADMAP queue 1, item 2).
"""

from __future__ import annotations

import numpy as np
import torch

from biom3_tpu_torch.config import Config, ProteoScribeConfig
from biom3_tpu_torch.diffusion.sampler import (
    make_chunk_stepper,
    make_sampler,
    sample_permutations,
)
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
        ff_quant: str | None = None,
        proj_quant: str | None = None,
        decode_order: str = "path",
        sampler_mode: str = "ardm",
    ):
        if decode_order == "confidence" or sampler_mode == "maskgit":
            raise NotImplementedError(
                f"decode_order={decode_order!r}, sampler_mode={sampler_mode!r} are not ported "
                "yet (ROADMAP queue 1, item 2)")
        if decode_order != "path" or sampler_mode != "ardm":
            raise ValueError(f"decode_order must be 'path' or 'confidence', sampler_mode "
                             f"'ardm' or 'maskgit'; got {decode_order!r}, {sampler_mode!r}")
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
        auto = "int8" if on_cuda else "none"
        self.ff_quant = auto if ff_quant is None else ff_quant
        self.proj_quant = auto if proj_quant is None else proj_quant
        outer = self.config.num_timesteps // positions_per_step
        chunk = chunk_steps or None
        if chunk and (chunk > outer or outer % chunk != 0):
            chunk = None
        self._apply_fn = make_stack_apply(self.model, dtype=self.dtype, gelu=self.gelu,
                                          ff_quant=self.ff_quant, proj_quant=self.proj_quant)
        self._sampler_cfg = dict(temperature=temperature, chunk_steps=chunk,
                                 positions_per_step=positions_per_step, top_k=top_k, top_p=top_p)
        self.sampler = make_sampler(self._apply_fn, self.config.num_timesteps,
                                    apply_takes_positions=True, **self._sampler_cfg)

    def supports_continuous_stepping(self) -> bool:
        """Exact path-order ARDM runs under the chunk-boundary continuous
        batcher — every engine of the port."""
        return True

    def make_continuous_stepper(self):
        """The per-row-offset chunk stepper over this engine's serving
        forward (same kernels, same quant modes) → ``(chunk_fn, meta)``, meta
        holding ``chunk_steps``, ``positions_per_step`` and ``num_steps``."""
        cfg = self._sampler_cfg
        k = cfg["positions_per_step"]
        chunk = cfg["chunk_steps"] or self.config.num_timesteps // k
        chunk_fn = make_chunk_stepper(
            self._apply_fn, self.config.num_timesteps, chunk_steps=chunk,
            positions_per_step=k, temperature=cfg["temperature"], top_k=cfg["top_k"],
            top_p=cfg["top_p"], apply_takes_positions=True)
        meta = {"chunk_steps": chunk, "positions_per_step": k,
                "num_steps": self.config.num_timesteps}
        return chunk_fn, meta

    def make_trajectory_row_fn(self):
        """Whole-trajectory dispatch for the row-granular packed scheduler
        (``serving/trajectory.TrajectoryBatcher``) → ``row_fn(z_c (B, C),
        inv (B, L), key_data (B, 2)) → (B, L) ids``, numpy in and a device
        tensor out, not fetched, so the scheduler overlaps its fetch with
        the next dispatch.  Each row decodes in its own order ``inv`` with
        its own noise stream (``diffusion.sampler.row_gumbel``), so a
        seeded row reproduces in any batch — the chunk stepper run over the
        whole trajectory from fresh rows."""
        cfg = self._sampler_cfg
        k = cfg["positions_per_step"]
        step = make_chunk_stepper(
            self._apply_fn, self.config.num_timesteps,
            chunk_steps=self.config.num_timesteps // k, positions_per_step=k,
            temperature=cfg["temperature"], top_k=cfg["top_k"], top_p=cfg["top_p"],
            apply_takes_positions=True)
        dev, L = self.device, self.config.max_seq_len

        def row_fn(z_c, inv, key_data):
            from biom3_tpu_torch.serving.continuous import to_device

            B = len(z_c)
            zero = torch.zeros(B, dtype=torch.int64, device=dev)
            kd = to_device(key_data, torch.int64, dev)
            x, _ = step(to_device(z_c, torch.float32, dev), to_device(inv, torch.int64, dev),
                        torch.zeros((B, L), dtype=torch.int32, device=dev), zero, kd, kd)
            return x

        return row_fn

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

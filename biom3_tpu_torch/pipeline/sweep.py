"""Large-scale generation sweep: many prompts × replicas, then bulk embedding.

Port of ``biom3_tpu/pipeline/sweep.py`` (``BASELINE.json`` config 5: many
prompts × N samples, then QC by ``cli/run_eval.py``).  The (prompt ×
replica) grid flattens into one global batch whose rows split over a
device mesh's (dp, fsdp) positions (``parallel/mesh.py``); without a mesh
it runs on one device.  The slab and padding rule is JAX's (:65-84): a
slab of ``device_batch`` rows rounded down to a multiple of the shard
count, a short last slab padded up to one.

* ``SweepRunner``: the (P·R) grid of condition vectors in slabs of
  ``device_batch`` rows through the port's ``make_sampler``; paths come
  from ``sample_permutations`` on one ``torch.Generator`` seeded from
  ``seed`` (a slab's path, then its denoising) on the global batch, and
  the rows decode with ``Stage3Vocab``; under a profiler window each slab
  (the runner's chunk of work) keeps a ``sweep.chunk`` span.  With
  ``apply_takes_positions`` the apply is the whole stack forward
  (``models/fused_forward.make_stack_apply``, which also takes
  ``attn_quant="int8"``); on a mesh of more than one shard it must be
  sharded over that mesh (``make_sharded_stack_apply(model, mesh)``).
* ``Stage1SweepRunner``: (caption, protein) token batches through a
  fused-stack ``PenCLEngine``'s ``embed_tokens`` (the tower kernels of
  ``ops/bert_stack.py`` and ``ops/esm2_stack.py``, then the projection
  heads), text rows padded with 0 and protein rows with 1 (the ESM PAD),
  each mesh position's rows on its device (the engine's ``replica`` on a
  card other than its own).  The JAX runner fixes tanh GELU; the engine's
  is tanh on the card in bf16 and can be set (``PenCLEngine(gelu=...)``).
"""

from __future__ import annotations

import numpy as np
import torch

from biom3_tpu_torch.diffusion.sampler import make_sampler, sample_permutations
from biom3_tpu_torch.parallel.mesh import canonical
from biom3_tpu_torch.parallel.sharding import (
    device_context,
    gather_rows,
    per_position,
    split_rows,
)
from biom3_tpu_torch.pipeline import require_device
from biom3_tpu_torch.tokenizers import Stage3Vocab
from biom3_tpu_torch.utils import profiling


def _slab(device_batch: int, shards: int) -> int:
    return max(shards, device_batch - device_batch % shards)


class SweepRunner:
    def __init__(self, apply_fn, num_steps: int, *, device: str | torch.device | None = None,
                 mesh=None, temperature: float = 1.0, chunk_steps: int | None = 128,
                 positions_per_step: int = 1, apply_takes_positions: bool = False,
                 top_k: int | None = None, top_p: float | None = None):
        if mesh is not None:
            if device is not None and canonical(device) != mesh.first_device:
                raise ValueError(f"device {device} is not the mesh's first position "
                                 f"({mesh.first_device})")
            device = mesh.first_device
            if mesh.batch_shards > 1 and getattr(apply_fn, "mesh", None) is not mesh:
                raise ValueError("a mesh SweepRunner needs an apply sharded over that mesh "
                                 "(models/fused_forward.make_sharded_stack_apply(model, mesh))")
        self.device = torch.device("cuda" if device is None else device)
        require_device(self.device, "SweepRunner")
        self.shards = 1 if mesh is None else mesh.batch_shards
        self.num_steps = num_steps
        self.vocab = Stage3Vocab()
        chunk = (chunk_steps if chunk_steps and num_steps % (chunk_steps * positions_per_step) == 0
                 else None)
        self.sampler = make_sampler(
            apply_fn, num_steps, temperature=temperature, chunk_steps=chunk,
            positions_per_step=positions_per_step, apply_takes_positions=apply_takes_positions,
            top_k=top_k, top_p=top_p)

    def run(self, z_c_prompts, *, num_replicas: int, seed: int = 0,
            device_batch: int = 256) -> list[list[str]]:
        """→ sequences[prompt][replica].  The (P·R) grid is processed in
        slabs of ``device_batch`` rows."""
        z_c_prompts = np.atleast_2d(np.asarray(z_c_prompts, np.float32))
        P_n, D = z_c_prompts.shape
        total = P_n * num_replicas
        grid = np.repeat(z_c_prompts, num_replicas, axis=0)   # (P·R, D)
        slab = _slab(device_batch, self.shards)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        out_ids = np.zeros((total, self.num_steps), np.int32)
        for start in range(0, total, slab):
            n = min(slab, total - start)
            with profiling.span("sweep.chunk", rows=n):
                zc = np.concatenate([grid[start:start + n],
                                     np.zeros((-n % self.shards, D), np.float32)])
                path = sample_permutations(generator, len(zc), self.num_steps)
                ids = self.sampler(torch.as_tensor(zc, device=self.device), path, generator)
                out_ids[start:start + n] = ids[:n].cpu().numpy()
        decoded = [self.vocab.clean_sequence(self.vocab.decode_ids(row)) for row in out_ids]
        return [decoded[p * num_replicas:(p + 1) * num_replicas] for p in range(P_n)]


class Stage1SweepRunner:
    """Bulk embedding of many (caption, sequence) pairs through the tower
    kernels, in slabs of ``device_batch`` pairs, over ``mesh``'s (dp, fsdp)
    positions when given (JAX :96-180)."""

    def __init__(self, engine, mesh=None, *, device_batch: int = 64):
        if not getattr(engine, "use_fused_stack", False) or engine.text_only:
            raise ValueError(
                "Stage1SweepRunner needs a fused-stack engine with BOTH "
                "towers (tower_impl='fused-stack', text_only=False) — "
                "text_only engines build only the BERT arrays"
            )
        if mesh is not None and mesh.first_device != canonical(engine.device):
            raise ValueError(f"the mesh's first position is on {mesh.first_device}, the engine "
                             f"on {engine.device}")
        self.engine = engine
        self.device_batch = device_batch
        self.shards = 1 if mesh is None else mesh.batch_shards
        self._positions = (
            [(engine.device, engine)] if mesh is None else
            list(zip(mesh.batch_devices(), per_position(
                mesh, lambda d: engine if d == canonical(engine.device) else engine.replica(d)))))

    def run(self, x_t: np.ndarray, x_p: np.ndarray):
        """Token batches (N, Lt) / (N, Lp) → (z_t, z_p) (N, proj_dim) f32."""
        N = x_t.shape[0]
        slab = _slab(self.device_batch, self.shards)
        zts, zps = [], []
        for start in range(0, N, slab):
            n = min(slab, N - start)
            n_pad = -n % self.shards
            xt = np.concatenate([x_t[start:start + n], np.zeros((n_pad, x_t.shape[1]), x_t.dtype)])
            xp = np.concatenate([x_p[start:start + n], np.ones((n_pad, x_p.shape[1]), x_p.dtype)])
            outs = []
            for (device, engine), rt, rp in zip(self._positions,
                                                split_rows(torch.from_numpy(xt), self.shards),
                                                split_rows(torch.from_numpy(xp), self.shards)):
                with device_context(device):
                    outs.append(engine.embed_tokens(rt.numpy(), rp.numpy()))
            zt, zp = gather_rows(outs, self.engine.device)
            zts.append(zt.float().cpu().numpy()[:n])
            zps.append(zp.float().cpu().numpy()[:n])
        return np.concatenate(zts), np.concatenate(zps)

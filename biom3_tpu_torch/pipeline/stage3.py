"""Stage-3 inference engine: conditional sequence generation.

Port of ``biom3_tpu/pipeline/stage3.py:31-654``: for each
conditioning vector z_c, generate
``num_replicas`` sequences, ``batch_size_sample`` at a time, decode with
the 29-token table and strip the markers; fill the masked positions of
partial sequences (``inpaint_batch``); and the serving schedulers'
device halves (``make_continuous_stepper``, ``make_trajectory_row_fn``).

On a device mesh (``parallel/mesh.py``; JAX stage3.py:219-268,276-446) the
same samplers run over the engine's forward sharded across the mesh's (dp,
fsdp) positions (``make_sharded_sampler``, ``make_sharded_inpainter``, and
the two scheduler halves given ``mesh``): the sampler's draws — paths,
noise, Philox keys — stay on the global batch on the mesh's first device,
which must be the engine's, and only the forward is split.  A shard's
logits equal the one-device forward's on the same rows bit for bit; a
whole batch's may differ from it in the last bits (splits chosen by the
row count), so the ids equal the one-device run's but at near-ties.  The
forward is the stack forward packed once per
distinct device (``models/fused_forward.make_sharded_stack_apply``), or
the module copied to each device on the module path.

``dtype`` has the JAX engine's meaning (stage3.py:36,79-83,109-134):

* ``float32`` (the default) runs the ``ProteoScribe`` module in f32 on the
  engine's device — erf GELU, no quantization, plain attention — with the
  final LayerNorm and head at the decode positions only;
* ``bfloat16`` on ``cuda`` runs the whole-stack forward on the kernels
  (``models/fused_forward.make_stack_apply``) with tanh GELU and, with
  ``ff_quant``/``proj_quant`` left at ``None`` (auto), the FF and the
  q/k/v/out projections in int8 — when ``stack_supported`` takes the
  config; otherwise the module in bf16, and the gate's reason is logged
  once;
* ``bfloat16`` on ``cpu`` runs the module in bf16 (no accelerator).

``use_stack=True`` forces the stack forward: on ``cpu`` it runs the
kernels' plain versions in f32 with erf GELU and quant auto ``"none"``;
``use_stack=False`` forces the module.

The samplers (``diffusion/sampler.py``): path-order ARDM, the reference's;
``decode_order="confidence"`` and ``sampler_mode="maskgit"`` (``maskgit_steps``
forwards), which see every position each forward — the stack forward is
given the full grid, ``gather_k = L``, as in JAX (stage3.py:98-108); and
``legacy_batch_update``, the reference's batched-update quirk, which needs
the full logit grid and so serves through the module, as JAX's does
(stage3.py:79-83).
"""

from __future__ import annotations

import numpy as np
import torch

from biom3_tpu_torch.config import Config, ProteoScribeConfig
from biom3_tpu_torch.diffusion.inpainting import make_inpainter
from biom3_tpu_torch.diffusion.sampler import (
    make_chunk_stepper,
    make_maskgit_sampler,
    make_sampler,
    sample_permutations,
)
from biom3_tpu_torch.io.state_dict import load_reference_state_dict, seeded_init_
from biom3_tpu_torch.models.fused_forward import (
    log_once,
    make_sharded_stack_apply,
    make_stack_apply,
    stack_supported,
)
from biom3_tpu_torch.models.proteoscribe import ProteoScribe
from biom3_tpu_torch.parallel.mesh import canonical
from biom3_tpu_torch.parallel.sharding import module_on, per_position, shard_rows
from biom3_tpu_torch.pipeline import require_device
from biom3_tpu_torch.tokenizers import Stage3Vocab


class ProteoScribeEngine:
    def __init__(
        self,
        stage_config: Config,
        model_path: str | None = None,
        *,
        device: str | torch.device = "cuda",
        dtype: torch.dtype = torch.float32,
        use_stack: bool | None = None,
        temperature: float = 1.0,
        legacy_batch_update: bool = False,
        chunk_steps: int | None = 128,
        positions_per_step: int = 1,
        top_k: int | None = None,
        top_p: float | None = None,
        ff_quant: str | None = None,
        proj_quant: str | None = None,
        decode_order: str = "path",
        sampler_mode: str = "ardm",
        maskgit_steps: int = 16,
    ):
        if decode_order not in ("path", "confidence"):
            raise ValueError(f"decode_order must be 'path' or 'confidence', got {decode_order!r}")
        if sampler_mode not in ("ardm", "maskgit"):
            raise ValueError(f"sampler_mode must be 'ardm' or 'maskgit', got {sampler_mode!r}")
        if sampler_mode == "maskgit" and legacy_batch_update:
            raise ValueError("legacy_batch_update replays the reference's sequential sampler; "
                             "incompatible with maskgit")
        if dtype not in (torch.float32, torch.bfloat16):
            raise ValueError(f"dtype must be torch.float32 or torch.bfloat16, got {dtype}")
        self.stage_config = stage_config
        self.config = ProteoScribeConfig.from_stage_config(stage_config)
        self.device = torch.device(device)
        self.vocab = Stage3Vocab()
        on_cuda = self.device.type == "cuda"
        # legacy replay needs the full logit grid: the module serves it
        on_accel = on_cuda and dtype == torch.bfloat16 and not legacy_batch_update
        supported, reason = stack_supported(self.config)
        if use_stack is None:
            use_stack = on_accel and supported
            if on_accel and not supported:
                log_once(f"ProteoScribeEngine: serving through the ProteoScribe module: {reason}")
        if use_stack and legacy_batch_update:
            raise ValueError("legacy_batch_update needs the full logit grid of the module: "
                             "pass use_stack=False (or None)")
        if use_stack and on_cuda and dtype != torch.bfloat16:
            raise ValueError("the stack forward's kernels run bf16 on cuda: pass "
                             "dtype=torch.bfloat16 or use_stack=False")
        self.use_stack = bool(use_stack)
        self.gate_reason = reason
        # the kernels' dtype on the stack path (bf16 on the card, f32 plain
        # versions on the CPU); the module's compute dtype otherwise
        self.dtype = (torch.bfloat16 if on_cuda else torch.float32) if self.use_stack else dtype
        self.gelu = "tanh" if self.use_stack and on_cuda else "erf"
        auto = "int8" if self.use_stack and on_cuda else "none"
        self.ff_quant = auto if ff_quant is None else ff_quant
        self.proj_quant = auto if proj_quant is None else proj_quant
        if not self.use_stack and "int8" in (self.ff_quant, self.proj_quant):
            raise ValueError("int8 quant modes need the stack forward (bf16 on cuda with a "
                             "config stack_supported takes, or use_stack=True)")
        require_device(self.device, "ProteoScribeEngine")
        if model_path is not None:
            sd = load_reference_state_dict(model_path)
            model = ProteoScribe(self.config, conditional="transformer.y_mlp.0.weight" in sd,
                                 dtype=self.dtype)
            model.load_state_dict(sd, strict=True)
        else:
            model = seeded_init_(ProteoScribe(self.config, dtype=self.dtype), seed=0)
        self.model = model.to(self.device).eval()
        outer = self.config.num_timesteps // positions_per_step
        chunk = chunk_steps or None
        if chunk and (chunk > outer or outer % chunk != 0):
            chunk = None
        # positions the forward's head runs at: every one in the modes that
        # rank the whole grid (the stack then gives (B, L, C) per forward)
        self.gather_k = (self.config.max_seq_len
                         if decode_order == "confidence" or sampler_mode == "maskgit"
                         else positions_per_step)
        takes_positions = not legacy_batch_update
        if self.use_stack:
            self._apply_fn = make_stack_apply(self.model, dtype=self.dtype, gelu=self.gelu,
                                              ff_quant=self.ff_quant, proj_quant=self.proj_quant)
        else:
            self._apply_fn = torch.no_grad()(self.model)
        self._sampler_cfg = dict(temperature=temperature, chunk_steps=chunk,
                                 positions_per_step=positions_per_step, top_k=top_k, top_p=top_p)
        self.decode_order, self.sampler_mode = decode_order, sampler_mode
        self.maskgit_steps, self.legacy_batch_update = maskgit_steps, legacy_batch_update
        # the inpainter's chunk is the constructor's value in positions (JAX
        # ``_chunk_steps_arg``), not the sampler's folded outer steps
        self._chunk_steps_arg = chunk_steps
        self._takes_positions = takes_positions
        self._inpainter = None
        self._mesh_applies: dict[int, tuple] = {}   # id(mesh) → (mesh, sharded forward)
        self.sampler = self._make_sampler(self._apply_fn)

    def _make_sampler(self, apply_fn):
        """The engine's sampler (its mode, order and settings) over ``apply_fn``."""
        cfg = self._sampler_cfg
        if self.sampler_mode == "maskgit":
            return make_maskgit_sampler(
                apply_fn, self.config.max_seq_len, steps=self.maskgit_steps,
                temperature=cfg["temperature"], top_k=cfg["top_k"], top_p=cfg["top_p"],
                apply_takes_positions=True)
        return make_sampler(apply_fn, self.config.num_timesteps,
                            legacy_batch_update=self.legacy_batch_update,
                            apply_takes_positions=self._takes_positions,
                            order=self.decode_order, **cfg)

    def _mesh_apply(self, mesh):
        """The engine's serving forward over ``mesh``'s (dp, fsdp)
        positions, built once per mesh and shared by every sampler on it
        (JAX ``_replicated_params``): the stack forward packed per
        distinct device, or the module's copies."""
        if id(mesh) not in self._mesh_applies:
            if mesh.first_device != canonical(self.device):
                raise ValueError(f"the mesh's first position is on {mesh.first_device}, the "
                                 f"engine on {self.device}: the sampler runs on the engine's "
                                 "device and gathers the shards there")
            if self.use_stack:
                apply = make_sharded_stack_apply(
                    self.model, mesh, dtype=self.dtype, gelu=self.gelu,
                    ff_quant=self.ff_quant, proj_quant=self.proj_quant)
            else:
                apply = shard_rows(per_position(
                    mesh, lambda d: torch.no_grad()(module_on(self.model, d))), mesh)
            self._mesh_applies[id(mesh)] = (mesh, apply)
        return self._mesh_applies[id(mesh)][1]

    def _check_batch(self, mesh, B: int) -> None:
        shards = mesh.batch_shards
        if B % shards:
            raise ValueError(f"batch {B} not divisible by {shards} mesh shards")

    def make_sharded_sampler(self, mesh):
        """The engine's sampler over ``mesh`` (JAX ``make_sharded_sampler``,
        stage3.py:219-268) → ``sample_rows(z_c (B, C), generator, *,
        paths=None) → (B, L)`` with ``sample_batch``'s semantics, its
        paths and noise drawn on the global batch from ``generator``; B
        must be a multiple of dp·fsdp."""
        sampler = self._make_sampler(self._mesh_apply(mesh))

        def sample_rows(z_c, generator, *, paths=None):
            self._check_batch(mesh, np.shape(z_c)[0])
            return self._sample(sampler, z_c, generator, paths)

        return sample_rows

    def make_sharded_inpainter(self, mesh):
        """The engine's inpainter over ``mesh`` (JAX
        ``make_sharded_inpainter``, stage3.py:446-521) →
        ``inpaint_rows(masked (B, L), z_c (B, C), generator=None, *,
        key_data=None) → (B, L)`` with ``inpaint_batch``'s semantics; B
        must be a multiple of dp·fsdp.  The stack forward takes the full
        grid at any width, so there is no one-device fallback."""
        apply = self._mesh_apply(mesh)
        fill = (self._make_sampler(apply) if self.sampler_mode == "maskgit"
                else self._make_inpainter(apply))

        def inpaint_rows(masked_ids, z_c, generator=None, *, key_data=None):
            self._check_batch(mesh, np.shape(masked_ids)[0])
            return self._fill(fill, masked_ids, z_c, generator, key_data)

        return inpaint_rows

    def supports_continuous_stepping(self) -> bool:
        """True when the engine's sampling runs under the chunk-boundary
        continuous batcher: exact path-order ARDM without the Q5 legacy
        replay.  MaskGIT and confidence order finish in a few forwards, and
        trajectory-start packing serves them (JAX stage3.py:362-370)."""
        return (self.sampler_mode == "ardm" and self.decode_order == "path"
                and not self.legacy_batch_update)

    def make_continuous_stepper(self, mesh=None):
        """The per-row-offset chunk stepper over this engine's serving
        forward (same kernels, same quant modes; over ``mesh``'s positions
        when given) → ``(chunk_fn, meta)``, meta holding ``chunk_steps``,
        ``positions_per_step`` and ``num_steps``."""
        if not self.supports_continuous_stepping():
            raise ValueError(
                "continuous stepping needs exact path-order ARDM "
                f"(sampler_mode={self.sampler_mode!r}, order={self.decode_order!r}, "
                f"legacy_batch_update={self.legacy_batch_update})")
        cfg = self._sampler_cfg
        k = cfg["positions_per_step"]
        chunk = cfg["chunk_steps"] or self.config.num_timesteps // k
        chunk_fn = make_chunk_stepper(
            self._apply_fn if mesh is None else self._mesh_apply(mesh),
            self.config.num_timesteps, chunk_steps=chunk,
            positions_per_step=k, temperature=cfg["temperature"], top_k=cfg["top_k"],
            top_p=cfg["top_p"], apply_takes_positions=True)
        meta = {"chunk_steps": chunk, "positions_per_step": k,
                "num_steps": self.config.num_timesteps}
        return chunk_fn, meta

    def make_trajectory_row_fn(self, mesh=None):
        """Whole-trajectory dispatch for the row-granular packed scheduler
        (``serving/trajectory.TrajectoryBatcher``) → ``row_fn(z_c (B, C),
        inv (B, L), key_data (B, 2), masked=None) → (B, L) ids``, numpy in
        and a device tensor out, not fetched, so the scheduler overlaps its
        fetch with the next dispatch.  Each row draws its noise from its own
        Philox stream (``diffusion.sampler.row_gumbel``), so a seeded row
        reproduces in any batch.  Path order decodes each row in its own
        order ``inv`` (the chunk stepper run over the whole trajectory from
        fresh rows); MaskGIT and confidence order ignore ``inv``.  Legacy
        replay writes the union of a batch's positions, so a row depends on
        its batch: it has no row function.

        ``row_fn.accepts_masked`` (JAX's second return value) is True under
        MaskGIT: inpaint rows (``masked`` (B, L), 0 at the positions to
        fill) then share generate dispatches, resuming the sampler from
        ``x0 = masked`` (zeros for a generate row).  The other modes refuse
        ``masked``.  With ``mesh`` the forward runs over its positions.
        """
        if self.legacy_batch_update:
            raise ValueError("legacy_batch_update couples the rows of a batch (union "
                             "writes): no per-row trajectory dispatch")
        cfg = self._sampler_cfg
        k = cfg["positions_per_step"]
        dev, L = self.device, self.config.max_seq_len
        accepts_masked = self.sampler_mode == "maskgit"
        apply = self._apply_fn if mesh is None else self._mesh_apply(mesh)
        sampler = self.sampler if mesh is None else self._make_sampler(apply)
        if accepts_masked:
            def run(zc, inv, kd, masked):
                return sampler(zc, inv, key_data=kd, x0=masked)
        elif self.decode_order == "confidence":
            def run(zc, inv, kd, masked):
                return sampler(zc, inv, key_data=kd)
        else:
            step = make_chunk_stepper(
                apply, self.config.num_timesteps,
                chunk_steps=self.config.num_timesteps // k, positions_per_step=k,
                temperature=cfg["temperature"], top_k=cfg["top_k"], top_p=cfg["top_p"],
                apply_takes_positions=True)

            def run(zc, inv, kd, masked):
                B = zc.shape[0]
                zero = torch.zeros(B, dtype=torch.int64, device=dev)
                x, _ = step(zc, inv, torch.zeros((B, L), dtype=torch.int32, device=dev), zero,
                            kd, kd)
                return x

        def row_fn(z_c, inv, key_data, masked=None):
            from biom3_tpu_torch.serving.continuous import to_device

            if masked is not None and not accepts_masked:
                raise ValueError("ardm trajectory dispatches cannot carry inpaint rows "
                                 "(separate executable)")
            return run(to_device(z_c, torch.float32, dev), to_device(inv, torch.int64, dev),
                       to_device(key_data, torch.int64, dev),
                       None if masked is None else to_device(masked, torch.int32, dev))

        row_fn.accepts_masked = accepts_masked
        return row_fn

    def _get_inpainter(self):
        """The confidence-order inpainter over the engine's serving forward,
        built on first use (JAX ``_get_inpainter``): every forward sees the
        full grid (the stack forward at k = L, or the module), with the
        engine's temperature, top-k and top-p.  Its chunk is the
        constructor's ``chunk_steps`` in positions, kept only where it
        divides L, and then ``early_exit`` ends the run at the first chunk
        boundary with no masked position left."""
        if self._inpainter is None:
            self._inpainter = self._make_inpainter(self._apply_fn)
        return self._inpainter

    def _make_inpainter(self, apply_fn):
        L = self.config.max_seq_len
        chunk = self._chunk_steps_arg
        if chunk and (chunk > L or L % chunk != 0):
            chunk = None
        cfg = self._sampler_cfg
        return make_inpainter(
            apply_fn, L, temperature=cfg["temperature"], apply_takes_positions=True,
            chunk_steps=chunk, order="confidence", early_exit=chunk is not None,
            top_k=cfg["top_k"], top_p=cfg["top_p"])

    def inpaint_batch(self, masked_ids, z_c, generator: torch.Generator | None = None, *,
                      key_data=None) -> np.ndarray:
        """Fill the absorbing-state (0) positions of ``masked_ids`` (B, L)
        conditioned on ``z_c`` (B, cond_dim); committed ids never change
        (JAX ``inpaint_batch``; the reference's resume-from-corruption,
        ``Stage3_source/sampling_analysis.py:21-61,96-147``).  Encode a
        user's sequence with ``Stage3Vocab.encode_partial``.  Under MaskGIT
        the engine's sampler resumes from ``x0 = masked``; otherwise the
        confidence-order inpainter fills one position a forward.  The noise
        comes from ``generator``, or from each row's Philox stream
        (``key_data`` (B, 2)), so that a row's fills depend on its key
        alone."""
        fill = self.sampler if self.sampler_mode == "maskgit" else self._get_inpainter()
        return self._fill(fill, masked_ids, z_c, generator, key_data)

    def _fill(self, fill, masked_ids, z_c, generator, key_data) -> np.ndarray:
        """``inpaint_batch``'s body over ``fill``: the MaskGIT sampler, or
        the confidence-order inpainter."""
        masked = torch.as_tensor(np.asarray(masked_ids), dtype=torch.int32, device=self.device)
        zc = torch.as_tensor(np.asarray(z_c, np.float32), device=self.device)
        if key_data is not None:
            key_data = torch.as_tensor(np.asarray(key_data).astype(np.int64), device=self.device)
        if self.sampler_mode == "maskgit":
            ids = fill(zc, None, generator, x0=masked, key_data=key_data)
        else:
            # confidence order ignores path and t0: the order comes off the
            # absorbing state
            B, L = masked.shape
            zeros = torch.zeros((B, L), dtype=torch.int32, device=self.device)
            ids = fill(masked, zc, zeros, zeros[:, 0], generator, key_data=key_data)
        return ids.cpu().numpy()

    def sample_batch(self, z_c: np.ndarray, generator: torch.Generator, *,
                     paths: np.ndarray | None = None) -> np.ndarray:
        """z_c (B, cond_dim) → (B, L) decode-table ids.  ``paths`` may inject
        externally made permutations (parity replay)."""
        return self._sample(self.sampler, z_c, generator, paths)

    def _sample(self, sampler, z_c, generator, paths) -> np.ndarray:
        B = z_c.shape[0]
        if paths is None:
            paths = sample_permutations(generator, B, self.config.max_seq_len)
        else:
            paths = torch.as_tensor(np.asarray(paths), dtype=torch.int32, device=self.device)
        zc = torch.as_tensor(np.asarray(z_c, np.float32), device=self.device)
        return sampler(zc, paths, generator).cpu().numpy()

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

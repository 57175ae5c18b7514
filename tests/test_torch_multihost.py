"""Sharded training on ``torch.distributed``: one 4-rank gloo group on the
CPU, against the JAX package's sharded steps and the port's one-process
steps (f32).

Four processes of this file run as a script (``__main__``), each on one
torch thread.  They first form (dp 2, fsdp 2), laid out as 2 hosts x 2
ranks (``make_hybrid_mesh(ranks_per_host=2)``), and run:

* Stage 3, AdamW with the EMA and ``accum_steps=2``;
* Stage 3, Adafactor, the same weights, batch, paths and timesteps;
* Stage 1, ``pfam`` with bf16 AdamW moments, on a batch where rows of
  rank 1 alone carry no mask, so a per-rank MLM mean would differ from the
  global one.

Then (``--tp 2``) the same ranks form (dp 1, fsdp 2, tp 2) and run those
cases at tp 2, with Stage 3 also at 1 of 4 heads band-local
(``stage3_mixed``: a tp rank with a band and a linear head, where 2 of 4
give one rank only band heads and the other only linear ones), the other
layer modes (``MODES``), and a save, restore and step through
``CheckpointManager`` against the unbroken run.

Last, each rank runs the per-rank ring attention body
(``ops/ring_attention.ring_attention_sharded``) on its quarter of L over
the 4 ranks, with and without a PAD mask, forward and backward through a
fixed cotangent: the gathered output against JAX's ``ring_attention`` on a
4-device CPU mesh and plain full attention, its gradients against the
one-process ``ring_attention``'s (atol 2e-5, ``tests/
test_torch_ring_attention.py``'s tolerance).

Every rank writes its aux, its gradients (the ``DTensor`` gradients
gathered whole: FSDP2 has averaged them over the ranks) and its
``state_dict`` after the step.  The test holds: every rank's aux bit-equal;
the loss within rtol 1e-4 of JAX's ``make_sharded_stage3_train_step`` /
``make_sharded_train_step`` on the 2 x 2 x 2 CPU mesh of
``tests/conftest.py`` (the same paths and timesteps, the JAX step's own
draws); the gradients within atol 5e-4·max|g|, rtol 3e-3 of JAX's global
gradient (``tests/test_torch_train.py``'s tolerance); the parameters (and
EMA) after the step within 1e-6 relative of the one-process port step's.

Run as a script by ``torchrun`` on a machine with cards, the same worker
trains seeded weights over NCCL and prints each rank's aux:
``torchrun --nproc-per-node 4 tests/test_torch_multihost.py --device cuda
[--tp 2]``.
"""

from __future__ import annotations

import argparse
import os
import pathlib
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = pathlib.Path(__file__).resolve().parent.parent
if str(REPO) not in sys.path:   # run as a script
    sys.path.insert(0, str(REPO))

from biom3_tpu_torch.config import BertConfig, Config, ESM2Config, PenCLConfig  # noqa: E402
from biom3_tpu_torch.config import ProteoScribeConfig  # noqa: E402
from biom3_tpu_torch.data.stage1_data import mask_tokens  # noqa: E402

WORLD, DP, FSDP, RANKS_PER_HOST = 4, 2, 2, 2
TP_MESH = dict(dp=1, fsdp=2, tp=2)   # the tp group: one host of 4 ranks
# dim 128: Adafactor factors a weight only where both dims reach 128
SMALL3 = dict(num_classes=29, dim=128, depth=2, n_blocks=1, heads=4, local_heads=2,
              local_window=16, max_seq_len=64, num_timesteps=64, cond_dim=16)
B3, ACCUM, LR3, KEY = 8, 2, 1e-3, 3
PENCL = dict(
    esm=dict(num_layers=1, embed_dim=64, attention_heads=2),
    bert=dict(num_layers=1, hidden_size=32, num_heads=2, intermediate_size=64, vocab_size=69,
              max_position_embeddings=32, hidden_dropout=0.0, attn_probs_dropout=0.0),
    protein_embedding=64, text_embedding=32, proj_dim=16, temperature=0.8, dropout=0.0)
B1, LT, LP = 8, 24, 32   # pairs a half (2 a rank), text and protein lengths
TEXT_MASK, PROTEIN_MASK = 4, 32
STAGE1_OPT = {"protein_encoder_lr": 1e-3, "text_encoder_lr": 2e-3, "head_lr": 3e-3,
              "weight_decay": 0.01, "moment_dtype": "bfloat16"}
S1_KW = dict(temperature=PENCL["temperature"], dataset_type="pfam", text_mask_id=TEXT_MASK,
             protein_mask_id=PROTEIN_MASK)
CASES = ("stage3_adamw", "stage3_adafactor", "stage1")
# the tp group's cases: stage3_mixed has 1 of 4 heads band-local, so at tp 2
# rank 0 holds a band and a linear head (stage3_adamw's ranks: 2 band, 2 linear)
TP_CASES = ("stage3_adamw", "stage3_mixed", "stage3_adafactor", "stage1")
LOCAL_HEADS = {"stage3_mixed": 1}
# the other layer modes on the tp mesh (AdamW, stage3_adamw's weights and
# draws): the attention on the kernels with the FF on modules, and the
# modules alone, whose tp parameters are gathered whole
MODES = {"stage3_block": dict(attn_impl="block"), "stage3_unrolled": dict(attn_impl="plain"),
         "stage3_unrolled_remat": dict(attn_impl="plain", remat=True),
         "stage1_xla": dict(attn_impl="plain")}


def stage3_config(cls=ProteoScribeConfig, case: str = "stage3_adamw"):
    return cls(**{**SMALL3, "local_heads": LOCAL_HEADS.get(case, SMALL3["local_heads"])})


def pencl_config(pencl_cls=PenCLConfig, esm_cls=ESM2Config, bert_cls=BertConfig):
    kw = dict(PENCL)
    return pencl_cls(esm=esm_cls(**kw.pop("esm")), bert=bert_cls(**kw.pop("bert")), **kw)


def batches(seed: int = 0) -> dict:
    """The global batches, numpy, the same on every rank: Stage-3 shifted
    ids with PAD tails and conditions; Stage-1 pfam pairs with BERT/ESM
    masked copies, rows 2 and 3 (rank 1's) of the SwissProt text and of
    the Pfam proteins without a mask."""
    rng = np.random.default_rng(seed)
    L = SMALL3["max_seq_len"]
    tokens = np.full((B3, L), 23, np.int64)
    for b, n in enumerate(rng.integers(8, L - 2, B3)):
        tokens[b, 0], tokens[b, 1:n + 1], tokens[b, n + 1] = 1, rng.integers(2, 22, n), 22
    out = {"tokens": tokens, "z_c": rng.standard_normal((B3, 16)).astype(np.float32)}
    for prefix in ("", "pfam_"):
        text = rng.integers(5, 69, (B1, LT))
        text[:, 0] = 2
        protein = np.full((B1, LP), 1, np.int64)
        for b, n in enumerate(rng.integers(6, LP + 1, B1)):
            protein[b, 0], protein[b, 1:n - 1], protein[b, n - 1] = 0, rng.integers(4, 24, n - 2), 2
        out[prefix + "text_tokens"], out[prefix + "protein_tokens"] = text, protein
        out[prefix + "text_tokens_masked"] = mask_tokens(text, TEXT_MASK, (0, 1, 2, 3, 4),
                                                         mask_prob=0.3, rng=rng)
        out[prefix + "protein_tokens_masked"] = mask_tokens(protein, PROTEIN_MASK, (0, 1, 2),
                                                            mask_prob=0.3, rng=rng)
    out["text_tokens_masked"][2:4] = out["text_tokens"][2:4]
    out["pfam_protein_tokens_masked"][2:4] = out["pfam_protein_tokens"][2:4]
    return out


RING = dict(B=2, H=2, L=64, D=16)   # L over the WORLD ranks
RING_CASES = ("ring", "ring_pad")


def ring_inputs(seed: int = 5) -> dict:
    """q, k, v and the cotangent (B, H, L, D) f32 and a PAD mask (B, L)."""
    rng = np.random.default_rng(seed)
    shape = (RING["B"], RING["H"], RING["L"], RING["D"])
    out = {n: rng.standard_normal(shape).astype(np.float32) for n in ("q", "k", "v", "dy")}
    out["mask"] = rng.random((RING["B"], RING["L"])) < 0.3
    return out


# --- the worker: one rank of the group ----------------------------------------

def run_ring(rank: int, world: int) -> dict:
    """The ring body on this rank's block of L over the whole group →
    case → {out, dq, dk, dv} of the block."""
    from biom3_tpu_torch.ops import ring_attention_sharded

    arrays = ring_inputs()
    block = slice(rank * RING["L"] // world, (rank + 1) * RING["L"] // world)
    out = {}
    for case in RING_CASES:
        q, k, v = (torch.from_numpy(arrays[n][:, :, block]).requires_grad_() for n in "qkv")
        mask = torch.from_numpy(arrays["mask"][:, block]) if case == "ring_pad" else None
        o = ring_attention_sharded(q, k, v, padding_mask=mask)
        (o * torch.from_numpy(arrays["dy"][:, :, block])).sum().backward()
        out[case] = {"out": o.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad}
    return out


def _worker_models(dtype: torch.dtype, device: torch.device):
    """Functions making the two models: seeded weights, the same on every
    rank (``stage3(case)``: the case's local heads, the same weights)."""
    from biom3_tpu_torch.io.state_dict import seeded_init_
    from biom3_tpu_torch.models.pencl import PenCL
    from biom3_tpu_torch.models.proteoscribe import ProteoScribe

    def stage3(case="stage3_adamw"):
        model = ProteoScribe(stage3_config(case=case), dtype=dtype,
                             **MODES.get(case, dict(attn_impl="layer-block")))
        return seeded_init_(model, 0).to(device)

    def stage1(case="stage1"):
        model = PenCL(pencl_config(), dtype=dtype, mlm_heads=True,
                      **MODES.get(case, dict(attn_impl="layer-block")))
        return seeded_init_(model, 1).to(device)

    return stage3, stage1


def _recorded(state) -> dict:
    """Gather the step's gradients whole just before the optimizer step."""
    from biom3_tpu_torch.training.state import full

    grads, step = {}, state.tx.step

    def step_and_record():
        grads.update({n: full(p.grad) for n, p in state.model.named_parameters()})
        step()

    state.tx.step = step_and_record
    return grads


def _placements(model) -> dict:
    """Parameter name → its ``DTensor`` placements: None to replicate,
    else the dim a mesh dim shards."""
    return {n: [getattr(pl, "dim", None) for pl in p.placements]
            for n, p in model.named_parameters()}


STAGE3_CASES = {"stage3_adamw": ("AdamW", ACCUM), "stage3_mixed": ("AdamW", ACCUM),
                "stage3_adafactor": ("Adafactor", 1),
                **{m: ("AdamW", ACCUM) for m in MODES if m.startswith("stage3")}}


def _stage3_step(case: str, mesh, device, dtype):
    from biom3_tpu_torch.training.optim import make_optimizer
    from biom3_tpu_torch.training.stage3_task import make_sharded_stage3_train_step

    optimizer, accum = STAGE3_CASES[case]
    return make_sharded_stage3_train_step(
        _worker_models(dtype, device)[0](case),
        lambda m: make_optimizer(optimizer, m.parameters(), LR3, weight_decay=0.01),
        mesh, with_ema=True, accum_steps=accum, ema_beta=0.9)


def _resumed(mesh, device, dtype, batch3, draws, directory) -> dict:
    """Stage 3 (AdamW, EMA): two steps unbroken, and one step, a save, a
    restore into a fresh sharded state and one more step → each run's
    parameters, EMA and optimizer state after its last step."""
    from biom3_tpu_torch.io.checkpoint import CheckpointManager

    def after(state):
        sd = state.state_dict()
        return {"params": sd["params"], "ema": sd["ema"], "opt": sd["opt"]}

    step, state = _stage3_step("stage3_adamw", mesh, device, dtype)
    ckpt = CheckpointManager(directory)
    step(batch3, **draws)
    ckpt.save(1, state)
    step(batch3, **draws)
    unbroken = after(state)
    step, state = _stage3_step("stage3_adamw", mesh, device, dtype)
    ckpt.restore(state)
    step(batch3, **draws)
    return {"unbroken": unbroken, "resumed": after(state), "step": state.step}


def run_rank(inputs: dict, mesh, device: torch.device, dtype: torch.dtype,
             out_dir: pathlib.Path | None = None) -> dict:
    """Every case on this rank → case → {aux, grads, params, [ema]}; on a
    mesh with tp > 1 also the resumed run (``_resumed``), its checkpoint
    under ``out_dir``."""
    from biom3_tpu_torch.parallel.mesh import axis_sizes
    from biom3_tpu_torch.training.stage1_task import (
        make_sharded_stage1_train_step,
        make_stage1_optimizer,
    )

    tp = axis_sizes(mesh)["tp"] > 1
    cases = (*TP_CASES, *MODES) if tp else CASES
    _, stage1 = _worker_models(dtype, device)
    t = lambda k: torch.as_tensor(inputs[k]).to(device)  # noqa: E731
    batch3 = {"tokens": t("tokens"), "z_c": t("z_c")}
    draws = dict(path=t("path"), t=t("t")) if "path" in inputs else {}
    out = {}
    for case in (c for c in cases if c in STAGE3_CASES):
        step, state = _stage3_step(case, mesh, device, dtype)
        grads = _recorded(state)
        aux = step(batch3, torch.Generator(device).manual_seed(0), **draws)
        sd = state.state_dict()
        out[case] = {"aux": aux, "grads": grads, "params": sd["params"], "opt": sd["opt"],
                     "ema": state.ema_state_dict(), "placements": _placements(state.model)}
    for case in (c for c in cases if c.startswith("stage1")):
        step, state = make_sharded_stage1_train_step(
            stage1(case), lambda m: make_stage1_optimizer(Config(STAGE1_OPT), m), mesh, **S1_KW)
        grads = _recorded(state)
        aux = step({k: t(k) for k in inputs if "text" in k or "protein" in k})
        sd = state.state_dict()
        out[case] = {"aux": aux, "grads": grads, "params": sd["params"], "opt": sd["opt"],
                     "placements": _placements(state.model)}
    if tp and draws:
        out["resume"] = _resumed(mesh, device, dtype, batch3, draws, out_dir / "ckpt")
    return out


def worker(argv=None) -> None:
    import torch.distributed as dist

    from biom3_tpu_torch.parallel.distributed import initialize_distributed, make_hybrid_mesh
    from biom3_tpu_torch.parallel.mesh import MeshConfig

    p = argparse.ArgumentParser(description="one rank of the sharded training test")
    p.add_argument("--address", help="tcp://host:port of rank 0 (default: torchrun's env://)")
    p.add_argument("--rank", type=int)
    p.add_argument("--world", type=int)
    p.add_argument("--device", default="cpu")
    p.add_argument("--inputs", help="batches and draws (default: the seeded batches, draws "
                                    "from a seeded generator)")
    p.add_argument("--out", help="directory for rank<r>.pt")
    p.add_argument("--tp", type=int, default=1,
                   help="2 or 4: then also the (dp 1, fsdp 4/tp, tp) mesh of the same ranks "
                        "and its cases (TP_CASES)")
    args = p.parse_args(argv)
    torch.set_num_threads(1)
    device = initialize_distributed(args.address, args.world, args.rank, device=args.device)
    ranks_per_host = RANKS_PER_HOST if args.device == "cpu" else None
    mesh = make_hybrid_mesh(MeshConfig(dp=DP, fsdp=FSDP), ranks_per_host=ranks_per_host)
    inputs = torch.load(args.inputs, weights_only=True) if args.inputs else batches()
    dtype = torch.float32 if device.type == "cpu" else torch.bfloat16
    out_dir = pathlib.Path(args.out) if args.out else None
    out = run_rank(inputs, mesh, device, dtype)
    out["mesh"] = mesh.mesh.tolist()
    runs = {"": out}
    if args.tp > 1:
        tp_mesh = make_hybrid_mesh(MeshConfig(dp=1, fsdp=WORLD // args.tp, tp=args.tp))
        out["tp"] = runs[f"tp {args.tp} "] = run_rank(inputs, tp_mesh, device, dtype, out_dir)
        out["tp"]["mesh"] = tp_mesh.mesh.tolist()
    rank = dist.get_rank()
    if device.type == "cpu":
        out["ring"] = run_ring(rank, dist.get_world_size())
    if out_dir:
        torch.save(out, out_dir / f"rank{rank}.pt")
    for what, run in runs.items():
        for case in (*TP_CASES, *MODES) if what else CASES:
            print(f"rank {rank} {what}{case}: " + ", ".join(
                f"{k} {float(v):.6f}" for k, v in run[case]["aux"].items()), flush=True)
    dist.destroy_process_group()


# --- the test: JAX's side, the one-process port steps, the group --------------

def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _jax_draws() -> dict:
    """The paths and timesteps JAX's sharded Stage-3 step draws from
    ``KEY`` (``stage3_task.py:33-41``, ``accum_steps`` keys), for the port."""
    import jax
    import jax.numpy as jnp

    from biom3_tpu.diffusion import oa_ardm as joa

    mb, L = B3 // ACCUM, SMALL3["max_seq_len"]
    paths, ts = [], []
    for k in jax.random.split(jax.random.key(KEY), ACCUM):
        k_path, k_t, _ = jax.random.split(k, 3)
        paths.append(joa.sample_random_paths(k_path, mb, L))
        ts.append(joa.sample_timesteps(k_t, mb, L))
    return {"path": np.asarray(jnp.concatenate(paths)).astype(np.int64),
            "t": np.asarray(jnp.concatenate(ts)).astype(np.int64)}


def _jax_side(inputs: dict) -> dict:
    """JAX's sharded steps on the 2 x 2 x 2 CPU mesh, on the seeded weights
    (through the JAX package's converters) → their losses and global
    gradients.  Their optimizer is SGD at rate 1, so the parameters they
    return are the weights minus the gradient."""
    import jax
    import jax.numpy as jnp
    import optax

    from biom3_tpu.config import BertConfig as JBert, ESM2Config as JESM2
    from biom3_tpu.config import PenCLConfig as JPenCL, ProteoScribeConfig as JProteoScribe
    from biom3_tpu.io.convert import proteoscribe_params_from_torch
    from biom3_tpu.io.convert_stage1 import pencl_params_from_torch
    from biom3_tpu.models.pencl import PenCL as JaxPenCL
    from biom3_tpu.models.proteoscribe import ProteoScribe as JaxProteoScribe
    from biom3_tpu.parallel.mesh import MeshConfig as JMeshConfig, make_mesh as jax_make_mesh
    from biom3_tpu.training.sharded import make_sharded_train_step as jax_sharded_step
    from biom3_tpu.training.stage1_task import make_stage1_train_step as jax_stage1_step
    from biom3_tpu.training.stage3_task import make_sharded_stage3_train_step as jax_stage3
    from biom3_tpu_torch.io.from_jax import pencl_params_to_torch, proteoscribe_params_to_torch

    mesh = jax_make_mesh(JMeshConfig(dp=2, fsdp=2, tp=2))
    sgd = optax.sgd(1.0)
    stage3, stage1 = _worker_models(torch.float32, torch.device("cpu"))
    numpy = lambda sd: {k: v.detach().numpy() for k, v in sd.items()}  # noqa: E731

    def gradient(before, after):
        return jax.tree_util.tree_map(lambda p, q: np.asarray(p) - np.asarray(q), before, after)

    out = {}
    for case, key in (("stage3_adamw", "stage3"), ("stage3_mixed", "stage3_mixed")):
        cfg3 = stage3_config(JProteoScribe, case)
        v3 = proteoscribe_params_from_torch(numpy(stage3(case).state_dict()), cfg3)
        step3, state3 = jax_stage3(JaxProteoScribe(cfg3).apply, sgd, mesh, v3, with_ema=False,
                                   accum_steps=ACCUM)
        state3, aux3 = step3(state3, {"tokens": jnp.asarray(inputs["tokens"], jnp.int32),
                                      "z_c": jnp.asarray(inputs["z_c"])}, jax.random.key(KEY))
        out.update({f"{key}_loss": float(aux3["loss"]), f"{key}_acc": float(aux3["acc_unsampled"]),
                    f"{key}_grads": proteoscribe_params_to_torch(gradient(v3, state3.params),
                                                                 cfg3)})
    cfg1 = pencl_config(JPenCL, JESM2, JBert)
    v1 = pencl_params_from_torch(numpy(stage1().state_dict()), cfg1)
    step1 = jax_stage1_step(JaxPenCL(cfg1).apply, sgd, with_metrics=False, **S1_KW)
    run1, state1 = jax_sharded_step(step1, sgd, mesh, v1, has_rng=False)
    state1, aux1 = run1(state1, {k: jnp.asarray(v, jnp.int32) for k, v in inputs.items()
                                 if "text" in k or "protein" in k})
    return {**out, "stage1_loss": float(aux1["loss"]),
            "stage1_grads": pencl_params_to_torch(gradient(v1, state1.params), cfg1)}


def _one_rank(case: str):
    """A seeded model of ``case`` on the CPU and its ``TrainState`` (the
    case's optimizer, the EMA for Stage 3)."""
    from biom3_tpu_torch.training.optim import make_optimizer
    from biom3_tpu_torch.training.stage1_task import make_stage1_optimizer
    from biom3_tpu_torch.training.state import TrainState

    stage3, stage1 = _worker_models(torch.float32, torch.device("cpu"))
    if case == "stage1":
        model = stage1()
        return TrainState(model, make_stage1_optimizer(Config(STAGE1_OPT), model))
    model = stage3(case)
    name = STAGE3_CASES[case][0]
    return TrainState(model, make_optimizer(name, model.parameters(), LR3, weight_decay=0.01),
                      with_ema=True)


def _one_process(inputs: dict) -> dict:
    """The port's one-process steps on the whole batch, same weights,
    draws and optimizers → case → {aux, grads}."""
    from biom3_tpu_torch.training.stage1_task import make_stage1_train_step
    from biom3_tpu_torch.training.stage3_task import make_stage3_train_step

    t = lambda k: torch.as_tensor(inputs[k])  # noqa: E731
    out = {}
    for case in TP_CASES:
        state = _one_rank(case)
        grads = _recorded(state)
        if case == "stage1":
            aux = make_stage1_train_step(state, **S1_KW)({k: t(k) for k in inputs
                                                          if "text" in k or "protein" in k})
        else:
            step = make_stage3_train_step(state, accum_steps=STAGE3_CASES[case][1],
                                          ema_beta=0.9)
            aux = step({"tokens": t("tokens"), "z_c": t("z_c")}, path=t("path"), t=t("t"))
        out[case] = {"aux": aux, "grads": grads}
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Start the 4 ranks on JAX's draws (``--tp 2``: after the (dp 2, fsdp
    2) cases the same ranks run the (dp 1, fsdp 2, tp 2) ones), compute
    JAX's side and the one-process steps meanwhile → (ranks' outputs,
    JAX's, one-process)."""
    tmp = tmp_path_factory.mktemp("multihost")
    inputs = {**batches(), **_jax_draws()}
    torch.save({k: torch.from_numpy(v) for k, v in inputs.items()}, tmp / "inputs.pt")
    env = {**os.environ, "OMP_NUM_THREADS": "1", "PYTHONPATH": str(REPO)}
    address = f"tcp://localhost:{_free_port()}"
    procs = []
    try:
        for rank in range(WORLD):
            with open(tmp / f"rank{rank}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, __file__, "--address", address, "--rank", str(rank),
                     "--world", str(WORLD), "--inputs", str(tmp / "inputs.pt"), "--out",
                     str(tmp), "--tp", str(TP_MESH["tp"])], cwd=REPO, env=env, stdout=log,
                    stderr=subprocess.STDOUT))
        jax_side, one = _jax_side(inputs), _one_process(inputs)
        rcs = [p.wait(timeout=240) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = "\n".join((tmp / f"rank{r}.log").read_text()[-3000:] for r in range(WORLD))
    assert rcs == [0] * WORLD, logs
    ranks = [torch.load(tmp / f"rank{r}.pt", weights_only=True) for r in range(WORLD)]
    return ranks, jax_side, one


@pytest.fixture(scope="module")
def tp_group(group):
    """The (dp 1, fsdp 2, tp 2) mesh's outputs → (ranks' outputs, JAX's,
    one-process)."""
    ranks, jax_side, one = group
    return [out["tp"] for out in ranks], jax_side, one


def test_hybrid_mesh_is_host_major(group):
    """dp across hosts, each (fsdp, tp) block inside one host of 2 ranks."""
    ranks, _, _ = group
    for out in ranks:
        assert out["mesh"] == [[[0], [1]], [[2], [3]]]


@pytest.mark.parametrize("case", ["stage3_adamw", "stage1"])
def test_fsdp_places_each_parameter_by_its_spec(group, case):
    """Replicated over dp, sharded over fsdp on the dim
    ``param_partition_spec`` names (dim 0 where JAX replicates)."""
    from biom3_tpu_torch.models.pencl import PenCL
    from biom3_tpu_torch.models.proteoscribe import ProteoScribe
    from biom3_tpu_torch.parallel import MeshConfig, params_shardings
    from biom3_tpu_torch.parallel.mesh import fsdp_dim

    ranks, _, _ = group
    model = (ProteoScribe(stage3_config()) if case != "stage1"
             else PenCL(pencl_config(), mlm_heads=True))
    specs = params_shardings(model, MeshConfig(dp=DP, fsdp=FSDP))
    placements = ranks[0][case]["placements"]
    assert set(placements) == set(specs)
    for name, spec in specs.items():
        dim = fsdp_dim(spec)
        assert placements[name] == [None, 0 if dim is None else dim], name
    assert any(fsdp_dim(spec) == 1 for spec in specs.values())


@pytest.mark.parametrize("case", CASES)
def test_every_rank_reports_the_same_bits(group, case):
    """aux bit-equal on every rank; the state dict whole and equal too."""
    ranks, _, _ = group
    first = ranks[0][case]
    for out in ranks[1:]:
        assert set(out[case]["aux"]) == set(first["aux"])
        for k, v in out[case]["aux"].items():
            assert torch.equal(v, first["aux"][k]), (case, k)
        for k, v in out[case]["params"].items():
            assert v.shape == first["params"][k].shape and torch.equal(v, first["params"][k]), k


def _grads_close(got: dict, want: dict) -> None:
    assert set(got) == set(want) - {"protein_encoder.model.lm_head.weight"}
    for name, g in got.items():
        w = np.asarray(want[name]).reshape(g.shape)
        scale = max(1e-3, float(np.abs(w).max()))
        np.testing.assert_allclose(g.numpy(), w, atol=5e-4 * scale, rtol=3e-3, err_msg=name)


@pytest.mark.parametrize("case", ["stage3_adamw", "stage3_adafactor", "stage1"])
def test_loss_and_gradients_match_jax(group, case):
    """The loss against the JAX sharded step's (the JAX step's own draws),
    rtol 1e-4; the all-reduced gradients against JAX's global gradient."""
    ranks, jax_side, _ = group
    stage = case.split("_")[0]
    aux = ranks[0][case]["aux"]
    np.testing.assert_allclose(float(aux["loss"]), jax_side[f"{stage}_loss"], rtol=1e-4)
    if case == "stage3_adamw":   # the JAX step's accum_steps: the same microbatches
        np.testing.assert_allclose(float(aux["acc_unsampled"]), jax_side["stage3_acc"],
                                   atol=1e-6)
    _grads_close(ranks[0][case]["grads"], jax_side[f"{stage}_grads"])


@pytest.mark.parametrize("case", CASES)
def test_loss_and_gradients_match_one_process(group, case):
    """Against the port's one-process step on the whole batch (same
    weights, draws, optimizer): every aux value within rtol 1e-6, every
    gradient within rtol 1e-4 and atol 1e-6 of the largest |g| of the whole
    gradient (f32 sums in another order: a tensor whose gradient cancels to
    near 0, such as BERT's key bias, keeps the rounding of its terms)."""
    ranks, _, one = group
    got, want = ranks[0][case], one[case]
    for k, v in want["aux"].items():
        np.testing.assert_allclose(float(got["aux"][k]), float(v), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert set(got["grads"]) == set(want["grads"])
    scale = max(float(v.abs().max()) for v in want["grads"].values())
    for k, v in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=k)


@pytest.mark.parametrize("case", CASES)
def test_sharded_optimizer_matches_one_rank(group, case):
    """AdamW, Adafactor and bf16-moment AdamW on FSDP2's shards: the
    parameters (and the EMA) after the step, and the optimizer's state
    gathered whole (AdamW's moments, Adafactor's factored row and column
    statistics of weights sharded on dim 0 and on dim 1), within 1e-6
    relative (of each tensor's largest value) of the same optimizer on one
    rank stepping on the same, gathered gradients.  (Against the
    one-process step's own gradients the first AdamW step magnifies the
    f32 rounding of a gradient near 0, whose sign it takes.)"""
    ranks, _, _ = group
    got = ranks[0][case]
    state = _one_rank(case)
    for n, p in state.model.named_parameters():
        p.grad = got["grads"][n].clone()
    state.apply_gradients(0.9)
    sd = state.state_dict()
    want = {"params": sd["params"]}
    if case != "stage1":
        want["ema"] = state.ema_state_dict()
    opt, got_opt = sd["opt"]["opt"]["state"], got["opt"]["opt"]["state"]
    assert set(opt) == set(got_opt) == set(range(len(sd["params"])))
    for i, moments in opt.items():
        assert set(moments) == set(got_opt[i]), moments.keys()
        for k, v in moments.items():
            if isinstance(v, torch.Tensor) and v.dim():
                scale = float(v.float().abs().max())
                np.testing.assert_allclose(got_opt[i][k].float().numpy(), v.float().numpy(),
                                           rtol=1e-6, atol=1e-6 * scale, err_msg=f"opt {i} {k}")
            else:
                assert float(got_opt[i][k]) == float(v), (i, k)
    if case == "stage3_adafactor":
        assert any("v_row" in m for m in opt.values())
    for part, sd in want.items():
        assert set(got[part]) == set(sd)
        for k, v in sd.items():
            scale = float(v.abs().max())
            np.testing.assert_allclose(got[part][k].numpy(), v.numpy(), rtol=1e-6,
                                       atol=1e-6 * scale, err_msg=f"{part} {k}")


def test_uneven_masks_are_the_global_mean(group):
    """Rank 1's rows hold fewer masked samples than the others': the MLM
    terms equal the one-process step's global mean, which the mean of the
    ranks' own means would miss."""
    ranks, _, one = group
    b = batches()
    has = [(np.concatenate([b[f"{p}text_tokens_masked"][r * 2:(r + 1) * 2]
                            for p in ("", "pfam_")]) == TEXT_MASK).any(-1).sum()
           for r in range(WORLD)]
    assert len(set(has)) > 1, has
    for k in ("loss_text_mask", "loss_seq_mask"):
        np.testing.assert_allclose(float(ranks[0]["stage1"]["aux"][k]),
                                   float(one["stage1"]["aux"][k]), rtol=1e-6)


# --- the tp group: (dp 1, fsdp 2, tp 2) ---------------------------------------

def _jax_key(case: str) -> str:
    return "stage3_mixed" if case == "stage3_mixed" else case.split("_")[0]


@pytest.mark.parametrize("case", MODES)
def test_tp_layer_modes_match_jax(tp_group, case):
    """``block`` (the attention sub-block on the kernels over the rank's
    heads, the FF on modules over its shards, both between ``copy_to_tp``
    and ``reduce_from_tp``), ``unrolled``, ``unrolled_remat`` and Stage-1
    ``xla`` (modules whose tp parameters are gathered whole) at tp 2:
    every rank's aux bit-equal, the loss and gradients against JAX's
    sharded step at ``test_tp_loss_and_gradients_match_jax``'s
    tolerances."""
    ranks, jax_side, _ = tp_group
    first = ranks[0][case]["aux"]
    for out in ranks[1:]:
        for k, v in out[case]["aux"].items():
            assert torch.equal(v, first[k]), (case, k)
    key = _jax_key(case)
    np.testing.assert_allclose(float(first["loss"]), jax_side[f"{key}_loss"], rtol=1e-4)
    _grads_close(ranks[0][case]["grads"], jax_side[f"{key}_grads"])


def test_tp_mesh_is_one_host(tp_group):
    """One (fsdp, tp) block of 4 ranks: tp pairs (0, 1) and (2, 3)."""
    ranks, _, _ = tp_group
    for out in ranks:
        assert out["mesh"] == [[[0, 1], [2, 3]]]


@pytest.mark.parametrize("case", ["stage3_adamw", "stage1"])
def test_tp_places_each_parameter_by_its_spec(tp_group, case):
    """FSDP2's (FSDP + TP) layout on the (dp, fsdp, tp) mesh: replicated
    over dp, sharded over fsdp on the spec's fsdp dim (FSDP2's dim 0 where
    JAX puts none) and over tp on the spec's tp dim (replicated where JAX
    puts none); every tp-sharded weight of the layers lies on the dim the
    column/row rule gives."""
    from biom3_tpu_torch.models.pencl import PenCL
    from biom3_tpu_torch.models.proteoscribe import ProteoScribe
    from biom3_tpu_torch.parallel import MeshConfig, params_shardings
    from biom3_tpu_torch.parallel.mesh import fsdp_dim

    ranks, _, _ = tp_group
    model = (ProteoScribe(stage3_config()) if case != "stage1"
             else PenCL(pencl_config(), mlm_heads=True))
    specs = params_shardings(model, MeshConfig(**TP_MESH))
    placements = ranks[0][case]["placements"]
    assert set(placements) == set(specs)
    for name, spec in specs.items():
        dim = fsdp_dim(spec)
        tp_dim = spec.index("tp") if "tp" in spec else None
        assert placements[name] == [None, 0 if dim is None else dim, tp_dim], name
    assert sum("tp" in spec for spec in specs.values()) > 8
    if case == "stage3_adamw":
        layer = "transformer.transformer_blocks.0.0.layers.layers."
        for leaf, tp_dim in (("0.0.fn.to_q.weight", 0), ("0.0.fn.to_out.weight", 1),
                             ("0.1.fn.fn.w1.weight", 0), ("0.1.fn.fn.w2.weight", 1)):
            assert placements[layer + leaf][2] == tp_dim, leaf


@pytest.mark.parametrize("case", TP_CASES)
def test_tp_every_rank_reports_the_same_bits(tp_group, case):
    """aux bit-equal on all four ranks (the two tp pairs too); the gathered
    state dict whole and equal."""
    ranks, _, _ = tp_group
    first = ranks[0][case]
    for out in ranks[1:]:
        assert set(out[case]["aux"]) == set(first["aux"])
        for k, v in out[case]["aux"].items():
            assert torch.equal(v, first["aux"][k]), (case, k)
        for k, v in out[case]["params"].items():
            assert v.shape == first["params"][k].shape and torch.equal(v, first["params"][k]), k


@pytest.mark.parametrize("case", TP_CASES)
def test_tp_loss_and_gradients_match_jax(tp_group, case):
    """The loss against JAX's sharded step on the 2 x 2 x 2 mesh (rtol
    1e-4), the gradients against its global gradient.  Stage 3 at 2 of 4
    heads band-local gives one tp rank only band heads and the other only
    linear ones; at 1 of 4 rank 0 runs a band and a linear head.  Stage 1
    gathers the contrastive latents over the (dp, fsdp) ranks only: over
    the world group each row would appear twice, and the InfoNCE terms
    would differ."""
    ranks, jax_side, _ = tp_group
    key = _jax_key(case)
    aux = ranks[0][case]["aux"]
    np.testing.assert_allclose(float(aux["loss"]), jax_side[f"{key}_loss"], rtol=1e-4)
    if case in ("stage3_adamw", "stage3_mixed"):
        np.testing.assert_allclose(float(aux["acc_unsampled"]), jax_side[f"{key}_acc"],
                                   atol=1e-6)
    _grads_close(ranks[0][case]["grads"], jax_side[f"{key}_grads"])


@pytest.mark.parametrize("case", TP_CASES)
def test_tp_loss_and_gradients_match_one_process(tp_group, case):
    """Against the port's one-process step on the whole batch, at
    ``test_loss_and_gradients_match_one_process``'s tolerances."""
    ranks, _, one = tp_group
    got, want = ranks[0][case], one[case]
    for k, v in want["aux"].items():
        np.testing.assert_allclose(float(got["aux"][k]), float(v), rtol=1e-6, atol=1e-7,
                                   err_msg=k)
    assert set(got["grads"]) == set(want["grads"])
    scale = max(float(v.abs().max()) for v in want["grads"].values())
    for k, v in want["grads"].items():
        np.testing.assert_allclose(got["grads"][k].numpy(), v.numpy(), rtol=1e-4,
                                   atol=1e-6 * scale, err_msg=k)


@pytest.mark.parametrize("case", TP_CASES)
def test_tp_sharded_optimizer_matches_one_rank(tp_group, case):
    """AdamW (with the EMA), Adafactor (its factored means over fsdp- and
    tp-sharded dims) and bf16-moment AdamW on the (FSDP + TP) shards: the
    parameters, the EMA and the optimizer state after the step within
    1e-6 relative of the same optimizer stepping on one rank on the same
    gathered gradients (``test_sharded_optimizer_matches_one_rank``)."""
    test_sharded_optimizer_matches_one_rank(tp_group, case)


def test_tp_resume_equals_unbroken_run(tp_group):
    """A sharded (dp 1, fsdp 2, tp 2) Stage-3 state saved by
    ``CheckpointManager`` after one step, restored into a fresh sharded
    state and stepped once equals two unbroken steps bit for bit: the
    parameters, the EMA and AdamW's moments."""
    ranks, _, _ = tp_group
    for out in ranks:
        run = out["resume"]
        assert run["step"] == 2
        for part in ("params", "ema"):
            want, got = run["unbroken"][part], run["resumed"][part]
            items = want.items() if isinstance(want, dict) else enumerate(want)
            for k, v in items:
                assert torch.equal(got[k], v), (part, k)
        opt, got_opt = run["unbroken"]["opt"]["opt"]["state"], run["resumed"]["opt"]["opt"]["state"]
        assert set(opt) == set(got_opt)
        for i, moments in opt.items():
            for k, v in moments.items():
                assert torch.equal(got_opt[i][k], v), (i, k)


@pytest.mark.parametrize("case", RING_CASES)
def test_ring_body_matches_jax_and_one_process(group, case):
    """The 4 ranks' ring body gathered along L against JAX's
    ``ring_attention`` on a 4-device CPU mesh and plain full attention; its
    gradients against the one-process ``ring_attention``'s through autograd
    on the same cotangent."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh as JaxMesh

    from biom3_tpu.ops.ring_attention import ring_attention as jax_ring_attention
    from biom3_tpu_torch.ops import full_attention, ring_attention
    from biom3_tpu_torch.parallel.mesh import MeshConfig as PortMeshConfig, make_mesh

    ranks, _, _ = group
    arrays = ring_inputs()
    mask = arrays["mask"] if case == "ring_pad" else None
    got = {n: torch.cat([r["ring"][case][n] for r in ranks], dim=2).numpy()
           for n in ("out", "dq", "dk", "dv")}
    jmesh = JaxMesh(np.asarray(jax.devices()[:WORLD]), ("tp",))
    want = jax_ring_attention(*(jnp.asarray(arrays[n]) for n in "qkv"), jmesh,
                              padding_mask=None if mask is None else jnp.asarray(mask))
    np.testing.assert_allclose(got["out"], np.asarray(want), atol=2e-5)
    q, k, v = (torch.from_numpy(arrays[n]).requires_grad_() for n in "qkv")
    tmask = None if mask is None else torch.from_numpy(mask)
    plain = full_attention(q.detach(), k.detach(), v.detach(), tmask, impl="plain")
    np.testing.assert_allclose(got["out"], plain.numpy(), atol=2e-5)
    mesh = make_mesh(PortMeshConfig(tp=WORLD), [torch.device("cpu")] * WORLD)
    one = ring_attention(q, k, v, mesh, padding_mask=tmask)
    grads = torch.autograd.grad((one * torch.from_numpy(arrays["dy"])).sum(), (q, k, v))
    for name, g in zip(("dq", "dk", "dv"), grads):
        np.testing.assert_allclose(got[name], g.numpy(), atol=2e-5, err_msg=name)


if __name__ == "__main__":
    worker()

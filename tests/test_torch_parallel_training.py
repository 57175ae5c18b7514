"""The training half of ``biom3_tpu_torch.parallel`` in one process (CPU).

* ``param_partition_spec`` against the JAX package's for every parameter
  of a tiny ProteoScribe and a tiny PenCL (MLM heads included), on three
  mesh shapes: each spec is written into its parameter as the fsdp and tp
  shard index of every element, the JAX arrays go through the export
  mapping (which transposes the Flax kernels), and the port's must match
  element for element;
* ``batch_sharding`` and ``put_global`` against JAX's ``P(("dp",
  "fsdp"))`` shards on the 2 x 2 x 2 CPU mesh;
* a tp rank's heads (``TensorParallel.heads``: band-local heads first);
  ``initialize_distributed`` refusing without a card unless the caller
  asks for the CPU; ``make_hybrid_mesh``'s checks;
* on a one-rank gloo group, the sharded Stage-3 and Stage-1 steps equal the
  one-device steps bit for bit (the smoke's one NCCL rank on the card),
  and a sharded state saved by ``CheckpointManager``, restored into a
  fresh sharded state and stepped equals the unbroken run.  tp > 1 runs in
  ``tests/test_torch_multihost.py``'s 4-rank group.
"""

import socket

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from biom3_tpu.config import BertConfig as JBert, ESM2Config as JESM2
from biom3_tpu.config import PenCLConfig as JPenCL, ProteoScribeConfig as JProteoScribe
from biom3_tpu.models.pencl import PenCL as JaxPenCL
from biom3_tpu.models.proteoscribe import ProteoScribe as JaxProteoScribe
from biom3_tpu.parallel.mesh import MeshConfig as JMeshConfig, make_mesh as jax_make_mesh
from biom3_tpu.parallel.sharding import batch_sharding as jax_batch_sharding
from biom3_tpu.parallel.sharding import params_shardings as jax_params_shardings
from biom3_tpu_torch.config import Config
from biom3_tpu_torch.io.from_jax import (
    pencl_params_to_torch,
    port_config,
    proteoscribe_params_to_torch,
)
from biom3_tpu_torch.io.state_dict import seeded_init_
from biom3_tpu_torch.models.pencl import PenCL
from biom3_tpu_torch.models.proteoscribe import ProteoScribe
from biom3_tpu_torch.parallel import MeshConfig, param_partition_spec, params_shardings
from biom3_tpu_torch.parallel.distributed import initialize_distributed, make_hybrid_mesh
from biom3_tpu_torch.parallel.mesh import AXES
from biom3_tpu_torch.io.checkpoint import CheckpointManager
from biom3_tpu_torch.parallel.sharding import batch_sharding, data_group, put_global
from biom3_tpu_torch.parallel.tensor import TensorParallel
from biom3_tpu_torch.training.optim import AdamWMoments, Optimizer, make_optimizer
from biom3_tpu_torch.training.stage1_task import (
    make_sharded_stage1_train_step,
    make_stage1_optimizer,
    make_stage1_train_step,
)
from biom3_tpu_torch.training.stage3_task import (
    make_sharded_stage3_train_step,
    make_stage3_train_step,
)
from biom3_tpu_torch.training.state import TrainState

SCRIBE = JProteoScribe(num_classes=29, dim=32, depth=2, n_blocks=1, heads=4, local_heads=2,
                       local_window=16, max_seq_len=64, num_timesteps=64, cond_dim=16)
PENCL = JPenCL(esm=JESM2(num_layers=1, embed_dim=16, attention_heads=2),
               bert=JBert(num_layers=1, hidden_size=16, num_heads=2, intermediate_size=32,
                          vocab_size=40, max_position_embeddings=16, hidden_dropout=0.0,
                          attn_probs_dropout=0.0),
               protein_embedding=16, text_embedding=16, proj_dim=8, dropout=0.0)
MESHES = [(2, 2, 2), (1, 4, 2), (1, 8, 1)]


def _codes(shape, spec, sizes) -> np.ndarray:
    """Each element's fsdp shard index + 1, plus 10 x its tp shard index + 1
    (0 where the axis does not shard the parameter)."""
    codes = np.zeros(shape, np.int64)
    grid = np.indices(shape)
    for dim, axis in enumerate(spec):
        if axis is not None:
            codes += (grid[dim] // (shape[dim] // sizes[axis]) + 1) * {"fsdp": 1, "tp": 10}[axis]
    return codes


def _jax_codes(params, mesh) -> dict:
    shardings = jax_params_shardings(params, mesh)
    return jax.tree_util.tree_map(lambda p, s: _codes(p.shape, tuple(s.spec), mesh.shape),
                                  params, shardings)


@pytest.mark.parametrize("shape", MESHES)
def test_param_partition_spec_equals_jax(shape):
    """Every parameter's placement, element by element, as JAX places the
    same parameter (transposed Linear weights, reshaped axial tables)."""
    jmesh = jax_make_mesh(JMeshConfig(*shape))
    sizes = dict(zip(AXES, shape))
    cfg = MeshConfig(*shape)
    scribe = jax.eval_shape(lambda: JaxProteoScribe(SCRIBE).init(
        jax.random.key(0), jnp.zeros((1, 64), jnp.int32), jnp.zeros((1,), jnp.int32),
        jnp.zeros((1, 16))))
    pencl = jax.eval_shape(lambda: JaxPenCL(PENCL).init(
        jax.random.key(0), jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 8), jnp.int32),
        method=JaxPenCL.init_all_params))
    cases = [(ProteoScribe(port_config(SCRIBE)),
              proteoscribe_params_to_torch(_jax_codes(scribe, jmesh), SCRIBE)),
             (PenCL(port_config(PENCL), mlm_heads=True),
              pencl_params_to_torch(_jax_codes(pencl, jmesh), PENCL))]
    sharded = 0
    for model, want in cases:
        specs = params_shardings(model, cfg)
        assert set(specs) == set(want) - {"protein_encoder.model.lm_head.weight"}
        for name, p in model.named_parameters():
            spec = param_partition_spec(name, tuple(p.shape), cfg)
            assert specs[name] == spec
            np.testing.assert_array_equal(_codes(tuple(p.shape), spec, sizes),
                                          np.asarray(want[name]).reshape(p.shape), err_msg=name)
            sharded += bool(spec)
    assert sharded > 10


def test_param_partition_rules_on_port_names():
    """JAX's rules (``tests/test_parallel_training.py``) on the port's
    names: a torch weight is (out, in)."""
    mesh = MeshConfig(dp=2, fsdp=2, tp=2)
    layer = "transformer.transformer_blocks.0.0.layers.layers.0"
    assert param_partition_spec(f"{layer}.0.fn.to_q.weight", (32, 32), mesh) == ("tp", "fsdp")
    assert param_partition_spec(f"{layer}.0.fn.to_out.weight", (32, 32), mesh) == ("fsdp", "tp")
    assert param_partition_spec(f"{layer}.1.fn.fn.w2.weight", (32, 128), mesh) == ("fsdp", "tp")
    assert param_partition_spec("transformer.x_emb_NN.weight", (30, 32), mesh) == ("fsdp", None)
    assert param_partition_spec("transformer.out.weight", (29, 32), mesh) == (None, "tp")
    assert param_partition_spec("transformer.out.bias", (29,), mesh) == ()
    assert param_partition_spec("transformer.axial_pos_emb.weights_0", (1, 4, 1, 32),
                                mesh) == (None, "fsdp", None, "tp")


class _Position:
    """The ``DeviceMesh`` surface ``batch_sharding`` reads, at one mesh
    coordinate."""

    mesh_dim_names, device_type = AXES, "cpu"

    def __init__(self, shape, coord):
        self.shape, self.coord = shape, coord

    def get_local_rank(self, name):
        return self.coord[AXES.index(name)]


@pytest.mark.parametrize("shape", MESHES)
def test_put_global_is_jax_batch_shard(shape):
    """Each mesh position's rows equal the data of JAX's ``P(("dp",
    "fsdp"))`` shard on the device at that position."""
    jmesh = jax_make_mesh(JMeshConfig(*shape))
    x = np.arange(16 * 3, dtype=np.float32).reshape(16, 3)
    placed = jax.device_put(x, jax_batch_sharding(jmesh, 2))
    shards = {s.device: np.asarray(s.data) for s in placed.addressable_shards}
    for coord in np.ndindex(*shape):
        position = _Position(shape, coord)
        rows = batch_sharding(position, 16)
        got = put_global(torch.from_numpy(x), position)
        np.testing.assert_array_equal(got.numpy(), shards[jmesh.devices[coord]])
        np.testing.assert_array_equal(got.numpy(), x[rows])
    with pytest.raises(ValueError, match="not divisible"):
        batch_sharding(_Position(shape, (0, 0, 0)), 6 if shape[0] * shape[1] > 2 else 3)


@pytest.mark.parametrize("heads,local,size,want", [
    (4, 2, 2, [(2, 2), (2, 0)]),            # band-only and linear-only ranks
    (4, 1, 2, [(2, 1), (2, 0)]),            # a mixed rank
    (16, 8, 4, [(4, 4), (4, 4), (4, 0), (4, 0)]),
    (20, 0, 2, [(10, 0), (10, 0)]),         # ESM2-650M
    (16, 16, 2, [(8, 8), (8, 8)]),
])
def test_tensor_parallel_heads(heads, local, size, want):
    """Rank r runs the contiguous heads [r·H/tp, (r+1)·H/tp), of which the
    first ``local_heads`` of the layer are band-local (JAX's contiguous tp
    shard of ``to_q``'s output dim)."""
    got = [TensorParallel(None, r, size).heads(heads, local) for r in range(size)]
    assert got == want
    assert [TensorParallel(None, r, size).block(heads * 32) for r in range(size)] == [
        slice(r * heads * 32 // size, (r + 1) * heads * 32 // size) for r in range(size)]
    with pytest.raises(ValueError, match="do not split"):
        TensorParallel(None, 0, 3).heads(heads, local)


def test_initialize_distributed_needs_a_card_unless_told_cpu():
    if torch.cuda.is_available():
        pytest.skip("a card is present: NCCL would start")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        initialize_distributed("tcp://localhost:1", 1, 0)
    with pytest.raises(ValueError, match="num_processes"):
        initialize_distributed("tcp://localhost:1", device="cpu")
    assert not dist.is_initialized()


@pytest.fixture(scope="module")
def one_rank():
    """A one-rank gloo group in this process and its (1, 1, 1) mesh."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    device = initialize_distributed(f"tcp://localhost:{port}", 1, 0, device="cpu")
    try:
        yield device, make_hybrid_mesh(MeshConfig())
    finally:
        dist.destroy_process_group()


def test_hybrid_mesh_on_one_rank(one_rank):
    device, mesh = one_rank
    assert device == torch.device("cpu") and dist.get_backend() == "gloo"
    assert mesh.mesh_dim_names == AXES and tuple(mesh.shape) == (1, 1, 1)
    with pytest.raises(ValueError, match="needs 2 ranks, the group has 1"):
        make_hybrid_mesh(MeshConfig(dp=2))
    with pytest.raises(ValueError, match="would span hosts"):
        make_hybrid_mesh(MeshConfig(fsdp=2), ranks_per_host=3)


def _scribe(seed=0):
    model = ProteoScribe(port_config(SCRIBE), attn_impl="layer-block")
    return seeded_init_(model, seed)


def _batch3(n=4):
    g = torch.Generator().manual_seed(5)
    tokens = torch.randint(1, 23, (n, 64), generator=g)
    return {"tokens": tokens, "z_c": torch.randn((n, 16), generator=g)}


@pytest.mark.parametrize("optimizer,accum", [("AdamW", 2), ("Adafactor", 1)])
def test_one_rank_stage3_step_is_the_one_device_step(one_rank, optimizer, accum):
    """World size 1: the sharded step (FSDP2, draws from the generator)
    gives the one-device step's aux, parameters and EMA bit for bit; its
    state dict holds plain full tensors."""
    _, mesh = one_rank
    def make_tx(model):
        return make_optimizer(optimizer, model.parameters(), 1e-3, weight_decay=0.01)

    step, state = make_sharded_stage3_train_step(_scribe(), make_tx, mesh, accum_steps=accum)
    model = _scribe()
    ref = TrainState(model, make_tx(model), with_ema=True)
    ref_step = make_stage3_train_step(ref, accum_steps=accum)
    for i in range(2):
        aux = step(_batch3(), torch.Generator().manual_seed(i))
        want = ref_step(_batch3(), torch.Generator().manual_seed(i))
        assert {k: float(v) for k, v in aux.items()} == {k: float(v) for k, v in want.items()}
    got, ref_sd = state.state_dict(), ref.state_dict()
    for k, v in ref_sd["params"].items():
        assert type(got["params"][k]) is torch.Tensor and torch.equal(got["params"][k], v), k
    for e, v in zip(got["ema"], ref_sd["ema"]):
        assert torch.equal(e, v)
    state.load_state_dict(ref_sd)   # a whole state into the shards
    for k, v in state.state_dict()["params"].items():
        assert torch.equal(v, ref_sd["params"][k]), k


def test_one_rank_stage1_step_is_the_one_device_step(one_rank):
    _, mesh = one_rank
    cfg = port_config(PENCL)
    opt = Config({"protein_encoder_lr": 1e-3, "text_encoder_lr": 1e-3, "head_lr": 1e-3})

    def pencl():
        return seeded_init_(PenCL(cfg, attn_impl="layer-block", mlm_heads=True), 1)

    rng = np.random.default_rng(2)
    batch = {}
    for prefix in ("", "pfam_"):
        for name, vocab, mask in (("text", 40, 4), ("protein", 30, 32)):
            toks = torch.from_numpy(rng.integers(4, vocab, (4, 12)))
            masked = toks.clone()
            masked[:, 3] = mask
            batch[f"{prefix}{name}_tokens"], batch[f"{prefix}{name}_tokens_masked"] = toks, masked
    kw = dict(temperature=0.8, dataset_type="pfam", text_mask_id=4, protein_mask_id=32)
    step, state = make_sharded_stage1_train_step(
        pencl(), lambda m: make_stage1_optimizer(opt, m), mesh, **kw)
    model = pencl()
    ref_step = make_stage1_train_step(TrainState(model, make_stage1_optimizer(opt, model)), **kw)
    aux, want = step(batch), ref_step(batch)
    assert {k: float(v) for k, v in aux.items()} == {k: float(v) for k, v in want.items()}
    for k, v in model.state_dict().items():
        assert torch.equal(state.state_dict()["params"][k], v), k


@pytest.mark.parametrize("optimizer", ["AdamW", "Adafactor", "AdamWMoments"])
def test_one_rank_resume_equals_unbroken_run(one_rank, tmp_path, optimizer):
    """A sharded state (FSDP2 ``DTensor`` parameters, moments — Adafactor's
    factored rows and columns, a bf16 first moment — and EMA) saved by
    ``CheckpointManager`` after a step, restored into a fresh sharded state
    and stepped once equals two unbroken steps bit for bit."""
    _, mesh = one_rank
    assert data_group(mesh) is None   # tp = 1: the world group

    def make_tx(model):
        if optimizer == "AdamWMoments":
            return Optimizer(AdamWMoments(model.parameters(), lr=1e-3, weight_decay=0.01),
                             None, None)
        return make_optimizer(optimizer, model.parameters(), 1e-3, weight_decay=0.01)

    def build():
        return make_sharded_stage3_train_step(_scribe(), make_tx, mesh)

    ckpt = CheckpointManager(tmp_path)
    step, state = build()
    step(_batch3(), torch.Generator().manual_seed(0))
    ckpt.save(1, state)
    step(_batch3(), torch.Generator().manual_seed(1))
    want = state.state_dict()
    step, state = build()
    ckpt.restore(state)
    step(_batch3(), torch.Generator().manual_seed(1))
    got = state.state_dict()
    assert got["step"] == want["step"] == 2
    for k, v in want["params"].items():
        assert torch.equal(got["params"][k], v), k
    for e, v in zip(got["ema"], want["ema"]):
        assert torch.equal(e, v)
    for i, moments in want["opt"]["opt"]["state"].items():
        for k, v in moments.items():
            got_v = got["opt"]["opt"]["state"][i][k]
            if isinstance(v, torch.Tensor):
                assert got_v.dtype == v.dtype and torch.equal(got_v, v), (i, k)
            else:
                assert got_v == v, (i, k)

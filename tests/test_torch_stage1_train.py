"""biom3_tpu_torch Stage-1 (PenCL) training vs the JAX package, on the CPU in f32.

The port runs its kernels' plain versions here.  The ESM2 layer block is
held against the JAX package's Pallas kernels in interpret mode
(``esm2_block_tpu``) at ``tests/test_esm2_block.py``'s tolerances; the
whole Stage-1 loss and its gradients against the Flax graph (XLA) with
dropout off.  Inputs come from numpy with a seed and go to both sides; f32
on both sides, other summation orders.
"""

import functools
import pathlib
import re
import subprocess
import sys

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pandas as pd
import pytest
import torch

from biom3_tpu.config import BertConfig, Config as JaxConfig, ESM2Config, PenCLConfig
from biom3_tpu.data.stage1_data import (
    TextSeqPairingDataset as JaxDataset,
    mask_tokens as jax_mask_tokens,
)
from biom3_tpu.io.export import pencl_params_to_torch
from biom3_tpu.models.esm2 import ESM2 as JaxESM2
from biom3_tpu.models.pencl import PenCL as JaxPenCL
from biom3_tpu.ops.pallas.esm2_block_tpu import NEG_INF, esm2_layer_block as jax_layer_block
from biom3_tpu.tokenizers.synthetic import write_synthetic_wordpiece
from biom3_tpu.training import metrics as jax_metrics
from biom3_tpu.training.stage1_task import (
    make_stage1_optimizer as jax_make_stage1_optimizer,
    stage1_loss_fn as jax_stage1_loss_fn,
)
from biom3_tpu_torch.cli.measure_stage1 import (
    LATENT_SCALE,
    PROTEIN_MASK_ID,
    TEXT_MASK_ID,
    seeded_stage1,
    stage1_batch,
)
from biom3_tpu_torch.config import Config
from biom3_tpu_torch.data.stage1_data import TextSeqPairingDataset, mask_tokens, read_csv
from biom3_tpu_torch.io.from_jax import esm2_params_to_torch, pencl_train_from_jax, port_config
from biom3_tpu_torch.io.state_dict import seeded_init_, to_tensors
from biom3_tpu_torch.models.esm2 import ESM2, esm2_train_state_dict
from biom3_tpu_torch.models.pencl import PenCL
from biom3_tpu_torch.ops import kernels as K
from biom3_tpu_torch.ops.esm2_block import esm2_layer_block
from biom3_tpu_torch.ops.rotary import rotary_cos_sin
from biom3_tpu_torch.training.metrics import contrastive_metrics
from biom3_tpu_torch.training.stage1_task import make_stage1_optimizer, stage1_loss_fn

ESM = ESM2Config(num_layers=2, embed_dim=128, attention_heads=4)
CFG = PenCLConfig(
    esm=ESM,
    bert=BertConfig(num_layers=2, hidden_size=64, num_heads=2, intermediate_size=128,
                    vocab_size=69, max_position_embeddings=64),
    protein_embedding=128, text_embedding=64, proj_dim=32, temperature=0.8)
TEXT_MASK, PROTEIN_MASK = 4, 32


def _np(rng, *shape, scale=1.0):
    return (rng.standard_normal(shape) * scale).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _grad_close(got, want, name, rtol=3e-3):
    """Gradient tolerance of tests/test_layer_block.py: atol 5e-4·max|g|."""
    scale = max(1e-3, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, atol=5e-4 * scale, rtol=rtol, err_msg=name)


def _protein_tokens(rng, lengths, L):
    """<cls>, residues, <eos>, then PAD to L (a length of 0: an all-PAD row)."""
    toks = np.full((len(lengths), L), ESM.pad_idx, np.int32)
    for b, n in enumerate(lengths):
        if n:
            toks[b, 0], toks[b, 1:n - 1], toks[b, n - 1] = 0, rng.integers(4, 24, n - 2), 2
    return toks


# --- the ESM2 layer block against the TPU kernels (interpret mode) -----------

def test_esm2_layer_block_matches_jax_kernels():
    """Forward rtol/atol 2e-4, the input gradient and every weight gradient
    rtol 5e-4, atol 5e-4·max|g| (tests/test_esm2_block.py): a full row, a
    ragged PAD row and an all-PAD row."""
    rng = np.random.default_rng(0)
    B, L, E, F = 3, 64, 128, 512
    x = _np(rng, B, L, E)
    pad = np.zeros((B, L), bool)
    pad[1, 41:] = True
    pad[2] = True
    args = ([_np(rng, 3, E, E, scale=E ** -0.5), _np(rng, 3, E, scale=0.1),
             _np(rng, E, E, scale=E ** -0.5), _np(rng, E, scale=0.1),
             1 + _np(rng, E, scale=0.1), _np(rng, E, scale=0.1),
             1 + _np(rng, E, scale=0.1), _np(rng, E, scale=0.1),
             _np(rng, E, F, scale=E ** -0.5), _np(rng, F, scale=0.1),
             _np(rng, F, E, scale=F ** -0.5), _np(rng, E, scale=0.1)])
    cot = _np(rng, B, L, E)

    def jax_loss(x, *w):
        out = jax_layer_block(x, jnp.asarray(pad * NEG_INF, jnp.float32), *w, heads=4,
                              ff_block_l=32, interpret=True)
        return jnp.sum(out * cot), out

    (_, want_out), want_g = jax.value_and_grad(jax_loss, argnums=tuple(range(13)), has_aux=True)(
        jnp.asarray(x), *map(jnp.asarray, args))
    ts = [_t(a, grad=True) for a in [x] + args]
    out = esm2_layer_block(ts[0], torch.from_numpy(pad), *ts[1:], heads=4)
    (out * _t(cot)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want_out), rtol=2e-4, atol=2e-4)
    names = ["x", "w3", "b3", "wo", "bo", "ls1", "lb1", "ls2", "lb2", "w1", "b1", "w2", "b2"]
    for name, t, g in zip(names, ts, want_g):
        _grad_close(t.grad.numpy(), np.asarray(g), name, rtol=5e-4)


def test_esm2_tower_layer_block_matches_jax_kernels():
    """The tower in ``layer-block`` mode against the JAX tower on its
    interpret-mode kernels, from tokens with a ragged PAD row, a <mask> and
    an all-PAD row: hidden states rtol/atol 2e-4, every parameter gradient
    (the embedding's is the layers' input gradient) rtol 5e-4, atol
    5e-4·max|g|."""
    rng = np.random.default_rng(1)
    L, esm = 64, ESM2Config(num_layers=1, embed_dim=128, attention_heads=4)
    toks = _protein_tokens(rng, [L, 40, 0], L)
    toks[0, 7] = esm.mask_idx
    probe = _np(rng, 3, L, esm.embed_dim)
    jax_model = JaxESM2(esm, attn_impl="layer-block-interpret")
    params = JaxESM2(esm).init(jax.random.key(0), jnp.asarray(toks))

    def jax_loss(p):
        h = jax_model.apply(p, jnp.asarray(toks))["hidden"]
        return jnp.sum(h * probe), h

    (_, want_h), want_g = jax.value_and_grad(jax_loss, has_aux=True)(params)
    port = ESM2(esm, attn_impl="layer-block")
    port.load_state_dict(esm2_train_state_dict(to_tensors(esm2_params_to_torch(params, esm))))
    h = port(torch.from_numpy(toks))["hidden"]
    (h * _t(probe)).sum().backward()
    np.testing.assert_allclose(h.detach().numpy(), np.asarray(want_h), rtol=2e-4, atol=2e-4)
    want = esm2_params_to_torch(jax.tree_util.tree_map(np.asarray, want_g), esm)
    for name, p in port.named_parameters():
        _grad_close(p.grad.numpy(), np.asarray(want[name]).reshape(p.shape), name, rtol=5e-4)


# --- each new plain backward against autograd of its plain forward -----------

PLAIN_TOL = dict(atol=1e-5, rtol=1e-4)  # f32 both sides, other orders


@pytest.mark.parametrize("dh,L", [pytest.param(32, 48, id="32"), pytest.param(64, 48, id="64"),
                                  pytest.param(32, 130, id="32-L130"),
                                  pytest.param(64, 130, id="64-L130")])
def test_esm2_attention_bwd_plain_is_the_gradient(dh, L):
    """With a ragged PAD row and an all-PAD row (its gradient reaches every
    key and query, as the TPU kernel's), also at a length off the kernel's
    64-row tiles (L=130: its keys >= L are excluded, not PAD)."""
    rng = np.random.default_rng(dh if L == 48 else (dh, L))
    B, H = 3, 2
    E = H * dh
    qkv, da = _t(_np(rng, B, L, 3 * E), grad=True), _t(_np(rng, B, L, E))
    pad = torch.zeros(B, L, dtype=torch.int32)
    pad[1, 29:] = 1
    pad[2] = 1
    cos, sin = rotary_cos_sin(L, dh)
    want, = torch.autograd.grad(K.esm2_attention_plain(qkv, pad, cos, sin, heads=H), qkv, da)
    got = K.esm2_attention_bwd(qkv.detach(), da, pad, cos, sin, heads=H)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **PLAIN_TOL)
    assert float(got[2].abs().min(dim=0).values.max()) > 0   # the all-PAD row's dq, dk, dv


def test_layernorm_bwd_plain_at_esm_width_is_the_gradient():
    rng = np.random.default_rng(4)
    d = 1280
    x, s, b = (_t(a, grad=True) for a in (_np(rng, 19, d, scale=2.0), 1 + _np(rng, d, scale=0.1),
                                          _np(rng, d)))
    dy, res = _t(_np(rng, 19, d)), _t(_np(rng, 19, d))
    want = torch.autograd.grad(K.layernorm_plain(x, s, b, eps=1e-5, out_dtype=torch.float32),
                               (x, s, b), dy)
    dx, ds, db = K.layernorm_bwd(x.detach(), dy, s.detach(), residual=res, eps=1e-5,
                                 out_dtype=torch.float32)
    np.testing.assert_allclose((dx - res).numpy(), want[0].numpy(), **PLAIN_TOL)
    np.testing.assert_allclose(ds.numpy(), want[1].numpy(), **PLAIN_TOL)
    np.testing.assert_allclose(db.numpy(), want[2].numpy(), **PLAIN_TOL)


# --- the PenCL training module, the losses and their gradients ---------------

@pytest.fixture(scope="module")
def pencl():
    """Flax PenCL at CFG with every parameter (MLM heads too), perturbed,
    and a pfam batch: ragged PAD tails, masked copies with <mask>/[MASK]."""
    rng = np.random.default_rng(0)
    model = JaxPenCL(CFG)
    init = jax.jit(functools.partial(model.init, method=JaxPenCL.init_all_params))
    params = init(jax.random.key(0), jnp.zeros((1, 8), jnp.int32), jnp.zeros((1, 8), jnp.int32))
    params = jax.tree_util.tree_map(
        lambda p: p + 0.05 * rng.standard_normal(p.shape).astype(np.float32), params)
    B, Lt, Lp = 3, 48, 64
    batch = {}
    for prefix in ("", "pfam_"):
        text = rng.integers(5, 69, (B, Lt)).astype(np.int32)
        text[:, 0], text[1, 30:] = 2, 0
        protein = _protein_tokens(rng, [Lp, 50, 21], Lp)
        batch[prefix + "text_tokens"], batch[prefix + "protein_tokens"] = text, protein
        batch[prefix + "text_tokens_masked"] = jax_mask_tokens(
            text, TEXT_MASK, (0, 1, 2, 3, 4), mask_prob=0.3, rng=rng)
        batch[prefix + "protein_tokens_masked"] = jax_mask_tokens(
            protein, PROTEIN_MASK, (0, 1, 2), mask_prob=0.3, rng=rng)
    return model, params, batch


TERMS = ("loss_align", "loss_intra", "loss_text_mask", "loss_seq_mask")
# the loss terms each dataset type sums (jax stage1_loss_fn, :88-124)
SUMMED = {"default": (1, 0, 0, 0), "masked": (1, 0, 1, 1), "pfam": (1, 1, 1, 1),
          "pfam_ablated": (1, 0, 1, 1)}


@pytest.fixture(scope="module")
def jax_terms(pencl):
    """The four loss terms of the JAX ``stage1_loss_fn`` (Flax graph,
    dropout off) on the fixture's batch and their VJP, so that each dataset
    type's gradient is one backward pass of its sum of terms; and the loss
    that ``stage1_loss_fn`` returns for each dataset type.  One jitted
    graph."""
    model, params, batch = pencl
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}

    def terms(p):
        losses = {}
        for dataset_type in SUMMED:
            losses[dataset_type], aux = jax_stage1_loss_fn(
                model.apply, p, jbatch, temperature=CFG.temperature, dataset_type=dataset_type,
                text_mask_id=TEXT_MASK, protein_mask_id=PROTEIN_MASK)
        return jnp.stack([aux[k] for k in TERMS]), losses

    values, vjp, losses = jax.vjp(jax.jit(terms), params, has_aux=True)
    return np.asarray(values), jax.jit(vjp), {k: float(v) for k, v in losses.items()}


@pytest.mark.parametrize("dataset_type", ["default", "masked", "pfam", "pfam_ablated"])
def test_stage1_loss_and_gradients_match_jax(pencl, jax_terms, dataset_type):
    """Against the JAX ``stage1_loss_fn`` over the Flax graph with dropout
    off, the port's torch-op graph and its ``layer-block`` mode (the ESM2
    layers on the kernels' plain versions): every loss term rtol 1e-4,
    every parameter gradient atol 5e-4·max|g| rtol 3e-3."""
    _, params, batch = pencl
    values, vjp, losses = jax_terms
    kw = dict(temperature=CFG.temperature, dataset_type=dataset_type, text_mask_id=TEXT_MASK,
              protein_mask_id=PROTEIN_MASK)
    want_loss = losses[dataset_type]
    weights = np.asarray(SUMMED[dataset_type], np.float32)
    np.testing.assert_allclose(want_loss, float(weights @ values), rtol=1e-6)
    want_g, = vjp(jnp.asarray(weights))
    want = pencl_params_to_torch(jax.tree_util.tree_map(np.asarray, want_g), CFG)
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    for impl in ("plain", "layer-block"):
        port = pencl_train_from_jax(params, port_config(CFG), attn_impl=impl)
        loss, aux = stage1_loss_fn(port, tbatch, **kw)
        loss.backward()
        np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=1e-4)
        present = [k for k in TERMS if k in aux]
        assert present == [k for k, w in zip(TERMS, (1, dataset_type.startswith("pfam"), 1, 1))
                           if w and (k == "loss_align" or dataset_type != "default")]
        for k in present:
            np.testing.assert_allclose(float(aux[k].detach()), values[TERMS.index(k)],
                                       rtol=1e-4, err_msg=f"{impl} {k}")
        got = {n: p.grad for n, p in port.named_parameters()}
        assert set(got) == set(want) - {"protein_encoder.model.lm_head.weight"}
        for name, g in got.items():
            if g is None:   # a head whose loss term this dataset type leaves out
                assert not np.asarray(want[name]).any(), name
                continue
            _grad_close(g.numpy(), np.asarray(want[name]).reshape(g.shape), f"{impl} {name}")


def test_stage1_loss_rejects_unknown_dataset_type(pencl):
    model, params, batch = pencl
    port = pencl_train_from_jax(params, port_config(CFG))
    with pytest.raises(ValueError, match="dataset_type"):
        stage1_loss_fn(port, {k: torch.from_numpy(v) for k, v in batch.items()},
                       temperature=0.8, dataset_type="other", text_mask_id=TEXT_MASK,
                       protein_mask_id=PROTEIN_MASK)


def test_mlm_logits_of_both_towers_match_flax(pencl):
    """atol 2e-4, rtol 1e-3 (tests/test_torch_pencl.py's tolerance)."""
    model, params, batch = pencl
    x_t, x_p = batch["text_tokens_masked"], batch["protein_tokens_masked"]
    want = model.apply(params, jnp.asarray(x_t), jnp.asarray(x_p), compute_masked_logits=True)
    port = pencl_train_from_jax(params, port_config(CFG))
    with torch.no_grad():
        got = port(torch.from_numpy(x_t), torch.from_numpy(x_p), compute_masked_logits=True)
    for key in ("text_masked_logits", "protein_masked_logits"):
        assert got[key].dtype == torch.float32
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=2e-4, rtol=1e-3)


def test_train_mode_dropout(pencl):
    """Eval mode: the latents equal Flax's deterministic forward (atol
    2e-4, rtol 1e-3).  Train mode: they differ, and every dropout site (4
    in BERT's embeddings and layers, 1 per projection head) zeroes its
    stated rate of elements (0.1 ± 0.02 over the call) and scales the rest
    by 1/(1 − p)."""
    model, params, batch = pencl
    x_t, x_p = batch["text_tokens"], batch["protein_tokens"]
    want = model.apply(params, jnp.asarray(x_t), jnp.asarray(x_p))
    port = pencl_train_from_jax(params, port_config(CFG))
    tt, tp = torch.from_numpy(x_t), torch.from_numpy(x_p)
    with torch.no_grad():
        ev = port(tt, tp)
    for key in ("text_joint_latent", "seq_joint_latent"):
        np.testing.assert_allclose(ev[key].numpy(), np.asarray(want[key]), atol=2e-4, rtol=1e-3)
    seen = []

    def hook(mod, inp, out):
        x, y = inp[0], out
        dropped = (y == 0) & (x != 0)
        kept = ~dropped & (x != 0)
        torch.testing.assert_close(y[kept], x[kept] / (1 - mod.p))
        seen.append((int(dropped.sum()), int((x != 0).sum()), mod.p))

    sites = [m for m in port.modules() if isinstance(m, torch.nn.Dropout)]
    assert len(sites) == 1 + 3 * CFG.bert.num_layers + 2
    handles = [m.register_forward_hook(hook) for m in sites]
    torch.manual_seed(0)
    port.train()
    with torch.no_grad():
        tr = port(tt, tp)
    for h in handles:
        h.remove()
    assert len(seen) == len(sites)
    assert {p for *_, p in seen} == {0.1}
    rate = sum(d for d, *_ in seen) / sum(n for _, n, _ in seen)
    assert abs(rate - 0.1) < 0.02, rate
    assert not torch.allclose(tr["text_joint_latent"], ev["text_joint_latent"])


def test_contrastive_metrics_match_jax():
    rng = np.random.default_rng(5)
    logits = _np(rng, 8, 8, scale=3.0)
    logits[np.arange(8), np.arange(8)] += 2.0
    want = jax_metrics.contrastive_metrics(jnp.asarray(logits))
    got = contrastive_metrics(torch.from_numpy(logits))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=1e-6, err_msg=k)


def test_grouped_adamw_matches_optax_multi_transform(pencl):
    """Two steps of the per-tower AdamW (three rates, weight decay) on the
    same gradients as optax's ``multi_transform``: atol 1e-6."""
    model, params, _ = pencl
    cfg = {"protein_encoder_lr": 1e-3, "text_encoder_lr": 3e-3, "head_lr": 2e-2,
           "weight_decay": 0.05}
    tx = jax_make_stage1_optimizer(JaxConfig(cfg))
    rng = np.random.default_rng(6)
    grads = [jax.tree_util.tree_map(lambda p: _np(rng, *p.shape), params) for _ in range(2)]
    p, st = params, tx.init(params)
    update = jax.jit(tx.update)
    for g in grads:
        upd, st = update(g, st, p)
        p = optax.apply_updates(p, upd)
    port = pencl_train_from_jax(params, port_config(CFG))
    opt = make_stage1_optimizer(Config(cfg), port)
    assert [grp["name"] for grp in opt.opt.param_groups] == ["text", "heads", "protein"]
    assert [grp["lr"] for grp in opt.opt.param_groups] == [3e-3, 2e-2, 1e-3]
    named = dict(port.named_parameters())
    for g in grads:
        for k, v in pencl_params_to_torch(jax.tree_util.tree_map(np.asarray, g), CFG).items():
            if k in named:
                named[k].grad = torch.from_numpy(np.array(v)).reshape(named[k].shape)
        opt.step()
    want = pencl_params_to_torch(jax.tree_util.tree_map(np.asarray, p), CFG)
    for k, v in named.items():
        np.testing.assert_allclose(v.detach().numpy(), np.asarray(want[k]).reshape(v.shape),
                                   atol=1e-6, err_msg=k)


@pytest.mark.parametrize("opt_cfg,match", [({"optimizer": "adafactor"}, "Adafactor"),
                                           ({"moment_dtype": "bfloat16"}, "moment_dtype")])
def test_stage1_optimizer_refuses_what_is_not_ported(opt_cfg, match):
    """Both options are ported now: each builds its optimizer (its repr
    names it) and takes a step; only their combination is refused, with the
    JAX task's message (``tests/test_torch_optim.py`` holds both against
    optax)."""
    model = torch.nn.Linear(2, 2)
    tx = make_stage1_optimizer(Config(opt_cfg), model)
    assert re.search(match, repr(tx.opt)), repr(tx.opt)
    model(torch.ones(1, 2)).sum().backward()
    tx.step()
    with pytest.raises(ValueError, match="moment_dtype applies to adamw only"):
        make_stage1_optimizer(Config({"optimizer": "adafactor", "moment_dtype": "bfloat16"}),
                              model)


# --- data -----------------------------------------------------------------

def test_mask_tokens_equals_jax():
    rng_data = np.random.default_rng(7)
    toks = rng_data.integers(0, 33, (5, 40)).astype(np.int32)
    for random_ids in (None, np.arange(4, 24)):
        want = jax_mask_tokens(toks, 32, (0, 1, 2), random_ids=random_ids,
                               rng=np.random.default_rng(3))
        got = mask_tokens(toks, 32, (0, 1, 2), random_ids=random_ids,
                          rng=np.random.default_rng(3))
        np.testing.assert_array_equal(got, want)


def test_dataset_batches_equal_jax(tmp_path):
    """One CSV, one seed: the ≤ 1022-residue filter and every batch array,
    masks included, bit-equal to the JAX dataset's (pandas there, the csv
    module here)."""
    rng = np.random.default_rng(8)
    write_synthetic_wordpiece(tmp_path / "tok")
    words = ["protein", "kinase", "binding", "of", "the", "membrane", "transport"]
    rows = [(f"P{i:05d}", "".join(rng.choice(list("ACDEFGHIKLMNPQRSTVWY"),
                                            1030 if i == 2 else int(rng.integers(5, 80)))),
             " ".join(rng.choice(words, int(rng.integers(3, 12))))) for i in range(9)]
    pd.DataFrame(rows, columns=["primary_Accession", "protein_sequence", "[final]text_caption"]
                 ).to_csv(tmp_path / "sp.csv", index=False)
    args = {"data_path": str(tmp_path / "sp.csv"), "text_model_path": str(tmp_path / "tok"),
            "text_max_length": 64}
    mine = TextSeqPairingDataset(Config(args), TextSeqPairingDataset.load_swissprot_csv(
        Config(args)))
    theirs = JaxDataset(JaxConfig(args), JaxDataset.load_swissprot_csv(JaxConfig(args)))
    assert len(mine) == len(theirs) == 8
    assert read_csv(tmp_path / "sp.csv")["primary_Accession"][:2] == ["P00000", "P00001"]
    for idx in ([0, 3, 5], [7, 1]):
        got = mine.get_batch(idx, with_masks=True, rng=np.random.default_rng(9))
        want = theirs.get_batch(idx, with_masks=True, rng=np.random.default_rng(9))
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


# --- the on-card Stage-1 measurement's inputs ------------------------------

def test_measurement_batch_and_seeded_heads():
    """``stage1_batch``: every pfam key, <cls>/<eos>/PAD framing, masks only
    on residues and wordpieces, the same arrays from the same seed;
    ``seeded_stage1``: the heads' output LayerNorms at LATENT_SCALE of the
    seeded values, everything else as seeded."""
    cfg = port_config(CFG)
    batch = stage1_batch(cfg, ([60, 12], [30, 5]), np.random.default_rng(0), "cpu")
    again = stage1_batch(cfg, ([60, 12], [30, 5]), np.random.default_rng(0), "cpu")
    assert all(torch.equal(batch[k], again[k]) for k in batch)
    for prefix, counts in (("", [60, 12]), ("pfam_", [30, 5])):
        p, pm = batch[prefix + "protein_tokens"], batch[prefix + "protein_tokens_masked"]
        assert p.shape == (2, cfg.seq_max_length) and p.dtype == torch.int32
        for b, k in enumerate(counts):
            assert p[b, 0] == 0 and p[b, k + 1] == 2 and bool((p[b, k + 2:] == 1).all())
        assert bool((pm[p <= 2] == p[p <= 2]).all())
        t, tm = batch[prefix + "text_tokens"], batch[prefix + "text_tokens_masked"]
        assert t.shape == (2, cfg.text_max_length)
        assert bool((tm[t <= 4] == t[t <= 4]).all())
    assert bool((batch["protein_tokens_masked"] == PROTEIN_MASK_ID).any())
    assert bool((batch["text_tokens_masked"] == TEXT_MASK_ID).any())
    plain = seeded_init_(PenCL(cfg, mlm_heads=True), 3).state_dict()
    scaled = seeded_stage1(cfg, 3).state_dict()
    for k, v in plain.items():
        head_norm = k.split(".", 1)[0].endswith("projection") and ".layer_norm." in k
        torch.testing.assert_close(scaled[k], v * LATENT_SCALE if head_norm else v)


def test_measure_stage1_fails_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    out = tmp_path / "m.json"
    r = subprocess.run([sys.executable, "-m", "biom3_tpu_torch.cli.measure_stage1", "--out",
                        str(out)], cwd=pathlib.Path(__file__).resolve().parents[1],
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0 and "is_available() is false" in r.stderr
    assert not out.exists()

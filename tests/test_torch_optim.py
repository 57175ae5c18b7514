"""Adafactor and bf16-moment AdamW in biom3_tpu_torch against optax (CPU, f32).

``training/optim.Adafactor`` is ``optax.adafactor``'s algorithm written out
in torch, ``AdamWMoments`` ``optax.adamw(mu_dtype=bfloat16)``.  Both see
the same seeded numpy gradients as optax, step for step: parameters 2-D
above and below the factoring size (128), 1-D and 3-D, with and without
weight decay, within rtol 1e-5 (f32 elementwise; optax's rsqrt and means
round in another order).  The first moment is stored in bf16 on both
sides, so AdamW's moments compare bit for bit.  ``stage1_task`` builds
both from the config keys the JAX task reads, and a checkpoint of each
restores.
"""

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from biom3_tpu_torch.config import Config
from biom3_tpu_torch.training.optim import (
    Adafactor,
    AdamWMoments,
    describe,
    make_grouped_optimizer,
    make_optimizer,
    state_bytes,
)
from biom3_tpu_torch.training.stage1_task import make_stage1_optimizer

RTOL = 1e-5
SHAPES = {"2d_factored": (256, 160), "2d_small": (96, 40), "1d": (300,),
          "3d_factored": (3, 128, 200)}


def _run_pair(tx, make_opt, shape, steps, seed=0):
    rng = np.random.default_rng(seed)
    p0 = rng.standard_normal(shape).astype(np.float32)
    grads = [rng.standard_normal(shape).astype(np.float32) for _ in range(steps)]
    p, st = jnp.asarray(p0), None
    st = tx.init(p)
    param = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = make_opt([param])
    for g in grads:
        upd, st = tx.update(jnp.asarray(g), st, p)
        p = optax.apply_updates(p, upd)
        param.grad = torch.from_numpy(g)
        opt.step()
    return param.detach().numpy(), np.asarray(p), opt, st


@pytest.mark.parametrize("wd", [0.0, 0.05])
@pytest.mark.parametrize("shape", sorted(SHAPES))
def test_adafactor_matches_optax(shape, wd):
    """5 steps of ``make_optimizer("AdaFactor")`` against
    ``optax.adafactor(lr, weight_decay_rate=wd or None)``."""
    got, want, opt, st = _run_pair(optax.adafactor(1e-2, weight_decay_rate=wd or None),
                                   lambda ps: make_optimizer("AdaFactor", ps, 1e-2,
                                                             weight_decay=wd).opt,
                                   SHAPES[shape], 5)
    assert isinstance(opt, Adafactor)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    # the factored statistics take the shapes optax gives them
    (state,) = opt.state.values()
    fac = st[0]
    if "v" in state:
        np.testing.assert_allclose(state["v"].numpy(), np.asarray(fac.v), rtol=RTOL)
    else:
        for key in ("v_row", "v_col"):
            want_v = np.asarray(getattr(fac, key))
            assert tuple(state[key].shape) == want_v.shape, key
            np.testing.assert_allclose(state[key].numpy(), want_v, rtol=RTOL, err_msg=key)


@pytest.mark.parametrize("wd", [0.0, 0.1])
def test_adamw_bf16_moments_match_optax(wd):
    """3 steps of ``AdamWMoments`` against ``optax.adamw(mu_dtype=bf16)``:
    the parameters within rtol 1e-5, the bf16 first moments bit for bit."""
    got, want, opt, st = _run_pair(optax.adamw(1e-2, weight_decay=wd, mu_dtype=jnp.bfloat16),
                                   lambda ps: AdamWMoments(ps, lr=1e-2, weight_decay=wd),
                                   (64, 48), 3, seed=3)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=1e-7)
    (state,) = opt.state.values()
    adam = st[0]
    assert state["mu"].dtype == torch.bfloat16 and adam.mu.dtype == jnp.bfloat16
    np.testing.assert_array_equal(state["mu"].float().numpy(),
                                  np.asarray(adam.mu.astype(jnp.float32)))
    np.testing.assert_allclose(state["nu"].numpy(), np.asarray(adam.nu), rtol=RTOL)


def test_grouped_optimizers_match_optax_multi_transform():
    """``make_grouped_optimizer`` with Adafactor, and with bf16 AdamW
    moments, against optax's ``multi_transform`` of the JAX grouped
    optimizer (two labels, their own rates, decay on one)."""
    from biom3_tpu.training.optim import make_grouped_optimizer as jax_grouped

    rng = np.random.default_rng(5)
    shapes = {"tower.w": (160, 130), "heads.b": (7,)}
    p0 = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
             for _ in range(3)]
    lrs = {"tower": 3e-3, "heads": 1e-2}
    for kind, mdt in (("adafactor", None), ("adamw", "bfloat16")):
        tx = jax_grouped(lambda path: str(path[0].key).split(".")[0], lrs, weight_decay=0.05,
                         decay_groups=("tower",), optimizer=kind,
                         moment_dtype=jnp.bfloat16 if mdt else None)
        p = {k: jnp.asarray(v) for k, v in p0.items()}
        st = tx.init(p)
        params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in p0.items()}
        opt = make_grouped_optimizer(params.items(), lambda n: n.split(".")[0], lrs,
                                     weight_decay=0.05, decay_groups=("tower",),
                                     optimizer=kind, moment_dtype=mdt)
        for g in grads:
            upd, st = tx.update({k: jnp.asarray(v) for k, v in g.items()}, st, p)
            p = optax.apply_updates(p, upd)
            for k, v in g.items():
                params[k].grad = torch.from_numpy(v)
            opt.step()
        for k in shapes:
            np.testing.assert_allclose(params[k].detach().numpy(), np.asarray(p[k]), rtol=RTOL,
                                       atol=1e-7, err_msg=f"{kind} {k}")


def test_stage1_task_builds_both_and_their_checkpoints_restore(tmp_path):
    """The JAX task's config keys build the compressed optimizers; their
    state is smaller than AdamW's and a ``torch.save``d state restores
    under ``weights_only``; adafactor with a bf16 moment is refused with
    JAX's message."""
    def model():
        torch.manual_seed(0)
        return torch.nn.Sequential(torch.nn.Linear(256, 192), torch.nn.Linear(192, 4))

    sizes = {}
    for cfg, name in (({}, "AdamW"), ({"optimizer": "adafactor"}, "Adafactor"),
                      ({"moment_dtype": "bfloat16"}, "AdamW, moment_dtype bfloat16")):
        m = model()
        tx = make_stage1_optimizer(Config(cfg), m)
        assert describe(tx) == name
        m(torch.ones(2, 256)).square().sum().backward()
        tx.step()
        sizes[name] = state_bytes(tx)
        torch.save(tx.state_dict(), tmp_path / "opt.pt")
        m2 = model()
        tx2 = make_stage1_optimizer(Config(cfg), m2)
        tx2.load_state_dict(torch.load(tmp_path / "opt.pt", weights_only=True))
        for (a, b) in zip(tx.opt.state.values(), tx2.opt.state.values()):
            for k in a:
                assert torch.equal(torch.as_tensor(a[k]), torch.as_tensor(b[k])), k
    assert sizes["Adafactor"] < sizes["AdamW, moment_dtype bfloat16"] < sizes["AdamW"]
    with pytest.raises(ValueError, match="moment_dtype applies to adamw only"):
        make_stage1_optimizer(Config({"optimizer": "adafactor", "moment_dtype": "bfloat16"}),
                              model())

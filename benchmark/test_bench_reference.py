"""The plain references against the port's CPU path at tiny sizes, and the
cells' whole runs (set-up, window, check) on the CPU, where both sides are
float32 and agree to rounding."""

import time

import pytest
import torch

import tiny
from harness import cell, models, spec
from reference import pencl as ref1
from reference import proteoscribe as ref3


def _run(name, seed=2 ** 40 + 11, seconds=1.0):
    c = tiny.shrink(spec.load_cell(name))
    return cell.execute(c, seed, seconds, False, "cpu", time.perf_counter())


def test_proteoscribe_reference_matches_the_port():
    from biom3_tpu_torch.config import Config, ProteoScribeConfig
    from biom3_tpu_torch.models.proteoscribe import ProteoScribe

    sd = models.seeded_state(ref3.layout(tiny.STAGE3), 3, "cpu", torch.float32)
    model = ProteoScribe(ProteoScribeConfig.from_stage_config(Config(tiny.STAGE3)))
    model.load_state_dict(sd)
    g = torch.Generator().manual_seed(0)
    x = torch.randint(0, 29, (3, 64), generator=g)
    t, z = torch.tensor([0, 10, 63]), torch.randn(3, 32, generator=g)
    pos = torch.randint(0, 64, (3, 2), generator=g)
    with torch.no_grad():
        want = model(x, t, z, pos)
    assert torch.allclose(ref3.logits_at(sd, tiny.STAGE3, x, t, z, pos), want, atol=1e-5)


def test_pencl_and_facilitator_references_match_the_port():
    from biom3_tpu_torch.config import Config, FacilitatorConfig, PenCLConfig
    from biom3_tpu_torch.models.facilitator import Facilitator
    from biom3_tpu_torch.models.pencl import PenCL

    sd = models.seeded_state(ref1.layout(tiny.STAGE1), 4, "cpu", torch.float32)
    model = PenCL(PenCLConfig.from_stage_config(Config(tiny.STAGE1))).eval()
    model.load_state_dict(sd)
    g = torch.Generator().manual_seed(1)
    x_t = torch.randint(5, 200, (2, 64), generator=g)
    x_p = torch.cat([torch.zeros(1, 1, dtype=torch.long),
                     torch.randint(4, 24, (1, 30), generator=g),
                     torch.full((1, 1), 2)], dim=1)
    with torch.no_grad():
        assert torch.allclose(ref1.z_t(sd, tiny.STAGE1, x_t), model.encode_text(x_t), atol=1e-5)
        assert torch.allclose(ref1.z_p(sd, tiny.STAGE1, x_p), model.encode_protein(x_p),
                              atol=1e-5)
    fsd = models.seeded_state(ref1.facilitator_layout(tiny.STAGE2), 5, "cpu", torch.float32)
    fac = Facilitator(FacilitatorConfig.from_stage_config(Config(tiny.STAGE2)))
    fac.load_state_dict(fsd)
    z = torch.randn(3, 32, generator=g)
    with torch.no_grad():
        assert torch.allclose(ref1.facilitator(fsd, z), fac(z), atol=1e-5)


@pytest.mark.parametrize("name,bound", [
    ("design-exact", {"logit_err": 1e-2, "top_gap": 1e-2, "commit_err": 0}),
    ("pencl-embed", {"zt_err": 1e-5, "zp_err": 1e-5}),
    ("stage3-train", {"loss_err": 1e-5, "grad_err": 1e-4, "update_err": 1e-3,
                      "mid_loss_err": 1e-5, "mid_update_err": 1e-3, "mid_ema_err": 1e-3}),
])
def test_cell_runs_correct_on_the_cpu(name, bound):
    ctx, outcome = _run(name)
    assert all(c.ok for c in outcome.checks), outcome.checks
    for key, limit in bound.items():
        assert ctx.readings["program"][key] <= limit, (key, ctx.readings)
    assert outcome.attempted > 0 and outcome.metrics["setup_s"] > 0

"""The plain reference against the float64 test oracle (``tests/oracle.py``)
on a small fluid block, its neighbour search against brute force, and the
comparison on itself; and what it refuses to model."""
import json
import math
import os
import sys

import numpy as np
import pytest
import torch

import check
from conftest import ROOT
from reference import sph

sys.path.insert(0, os.path.join(ROOT, "tests"))
from oracle import Oracle  # noqa: E402


def physics(**over) -> sph.Physics:
    kw = dict(dim=3, radius=0.01, h=0.04, v0=0.8 * 0.02 ** 3, rho0=1000.0,
              fluid_density=1000.0, gravity=(0.0, -9.81, 0.0), dt=6e-4,
              viscosity=10.0, viscosity_b=0.3, viscosity_method="standard",
              surface_tension=0.01, domain_start=(0.0, 0.0, 0.0),
              domain_end=(0.4, 0.4, 0.4), grid_num=(10, 10, 10),
              max_error=1e-4, max_error_v=1e-3, max_iter=1000,
              max_iter_v=1000, eps=1e-5, vel_cap_cfl=0.0, cg_tol=1e-6,
              cg_max_iter=1000)
    kw.update(over)
    return sph.Physics(**kw)


def block(seed=0, n=6):
    g = torch.Generator().manual_seed(seed)
    ax = torch.arange(n, dtype=torch.float64) * 0.02 + 0.12
    pos = torch.stack(torch.meshgrid(ax, ax, ax, indexing="ij"), -1)
    pos = pos.reshape(-1, 3)
    pos = pos + (torch.rand(pos.shape, generator=g, dtype=torch.float64)
                 - 0.5) * 0.004
    vel = (torch.rand(pos.shape, generator=g, dtype=torch.float64) - 0.5)
    return pos, vel


def test_close_pairs_brute_force():
    pos, _ = block(1)
    q, p, d2 = sph.close_pairs(pos, pos, 0.04)
    dist = torch.cdist(pos, pos)
    want = (dist < 0.04) & ~torch.eye(len(pos), dtype=torch.bool)
    got = torch.zeros_like(want)
    got[q, p] = True
    assert torch.equal(got, want)
    assert torch.allclose(d2, dist[q, p] ** 2)


def test_step_matches_the_oracle():
    """One DFSPH step of a fluid block without walls: the reference against
    the oracle's brute-force float64 step."""
    ph = physics()
    pos, vel = block(2)
    mat = torch.full((len(pos),), sph.FLUID, dtype=torch.int32)
    ref = sph.step_rows(pos, vel, mat, ph)
    orc = Oracle(pos.numpy(), vel.numpy(), h=ph.h, dt=ph.dt, v0=ph.v0,
                 viscosity=ph.viscosity, surface_tension=ph.surface_tension,
                 domain=(ph.domain_start, ph.domain_end))
    _, rho, it_d, it_v = orc.step_dfsph()
    assert (ref["solver_iters"], ref["div_iters"]) == (it_d, it_v)
    np.testing.assert_allclose(ref["pos"].numpy(), orc.pos, atol=1e-12)
    np.testing.assert_allclose(ref["vel"].numpy(), orc.vel, atol=1e-9)
    np.testing.assert_allclose(ref["density"].numpy(), rho, rtol=1e-12)


def test_implicit_viscosity_solves_its_system():
    """The CG's answer x satisfies x + dt/rho0 sum_j c_ij gradW_ij R (R . (x_i
    - x_j)) = v, the system of the solve without walls, written out pair by
    pair."""
    ph = physics(viscosity=2000.0, viscosity_b=2000.0,
                 viscosity_method="implicit", dt=1e-3, cg_tol=1e-8)
    pos, vel = block(3, 5)
    mat = torch.full((len(pos),), sph.FLUID, dtype=torch.int32)
    pr = sph.Pairs(pos, mat != 0, ph)
    V = torch.full((len(pos),), ph.v0, dtype=torch.float64)
    m = ph.rho0 * V
    rho = sph.density(pr, V, mat, ph)
    x, it = sph.implicit_viscosity(pr, vel, V, m, rho, mat, ph)
    assert 0 < it < ph.cg_max_iter
    c = -2.0 * 5 * ph.viscosity * 0.5 * (m[pr.i] + m[pr.j]) / rho[pr.j] / \
        (pr.d2 + 0.01 * ph.h ** 2) * pr.gw
    outer = pr.R[:, :, None] * pr.R[:, None, :]
    dx = (x[pr.i] - x[pr.j])[:, :, None]
    lhs = x + ph.dt / ph.rho0 * pr.sum(
        (c[:, None, None] * outer @ dx)[..., 0])
    assert torch.allclose(lhs, vel, atol=1e-7)


def test_compare_of_the_reference_with_itself():
    ph = physics(vel_cap_cfl=1.0)
    pos, vel = block(4)
    mat = torch.full((len(pos),), sph.FLUID, dtype=torch.int32)
    ref = sph.step_rows(pos, vel * 0.1, mat, ph)
    nums = check.compare(check.sort_rows(ref, ph), ref, ph)
    assert nums["match_breaks"] == 0 and nums["order_breaks"] == 0
    for k in ("pos_gap", "vel_gap", "rho_gap", "alpha_gap", "volume_gap",
              "iters_gap"):
        assert nums[k] == 0, k
    shuffled = {k: (v.flip(0) if torch.is_tensor(v) and v.dim() else v)
                for k, v in check.sort_rows(ref, ph).items()}
    assert check.compare(shuffled, ref, ph)["order_breaks"] > 0


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_lower_precision_reads_its_gap(dtype):
    """The step in float32 sits near the float64 one, in bfloat16 far
    from it: the comparison tells the precisions apart."""
    ph = physics(vel_cap_cfl=1.0)
    pos, vel = block(5)
    mat = torch.full((len(pos),), sph.FLUID, dtype=torch.int32)
    ref = sph.step_rows(pos, vel * 0.1, mat, ph)
    low = sph.step_rows(pos, vel * 0.1, mat, ph, dtype=dtype)
    low = check.sort_rows({k: (v.double() if torch.is_tensor(v) and
                               v.is_floating_point() else v)
                           for k, v in low.items()}, ph)
    gap = check.compare(low, ref, ph)["rho_gap"]
    assert math.isfinite(gap)
    if dtype == torch.float32:
        assert gap < 1e-5
    else:
        assert gap > 1e-3


def _flagship() -> dict:
    with open(os.path.join(ROOT, "benchmark", "configs",
                           "flagship_dfsph.json")) as f:
        return json.load(f)


def _wcsph(cfg):
    cfg["scene"]["Configuration"]["simulationMethod"] = "wcsph"


def _rigid_body(cfg):
    cfg["scene"]["RigidBodies"] = [{"objectId": 1, "isDynamic": True}]


def _emitter(cfg):
    cfg["scene"]["Configuration"]["gravitationUpper"] = 1.0


def _late_entry(cfg):
    cfg["scene"]["FluidBlocks"][0]["entryTime"] = 0.5


def _warm_start(cfg):
    cfg["scene"]["Configuration"]["dfsphWarmStart"] = True


def _override(cfg):
    cfg["overrides"]["dfsph_warm_start"] = True


@pytest.mark.parametrize("change", [_wcsph, _rigid_body, _emitter,
                                    _late_entry, _warm_start, _override],
                         ids=lambda f: f.__name__.strip("_"))
def test_physics_of_refuses_what_it_does_not_model(change):
    """A configuration that asks for another solver, a rigid body, an
    emitter, a late entry, a warm start or an unread override is refused,
    not compared against a cold DFSPH step with static walls."""
    cfg = _flagship()
    assert sph.physics_of(cfg).dt == 6e-4
    change(cfg)
    with pytest.raises(ValueError, match="does not model"):
        sph.physics_of(cfg)

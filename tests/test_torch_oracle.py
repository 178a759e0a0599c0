"""The port against the float64 oracle of the reference's physics
(``tests/oracle.py``), on the configs and with the thresholds of
``tests/test_parity.py``, which holds the JAX package to the same oracle.

The port runs on the CPU through the plain versions of its kernels (the
cell-list engine, the scenes' ``auto``). Trajectories are compared after
nearest-neighbour matching, since the port re-sorts its rows every step;
iteration counts must track the oracle's within 2 every step. PBF
(``test_parity.py:130``): the reference's own 2D PBF configuration, its
trajectory after 20 steps and statistics after 50.
"""
import numpy as np
import pytest

import test_torch_scene  # noqa: F401  (one torch thread per test process)
from oracle import Oracle

from sph_project_tpu_torch import sim as simlib
from sph_project_tpu_torch.scene import load_scene
from sph_project_tpu_torch.utils.config import SimConfig


def build(method, dt=5e-4):
    """tests/test_parity.py's ``build``: a free block of ~400 particles
    that falls 2 mm onto the domain's floor clamp."""
    cfg = SimConfig(config={
        "Configuration": {
            "domainStart": [0, 0, 0], "domainEnd": [0.4, 0.4, 0.4],
            "addDomainBox": False, "particleRadius": 0.01, "density0": 1000,
            "gravitation": [0, -9.81, 0], "simulationMethod": method,
            "viscosityMethod": "standard", "timeStepSize": dt,
            "viscosity": 0.05},
        "FluidBlocks": [{"objectId": 0, "start": [0.06, 0.042, 0.06],
                         "end": [0.2, 0.2, 0.2], "translation": [0, 0, 0],
                         "scale": [1, 1, 1], "velocity": [0, 0, 0],
                         "density": 1000.0, "color": [50, 100, 200],
                         "entryTime": -1.0}]})
    scene, state = load_scene(config=cfg)
    sim = simlib.Simulation(scene, state, device="cpu")
    params = scene.params
    p = sim.state.particles
    act = p.material.numpy() == 1
    orc = Oracle(p.pos.numpy()[act], p.vel.numpy()[act],
                 h=params.support_radius, dt=params.dt,
                 rho0=params.density0, v0=params.v0, gravity=params.gravity,
                 viscosity=params.viscosity,
                 surface_tension=params.surface_tension,
                 domain=(params.domain_start, params.domain_end),
                 padding=params.padding,
                 kernel=params.kernel_type)
    return sim, orc


def nn_dist(sim, orc):
    p = sim.state.particles
    pe = p.pos.numpy()[p.material.numpy() == 1]
    d = np.linalg.norm(orc.pos[:, None, :] - pe[None, :, :], axis=-1)
    return d.min(axis=1)


def engine_density(sim):
    p = sim.state.particles
    return p.density.numpy()[p.material.numpy() == 1]


def test_wcsph_trajectory_matches_oracle():
    sim, orc = build("wcsph")
    for _ in range(100):
        sim.step()
        orc.step_wcsph()
    d = nn_dist(sim, orc)
    assert d.max() < 1e-5, f"trajectory drift {d.max():.2e}"
    de = engine_density(sim)
    np.testing.assert_allclose(de.mean(), orc.density.mean(), rtol=1e-4)
    np.testing.assert_allclose(de.max(), orc.density.max(), rtol=1e-3)


def _dfsph(steps):
    sim, orc = build("dfsph", dt=1e-3)
    alpha = dens = None
    for s in range(steps):
        diag = sim.step()
        alpha, dens, oi, od = orc.step_dfsph(alpha, dens)
        assert abs(int(diag["solver_iters"]) - oi) <= 2, \
            f"step {s}: density-solver iters {int(diag['solver_iters'])} vs {oi}"
        assert abs(int(diag["div_iters"]) - od) <= 2, \
            f"step {s}: divergence iters {int(diag['div_iters'])} vs {od}"
    d = nn_dist(sim, orc)
    assert d.max() < 3e-3, f"trajectory drift {d.max():.2e}"
    return sim, orc


def test_dfsph_oracle_parity_quick():
    """25 steps reach first floor contact, so the correctors do real work."""
    _dfsph(25)


@pytest.mark.parametrize("method", ["pcisph", "iisph"])
def test_pressure_loop_oracle_parity(method):
    """PCISPH and IISPH: trajectory, iteration counts every step and mean
    density after 50 steps (test_parity.py's two tests, one case each)."""
    sim, orc = build(method, dt=1e-3)
    step = orc.step_pcisph if method == "pcisph" else orc.step_iisph
    for s in range(50):
        diag = sim.step()
        oi, _ = step()
        assert abs(int(diag["solver_iters"]) - oi) <= 2, \
            f"step {s}: {method} iters {int(diag['solver_iters'])} vs {oi}"
    d = nn_dist(sim, orc)
    assert d.max() < 3e-3, f"trajectory drift {d.max():.2e}"
    np.testing.assert_allclose(engine_density(sim).mean(),
                               orc.density.mean(), rtol=2e-3)


@pytest.mark.slow
def test_dfsph_matches_oracle_with_iteration_counts():
    """40 steps through full impact (test_parity.py:196, slow there too)."""
    sim, orc = _dfsph(40)
    np.testing.assert_allclose(engine_density(sim).mean(),
                               orc.density.mean(), rtol=2e-3)


def test_pbf_oracle_parity():
    """tests/test_parity.py test_pbf_oracle_parity for the port: the
    reference's 2D PBF constants (h 1.12, spacing 0.88, dt 0.05, zero
    viscosity, s_corr on) and that test's bounds: every particle within 2e-3
    of the oracle's after 20 steps (measured 7e-4 by the JAX package's test)
    and the mean density within 2e-3; after 50, finite in both."""
    from test_torch_pbf_2d import parity_config
    scene, state = load_scene(config=SimConfig(config=parity_config()),
                              pair_block=64)
    sim = simlib.Simulation(scene, state, device="cpu")
    params = scene.params
    p = sim.state.particles
    act = p.material.numpy() == 1
    orc = Oracle(p.pos.numpy()[act], p.vel.numpy()[act],
                 h=params.support_radius, dt=params.dt,
                 rho0=params.density0, v0=params.v0, gravity=params.gravity,
                 viscosity=params.viscosity,
                 surface_tension=params.surface_tension,
                 domain=(params.domain_start, params.domain_end),
                 padding=params.padding, kernel=params.kernel_type,
                 diameter=params.particle_diameter)
    assert orc.kernel == "poly6"
    for _ in range(20):
        sim.step()
        orc.step_pbf(iters=params.pbf_iters, corr_k=params.pbf_corr_k,
                     corr_dq=params.pbf_corr_delta_q)
    d = nn_dist(sim, orc)
    assert d.max() < 2e-3, f"trajectory drift {d.max():.2e}"
    np.testing.assert_allclose(engine_density(sim).mean(),
                               orc.density.mean(), rtol=2e-3)
    for _ in range(30):
        sim.step()
        orc.step_pbf(iters=params.pbf_iters, corr_k=params.pbf_corr_k,
                     corr_dq=params.pbf_corr_delta_q)
    assert np.isfinite(sim.state.particles.pos.numpy()).all()
    assert np.isfinite(orc.pos).all()

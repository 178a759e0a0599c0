"""The port's DFSPH main path against the JAX package's, step for step.

Both packages load the same scene (bit-equal arrays, test_torch_scene.py),
prepare it and run 20 DFSPH steps on the CPU, cold or with the warm start:
the JAX ``Simulation`` through its CPU pair executor (the slab engine, run by
``pair_exec._exec_jax``), the port's ``Simulation(device="cpu")`` through the
plain versions of its kernels, under the cell-list engine or, with
``pair_backend="pallas"``, the slab-window engine. Checks, with their reasons:

- solver_iters and div_iters equal at every step: the correctors exit on a
  tolerance test, so equal counts say the two error sequences agree;
- the same diagnostics keys;
- every fluid particle of the port within 1e-5 of one of the JAX package's
  after 20 steps (nearest-neighbour match, as the re-sorts order rows
  differently): the bar tests/test_parity.py holds the JAX engine to
  against its float64 oracle.
"""
import numpy as np
import pytest

from sph_project_tpu import sim as jsim
from sph_project_tpu_torch import sim as tsim

from test_torch_scene import box_config, load_both

STEPS = 20


def parity_config():
    """tests/test_parity.py's build("dfsph", dt=1e-3) scene: a free fluid
    block that reaches the domain floor clamp within ~20 steps."""
    return {
        "Configuration": {
            "domainStart": [0, 0, 0], "domainEnd": [0.4, 0.4, 0.4],
            "addDomainBox": False, "particleRadius": 0.01, "density0": 1000,
            "gravitation": [0, -9.81, 0], "simulationMethod": "dfsph",
            "viscosityMethod": "standard", "timeStepSize": 1e-3,
            "viscosity": 0.05},
        "FluidBlocks": [{"objectId": 0, "start": [0.06, 0.042, 0.06],
                         "end": [0.2, 0.2, 0.2], "translation": [0, 0, 0],
                         "scale": [1, 1, 1], "velocity": [0, 0, 0],
                         "density": 1000.0, "color": [50, 100, 200],
                         "entryTime": -1.0}]}


def small_scene_config():
    """The configuration of ``__graft_entry__._small_scene()``: a 0.3^3 fluid
    block (3375 particles) at rest in a unit domain without walls."""
    return {
        "Configuration": {
            "domainStart": [0.0, 0.0, 0.0], "domainEnd": [1.0, 1.0, 1.0],
            "addDomainBox": False, "particleRadius": 0.01, "density0": 1000,
            "gravitation": [0.0, -9.81, 0.0], "simulationMethod": "dfsph",
            "viscosityMethod": "standard", "timeStepSize": 1e-3,
            "viscosity": 0.05},
        "FluidBlocks": [{"objectId": 0, "start": [0.1, 0.1, 0.1],
                         "end": [0.4, 0.4, 0.4], "translation": [0, 0, 0],
                         "scale": [1, 1, 1], "velocity": [0, 0, 0],
                         "density": 1000.0, "color": [50, 100, 200],
                         "entryTime": -1.0}]}


WARM = dict(dfsph_warm_start=True, dfsph_warm_start_div=True)


def fluid_pos(pos, material):
    return np.asarray(pos)[np.asarray(material) == 1].astype(np.float64)


def nn_dist(a, b):
    """For each row of ``a``, the distance to the nearest row of ``b``."""
    return np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)).min(1)


# the free blocks fall for all 20 steps (one iteration per corrector); the
# block thrown onto the domain-box floor makes the correctors iterate. The
# warm cases: the density warm start alone; both warm starts with the adaptive
# factor armed at 0.75, where the global gate closes on two of the 20 steps
# and the per-particle gate on 0-42% of the fluid, so both decide (at 1.0 the
# thrown block turns violent, and float32 summation-order noise between any
# two executors, the port's own two engines included, grows to 2e-5 within 20
# steps); and both warm starts under the slab-window engine in both packages.
@pytest.mark.parametrize("config,overrides,iterates", [
    (parity_config, {}, False),
    (box_config, {}, True),
    (box_config, dict(dfsph_warm_start=True), True),
    (box_config, dict(WARM, dfsph_warm_factor_hi=0.75), True),
    (box_config, dict(WARM, pair_backend="pallas"), True),
    (small_scene_config, {}, False),
], ids=["free_block", "domain_box", "domain_box_warm", "domain_box_warm_hi",
        "domain_box_warm_slab", "small_scene"])
def test_dfsph_steps_match_jax(config, overrides, iterates):
    js, jst, ts, tst = load_both(config(),
                                 port_kw=dict(overrides, pair_block=64),
                                 pair_block=64, pair_chunk=32, **overrides)
    jax_sim = jsim.Simulation(js, jst)
    port = tsim.Simulation(ts, tst, device="cpu")
    worked = 0
    for s in range(STEPS):
        jd = jax_sim.step()
        td = port.step()
        assert set(td) == set(jd), f"step {s}: diagnostics keys differ"
        for k in ("solver_iters", "div_iters"):
            assert int(td[k]) == int(jd[k]), \
                f"step {s}: {k} {int(td[k])} vs JAX {int(jd[k])}"
        for k in ("neighbor_overflow", "sort_overflow", "fluid_num"):
            assert int(td[k]) == int(jd[k]), f"step {s}: {k}"
        worked += int(td["solver_iters"]) + int(td["div_iters"])
    assert worked > 2 * STEPS if iterates else worked == 2 * STEPS
    jp, tp = jax_sim.state.particles, port.state.particles
    a = fluid_pos(tp.pos.numpy(), tp.material.numpy())
    b = fluid_pos(jp.pos, jp.material)
    assert a.shape == b.shape and np.isfinite(a).all()
    d = nn_dist(a, b)
    assert d.max() < 1e-5, f"trajectory drift {d.max():.2e}"

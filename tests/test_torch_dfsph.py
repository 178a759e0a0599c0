"""The port's DFSPH main path against the JAX package's, step for step.

Both packages load the same scene (bit-equal arrays, test_torch_scene.py),
prepare it and run 20 cold DFSPH steps on the CPU: the JAX ``Simulation``
through its default CPU pair executor, the port's ``Simulation(device="cpu")``
through the plain versions of its kernels. Checks, with their reasons:

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


def fluid_pos(pos, material):
    return np.asarray(pos)[np.asarray(material) == 1].astype(np.float64)


def nn_dist(a, b):
    """For each row of ``a``, the distance to the nearest row of ``b``."""
    return np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)).min(1)


# the free block falls for all 20 steps (one iteration per corrector); the
# block thrown onto the domain-box floor makes the correctors iterate
@pytest.mark.parametrize("config,iterates", [(parity_config, False),
                                             (box_config, True)],
                         ids=["free_block", "domain_box"])
def test_dfsph_steps_match_jax(config, iterates):
    js, jst, ts, tst = load_both(config(), pair_block=64, pair_chunk=32)
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

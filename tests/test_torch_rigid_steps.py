"""Coupled steps of the port against the JAX package's, step for step.

A dynamic cube of 0.06 (density 500) dropped at 1.5 m/s onto a fluid pool in
the domain box, its lowest particles within the support radius of the fluid
from the first step: two-way coupling, the wrenches, the integrator and the
walls' contact channel run every step. Both packages load it (bit-equal
arrays), prepare it and step it on the CPU: 20 DFSPH steps and 10 of WCSPH,
PCISPH and IISPH under the cell-list engine here, 5 of each method under the
slab-window engine in tests/test_torch_rigid_slab_steps.py, which also runs
tests/test_rigid.py's three-box squeeze (two cubes close on a third at 0.8
m/s in zero gravity; contact between dynamic bodies, several channels at
once) for 45 steps, with that test's own assertions on the port. Checks, with
their reasons:

- ``solver_iters`` and ``div_iters`` equal at every step (the correctors exit
  on a tolerance test);
- every step, each dynamic body's com and rotation within 1e-5, velocity and
  angular velocity within 1e-4 of the largest |value| of that quantity at
  that step, at least 1e-3 m/s or rad/s (the contact thresholds are
  discontinuous, so a divergence shows at the step where it starts);
- after the run, every fluid particle within 1e-5 of one of the JAX
  package's (nearest-neighbour match).
"""
import numpy as np
import pytest

from sph_project_tpu import sim as jsim
from sph_project_tpu_torch import sim as tsim

from test_rigid import base_cfg, rigid_body, write_cube_obj
from test_torch_dfsph import fluid_pos, nn_dist
from test_torch_scene import box_config, load_both

BODY_TOL = {"com": 1e-5, "rot": 1e-5, "vel": 1e-4, "omega": 1e-4}
RELATIVE = ("vel", "omega")
# a speed below which a body is at rest (m/s, rad/s): the relative bars take
# at least this as the largest |value|
SPEED_FLOOR = 1e-3


@pytest.fixture(scope="module")
def cube_small(tmp_path_factory):
    return write_cube_obj(str(tmp_path_factory.mktemp("mesh") / "cube6.obj"),
                          size=0.06)


def cube_pool_config(cube_obj: str, method: str) -> dict:
    """The domain-box scene of the port's tests with a shallow pool and a
    cube falling onto it (chip_smoke.py runs the same scene)."""
    cfg = box_config(method)
    cfg["FluidBlocks"][0].update(start=[0.08, 0.08, 0.08],
                                 end=[0.22, 0.13, 0.22], velocity=[0, 0, 0])
    cfg["RigidBodies"] = [rigid_body(1, cube_obj, (0.15, 0.175, 0.15),
                                     vel=(0.0, -1.5, 0.0))]
    return cfg


def squeeze_config(cube_obj: str) -> dict:
    """tests/test_rigid.py test_three_body_squeeze_momentum's scene."""
    return {"Configuration": base_cfg(dt=1e-3, gravity=(0, 0, 0)),
            "RigidBodies": [
                rigid_body(0, cube_obj, (0.17, 0.3, 0.3), vel=(0.8, 0, 0)),
                rigid_body(1, cube_obj, (0.30, 0.3, 0.3)),
                rigid_body(2, cube_obj, (0.43, 0.3, 0.3), vel=(-0.8, 0, 0))]}


def run_coupled(config, steps, **overrides):
    """``steps`` steps of ``config`` in both packages with the per-step
    checks above; returns (JAX simulation, port simulation, iterations)."""
    js, jst, ts, tst = load_both(config, port_kw=dict(overrides, pair_block=64),
                                 pair_block=64, pair_chunk=32, **overrides)
    assert ts.params.has_dynamic_rigid
    jax_sim = jsim.Simulation(js, jst)
    port = tsim.Simulation(ts, tst, device="cpu")
    bodies = list(ts.params.contact_channels)
    iters = []
    for s in range(steps):
        jd = jax_sim.step()
        td = port.step()
        assert set(td) == set(jd), f"step {s}: diagnostics keys differ"
        it = tuple(int(td[k]) for k in ("solver_iters", "div_iters")
                   if k in jd)
        assert it == tuple(int(jd[k]) for k in ("solver_iters", "div_iters")
                           if k in jd), f"step {s}: iterations {it}"
        iters.append(it)
        for k, tol in BODY_TOL.items():
            a = getattr(port.state.rigid, k)[bodies].numpy().astype(np.float64)
            b = np.asarray(getattr(jax_sim.state.rigid, k))[bodies]
            scale = max(np.abs(b).max(), SPEED_FLOOR) if k in RELATIVE \
                else 1.0
            err = np.abs(a - b).max()
            assert err <= tol * scale, f"step {s}: body {k} off by {err}"
        assert np.isfinite(port.state.rigid.com.numpy()).all()
    jp, tp = jax_sim.state.particles, port.state.particles
    a = fluid_pos(tp.pos.numpy(), tp.material.numpy())
    b = fluid_pos(jp.pos, jp.material)
    assert a.shape == b.shape and np.isfinite(a).all()
    if len(b):
        d = nn_dist(a, b)
        assert d.max() < 1e-5, f"trajectory drift {d.max():.2e}"
    return jax_sim, port, iters


def check_cube_pool(cube_obj, method, steps, **overrides):
    _, port, _ = run_coupled(cube_pool_config(cube_obj, method), steps,
                             **overrides)
    # the cube has met the pool: the fluid slowed it down
    vy = float(port.state.rigid.vel[1, 1])
    assert -1.5 - steps * 1e-3 * 9.81 < vy < -0.2


@pytest.mark.parametrize("method,steps", [
    ("dfsph", 20), ("wcsph", 10), ("pcisph", 10), ("iisph", 10)])
def test_cube_pool_steps_match_jax(cube_small, method, steps):
    """Under the cell-list engine (tests/test_torch_rigid_slab_steps.py runs
    the slab-window engine)."""
    check_cube_pool(cube_small, method, steps)

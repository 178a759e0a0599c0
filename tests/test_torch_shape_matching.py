"""The port's shape-matching rigid backend against the JAX package's.

- ``_polar_rotation``: seeded covariances in 3D and 2D, general ones with
  a condition number under 10, ones whose polar factor is a reflection
  before the fix (det(U V^T) = -1), and isotropic ones (a cube at rest):
  R = U V^T is unique for a nonsingular A, so R is held to the JAX
  package's (not U or V), within 1e-5.
- ``shape_matching_step`` on tests/test_torch_rigid_integrator.py's state
  (3D) and tests/test_torch_rigid_2d.py's (2D), the same seeded particles,
  body tables, forces and torques in both packages (a body pressed into the
  floor's inset, so the wall clamp and its velocity rules act): particles
  and bodies within 1e-6 of the largest |value| of each; the velocities,
  the motion over dt ((goal - x) / dt, (com - com_old) / dt), within that
  bar of the positions over dt.
- The DEM contact pass ``rigid_dem`` against the JAX pair pass of
  ``rigid_contact_wrench``: tests/test_torch_kinds_rigid_dem.py (the cubic
  spline in 3D) and tests/test_torch_kinds_rigid*.py (poly6, 2D).
- Steps through ``Simulation`` with ``rigidSolver: shape_matching``, 20 in
  both packages: tests/test_rigid.py's falling cube
  (``test_shape_matching_backend_stays_rigid``'s configuration) and its
  three-box squeeze (DEM contact every step), with the bars and their
  reasons in each test. The port's counterpart of the JAX test's 120 steps,
  with its rigidity measure, is in the slow tier, as the JAX test is.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_project_tpu import sim as jsim
from sph_project_tpu.rigid import shape_matching as jsm

from sph_project_tpu_torch import sim as tsim
from sph_project_tpu_torch.rigid import shape_matching as tsm
from sph_project_tpu_torch.scene import load_scene as torch_load_scene
from sph_project_tpu_torch.utils.config import SimConfig as TorchSimConfig

from test_rigid import base_cfg, rigid_body, write_cube_obj
from test_torch_dfsph import nn_dist
from test_torch_rigid_2d import Case2D
from test_torch_rigid_integrator import Case, assert_close
from test_torch_scene import load_both

STEPS = 20


@pytest.fixture(scope="module")
def cube_obj(tmp_path_factory):
    return write_cube_obj(str(tmp_path_factory.mktemp("mesh") / "cube.obj"))


@pytest.mark.parametrize("dim", [3, 2])
def test_polar_rotation(dim):
    rng = np.random.default_rng(dim)
    # the polar factor's rounding grows with A's condition number (a
    # rigid body's covariance is well conditioned)
    general = rng.normal(0.0, 1.0, (4000, dim, dim))
    general = general[np.linalg.cond(general) < 10]
    # a reflection of a near-rotation: det(U V^T) = -1 before the fix
    flip = np.eye(dim)
    flip[0, 0] = -1.0
    # (with distinct singular values: the fix flips the last singular
    # vector, which a near-isotropic A leaves undetermined)
    scale = np.diag(np.arange(dim, 0, -1.0))
    reflected = (flip @ scale)[None] + rng.normal(0.0, 0.05, (200, dim, dim))
    isotropic = rng.uniform(0.5, 2.0, (50, 1, 1)) * np.eye(dim)[None]
    A = np.concatenate([general, reflected, isotropic]).astype(np.float32)
    j = np.asarray(jsm._polar_rotation(jnp.asarray(A)))
    t = tsm._polar_rotation(torch.from_numpy(A)).numpy()
    assert np.abs(t - j).max() < 1e-5
    np.testing.assert_allclose(np.linalg.det(t.astype(np.float64)), 1.0,
                               atol=1e-5)


@pytest.mark.parametrize("dim", [3, 2])
def test_shape_matching_step(dim):
    case = Case() if dim == 3 else Case2D()
    jp, jr = jsm.shape_matching_step(case.jstate.particles, case.jstate.rigid,
                                     case.jp)
    tp, tr = tsm.shape_matching_step(case.tpart, case.trigid, case.tp)
    assert_close(tp.pos.numpy(), jp.pos, "positions")
    for k in ("com", "com0", "rot", "force", "torque"):
        assert_close(getattr(tr, k).numpy(), getattr(jr, k), k)
    # velocities are the motion over dt: held to the positions' bar over dt
    # (one float32 step of a position, 6e-8 at 0.5 m, is 3e-5 m/s)
    bar = 1e-6 * np.abs(np.asarray(jp.pos)).max() / case.tp.dt
    assert np.abs(tp.vel.numpy() - np.asarray(jp.vel)).max() <= bar
    assert np.abs(tr.vel.numpy() - np.asarray(jr.vel)).max() <= bar
    # the particles of the body pressed into the floor's inset lose their
    # velocity along y
    rows = tp.object_id.numpy() == 2
    assert rows.sum() > 0 and not tp.vel.numpy()[rows, 1].any()
    assert (np.asarray(jp.pos) != np.asarray(case.jstate.particles.pos)).any()


def cube_config(cube):
    """tests/test_rigid.py test_shape_matching_backend_stays_rigid's scene."""
    return {"Configuration": base_cfg(
        dt=2e-3, extra={"rigidSolver": "shape_matching"}),
        "RigidBodies": [rigid_body(0, cube, (0.3, 0.25, 0.3))]}


def squeeze_config(cube):
    """tests/test_rigid.py's three-box squeeze under shape matching, the
    outer cubes started 0.04 m closer to the middle one, so that the faces
    lie closer than a particle diameter and the DEM springs act from the
    first step."""
    return {"Configuration": base_cfg(
        gravity=(0, 0, 0), extra={"rigidSolver": "shape_matching"}),
        "RigidBodies": [
            rigid_body(0, cube, (0.21, 0.3, 0.3), vel=(0.8, 0, 0)),
            rigid_body(1, cube, (0.30, 0.3, 0.3)),
            rigid_body(2, cube, (0.39, 0.3, 0.3), vel=(-0.8, 0, 0))]}


def rigid_pos(p):
    pos, mat = np.asarray(p.pos), np.asarray(p.material)
    return pos[mat == 2].astype(np.float64)


def run_both(config, steps=STEPS):
    """``steps`` steps in both packages; per step the bodies' com, rotation
    and velocity in each, and the largest distance of a rigid particle of
    the port from the JAX package's nearest one."""
    js, jst, ts, tst = load_both(config, port_kw=dict(pair_block=64),
                                 pair_block=64, pair_chunk=32)
    assert ts.params.rigid_solver == "shape_matching"
    jax_sim = jsim.Simulation(js, jst)
    port = tsim.Simulation(ts, tst, device="cpu")
    bodies = list(ts.params.contact_channels)
    out = []
    for _ in range(steps):
        jax_sim.step()
        port.step()
        states = [{k: np.asarray(getattr(sim.state.rigid, k))[bodies]
                   .astype(np.float64) for k in ("com", "rot", "vel")}
                  for sim in (port, jax_sim)]
        d = nn_dist(rigid_pos(port.state.particles),
                    rigid_pos(jax_sim.state.particles)).max()
        out.append((*states, d))
    return out


def worst(out, k):
    return max(np.abs(t[k] - j[k]).max() for t, j, _ in out)


# The body velocity is the com's motion over dt (shape_matching.py:127), so
# one float32 step of the com (3e-8 m at 0.25 m) is 1.5e-5 m/s at dt 2 ms,
# and the com is a mean of ~1,000 positions summed in another order by each
# package: the velocity is held to 1e-3 of the largest |velocity|, the com
# and the particles to 1e-5.
VEL_REL = 1e-3


@pytest.mark.parametrize("name", ["cube", "squeeze"])
def test_steps_match_jax(cube_obj, name):
    """20 steps: the JAX test's falling cube (measured: particles 6.1e-7,
    velocity 1.5e-4 m/s of 0.39), and the squeeze, where the DEM slows the
    outer cubes from 0.8 to 0.29 m/s (measured: particles 2.3e-6, velocity
    6.3e-4 m/s of 0.8). The middle cube of the squeeze is pressed equally
    from both sides: its fitted rotation, a turn of order 1e-5 rad that the
    rounding of its covariance sets, differs by 1.4e-5 (measured) and is
    held to 1e-4, its particles to 1e-5 m as every other's."""
    config = (cube_config if name == "cube" else squeeze_config)(cube_obj)
    out = run_both(config)
    for s, (_, _, d) in enumerate(out):
        assert d < 1e-5, f"step {s}: rigid particles differ by {d:.2e}"
    assert worst(out, "com") < 1e-5
    assert worst(out, "rot") < (1e-5 if name == "cube" else 1e-4)
    vmax = max(np.abs(j["vel"]).max() for _, j, _ in out)
    assert vmax > 0.3 and worst(out, "vel") <= VEL_REL * vmax
    if name == "squeeze":
        v = out[-1][0]["vel"]
        assert v[0, 0] < 0.5 and v[2, 0] > -0.5


@pytest.mark.slow
def test_shape_matching_backend_stays_rigid(cube_obj):
    """tests/test_rigid.py's test on the port: a falling box lands and its
    particle cloud stays rigid, its distances from the centroid kept within
    5% (max and mean), over 120 steps."""
    scene, state = torch_load_scene(
        config=TorchSimConfig(config=cube_config(cube_obj)))
    sim = tsim.Simulation(scene, state, device="cpu")

    def shape_stats():
        pos = rigid_pos(sim.state.particles)
        r = np.linalg.norm(pos - pos.mean(axis=0), axis=1)
        return np.array([r.max(), r.mean()])

    e0 = shape_stats()
    for _ in range(120):
        sim.step()
    np.testing.assert_allclose(shape_stats(), e0, rtol=0.05)
    com = sim.state.rigid.com[0].numpy()
    assert np.isfinite(com).all()
    assert com[1] < 0.2, "box never fell"
    assert np.linalg.norm(sim.state.rigid.vel[0].numpy()) < 0.2

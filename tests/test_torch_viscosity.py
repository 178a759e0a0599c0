"""The port's implicit viscosity against the JAX package's.

- The two pair passes of the solve, ``visc_prep`` and ``visc_matvec``,
  through the port's plain executors of both engines against the JAX passes
  of ``solvers/viscosity_cg.py`` on the same sorted state (the domain-box
  scene with implicit viscosity and velocities from a numpy seed, so rigid
  neighbours add to b): max|a - b| <= 2e-5 * max(1, max|b|), float32 sums of
  ~30-60 terms in another order (tests/test_torch_pairs.py). The JAX passes
  are recorded from a JAX solve: its first call of ``pair_exec.run`` is the
  prep pass, its second the matvec at the warm start x0 = v.
- The closed-form 3x3 inverse against numpy's float64 inverse.
- One whole solve in each package on the same state: the new ``visc_x`` and
  the acceleration, within the bars below.
- 20 DFSPH steps of the domain-box scene with implicit viscosity 2000 (the
  reference's ``high_viscosity_implicit`` value; the block thrown onto the
  floor takes 800+ CG iterations in its first step) through both packages,
  with tests/test_torch_dfsph.py's checks: iteration counts and fluid counts
  equal every step, fluid within 1e-5 after the run. Here under the
  cell-list engine; tests/test_torch_viscosity_slab.py runs the slab-window
  engine and tests/test_torch_viscosity_cube.py a dynamic body in a pool.
"""
import numpy as np
import pytest
import torch

from sph_project_tpu import sim as jsim
from sph_project_tpu.ops import pair_exec as jpair_exec
from sph_project_tpu.solvers import common as jcommon
from sph_project_tpu.solvers import viscosity_cg as jvisc

from sph_project_tpu_torch import sim as tsim
from sph_project_tpu_torch.ops import pair_kernels
from sph_project_tpu_torch.ops import pairs as tpairs
from sph_project_tpu_torch.solvers import common as tcommon
from sph_project_tpu_torch.solvers import viscosity_cg as tvisc

from test_torch_dfsph import fluid_pos, nn_dist
from test_torch_pairs import Setup, assert_pass_close
from test_torch_scene import box_config, load_both

STEPS = 20
# the whole solve: each package stops its CG once the norm of the residual
# over all rows is under cg_tol = 1e-6, after float32 sums in another order,
# so the solutions may differ by about that much per row, in m/s (3.6e-7
# measured, with |visc_x| up to 0.67); the acceleration, the viscosity at the
# solution over dt = 1e-3 s plus the surface tension, by 1e3 times as much
# (2.4e-4 measured against |acc| up to 674): bars of 5e-6 m/s and
# 1e-5 * max(1, max|acc|)
VISC_X_TOL = 5e-6
ACC_TOL = 1e-5


def implicit_config(viscosity: float) -> dict:
    cfg = box_config()
    cfg["Configuration"].update(viscosityMethod="implicit",
                                viscosity=viscosity, viscosity_b=viscosity)
    return cfg


def jax_solve(s):
    """The JAX solve on ``s``'s state, with the surface tension and gravity
    in the acceleration first, as its Plumbing runs it; returns (particles,
    state, the outputs of its first two pair passes)."""
    calls = []
    real = jpair_exec.run

    def record(kern, env, slabs, fields, params):
        out = real(kern, env, slabs, fields, params)
        calls.append(out)
        return out

    p = s.jp.replace(acc=jcommon.gravity_acceleration(s.jp, s.jparams) +
                     jcommon.surface_tension_acceleration(
                         s.jp, s.jenv, s.jsl, s.jparams))
    jpair_exec.run = record
    try:
        p, _, state = jvisc.implicit_viscosity_solve(
            p, s.jrigid, s.jstate, s.jenv, s.jsl, s.jparams)
    finally:
        jpair_exec.run = real
    return p, state, {k: np.asarray(v) for k, v in calls[0].items()}, \
        np.asarray(calls[1]["acc"])


class ViscSetup(Setup):
    def __init__(self, engine):
        super().__init__(implicit_config(50.0), engine=engine)
        self.jp_out, self.jstate_out, self.jprep, self.jmatvec = jax_solve(self)
        self.fields = {"pos": self.tp.pos, "vel": self.tp.vel,
                       "material": self.tp.material, "mass": self.tp.mass,
                       "density": self.tp.density,
                       "rest_volume": self.tp.rest_volume,
                       "inv_rho": tcommon._inv_rho(self.tp)}


@pytest.fixture(scope="module")
def cell():
    s = ViscSetup("pallas_dma")
    assert type(s.tenv) is tpairs.PairEnv
    return s


@pytest.fixture(scope="module")
def slab():
    s = ViscSetup("pallas")
    assert isinstance(s.tenv, tpairs.SlabEnv)
    return s


ENGINES = ["cell", "slab"]


@pytest.mark.parametrize("engine", ENGINES)
def test_visc_prep_pass(request, engine):
    s = request.getfixturevalue(engine)
    fluid = torch.from_numpy(s.fluid)
    out = pair_kernels.run("visc_prep", s.tenv, s.fields, s.params,
                           produce=fluid)
    for k in ("Axx", "Axy", "Axz", "Ayy", "Ayz", "Azz"):
        b = s.j(s.jprep[k])[s.fluid]
        assert np.abs(b).max() > 0, k
        assert_pass_close(out[k].numpy()[s.fluid], b, f"visc_prep {k}")
    br = s.j(s.jprep["br"])[s.fluid]
    # rigid neighbours move b on the rows next to the walls
    assert (np.abs(br).max(1) > 0).sum() > 10
    assert_pass_close(out["br"].numpy()[s.fluid], br, "visc_prep br")


@pytest.mark.parametrize("engine", ENGINES)
def test_visc_matvec_pass(request, engine):
    """The matvec at the JAX solve's warm start, x0 = v on the fluid rows."""
    s = request.getfixturevalue(engine)
    fluid = torch.from_numpy(s.fluid)
    x0 = torch.where(fluid[:, None], s.tp.vel, torch.zeros(()))
    fields = {k: s.fields[k] for k in ("pos", "material", "mass", "density")}
    out = pair_kernels.run("visc_matvec", s.tenv, dict(fields, x=x0),
                           s.params, produce=fluid)["acc"]
    b = s.j(s.jmatvec)[s.fluid]
    assert np.abs(b).max() > 0
    assert_pass_close(out.numpy()[s.fluid], b, "visc_matvec")


def test_inverse3_matches_float64():
    """Seeded 3x3 matrices, the preconditioner's kind (I plus a symmetric
    part) and general ones with a condition number under 100: within 1e-5
    of the largest |entry| of the float64 inverse."""
    rng = np.random.default_rng(0)
    s = rng.normal(0.0, 0.3, (4000, 3, 3))
    sym = np.eye(3) + 0.5 * (s + s.transpose(0, 2, 1))
    gen = rng.normal(0.0, 1.0, (4000, 3, 3))
    for m in (sym, gen):
        m = m[np.linalg.cond(m) < 100].astype(np.float32)
        assert len(m) > 1000
        want = np.linalg.inv(m.astype(np.float64))
        got = tvisc.inverse3(torch.from_numpy(m)).numpy()
        err = np.abs(got - want).max(axis=(1, 2))
        assert (err <= 1e-5 * np.abs(want).max(axis=(1, 2))).all(), err.max()


def test_inverse3_of_the_preconditioner(cell):
    """The per-row D = I + dt/rho0 A_sum of the test state."""
    a = cell.jprep
    rows = np.stack([np.stack([a["Axx"], a["Axy"], a["Axz"]], -1),
                     np.stack([a["Axy"], a["Ayy"], a["Ayz"]], -1),
                     np.stack([a["Axz"], a["Ayz"], a["Azz"]], -1)], -2)
    d = (np.eye(3, dtype=np.float32)
         + np.float32(cell.params.dt / cell.params.density0) * rows)
    d = cell.j(d)[cell.fluid]
    want = np.linalg.inv(d.astype(np.float64))
    got = tvisc.inverse3(torch.from_numpy(d)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("engine", ENGINES)
def test_solve_matches_jax(request, engine):
    s = request.getfixturevalue(engine)
    p = s.tp.replace(acc=tcommon.gravity_acceleration(s.tp, s.params))
    p, _, state = tvisc.implicit_viscosity_solve(p, s.trigid, s.tstate,
                                                 s.tenv, s.params)
    assert tvisc.last_solve["cg_iters"] > 1
    want = s.j(s.jstate_out.visc_x)[s.fluid]
    got = state.visc_x.numpy()[s.fluid]
    assert np.abs(want).max() > 0.1
    assert np.abs(got - want).max() <= VISC_X_TOL
    assert (state.visc_x.numpy()[~s.fluid] == 0).all()
    acc = s.j(s.jp_out.acc)
    err = np.abs(p.acc.numpy() - acc).max()
    assert err <= ACC_TOL * max(1.0, np.abs(acc).max()), err


def check_implicit_steps(**overrides):
    """STEPS steps of the implicit domain-box scene through both packages,
    with ``overrides`` (the engine) in both."""
    js, jst, ts, tst = load_both(implicit_config(2000.0),
                                 port_kw=dict(overrides, pair_block=64),
                                 pair_block=64, pair_chunk=32, **overrides)
    assert ts.params.viscosity_method == "implicit"
    jax_sim = jsim.Simulation(js, jst)
    port = tsim.Simulation(ts, tst, device="cpu")
    cg = []
    for s in range(STEPS):
        jd = jax_sim.step()
        td = port.step()
        assert set(td) == set(jd), f"step {s}: diagnostics keys differ"
        for k in ("solver_iters", "div_iters", "fluid_num"):
            assert int(td[k]) == int(jd[k]), \
                f"step {s}: {k} {int(td[k])} vs JAX {int(jd[k])}"
        cg.append(tvisc.last_solve["cg_iters"])
    # the block hits the floor in the first step: a long solve, then short
    assert cg[0] > 100 and max(cg[1:]) < cg[0]
    jp, tp = jax_sim.state.particles, port.state.particles
    a = fluid_pos(tp.pos.numpy(), tp.material.numpy())
    b = fluid_pos(jp.pos, jp.material)
    assert a.shape == b.shape and np.isfinite(a).all()
    d = nn_dist(a, b)
    assert d.max() < 1e-5, f"trajectory drift {d.max():.2e}"


def test_implicit_steps_match_jax():
    """Under the cell-list engine (tests/test_torch_viscosity_slab.py runs
    the slab-window engine)."""
    check_implicit_steps()

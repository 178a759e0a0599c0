"""Every pair pass of the port in 2D and under the poly6 kind, against the
JAX package: here the passes of DFSPH, WCSPH, PCISPH and IISPH under the
cubic spline in 2D. The same checks run under poly6 in 3D
(tests/test_torch_kinds_poly6.py) and in 2D
(tests/test_torch_kinds_poly6_2d.py); the implicit viscosity's passes and
PBF's under the cubic spline in tests/test_torch_kinds_visc.py.

The configurations: a 2D domain box (a 0.1 x 0.1 fluid block in a 0.3 x
0.3 box of static walls, the 2D counterpart of tests/test_torch_scene.py's
``box_config``), and that 3D box itself under ``kernel_type="poly6"``, each
with its block resting on the floor, so that walls are neighbours. The JAX package prepares (sorts) a state; the
bridge carries it to the port row for row; the port sorts it by its own cell
ids (``perm``). Velocities, stiffnesses, pressures, predicted positions and
the IISPH sums are made from a seed with numpy. Each pass runs in the port
through the plain version of the body under either engine (cell-list,
slab-window) and in the JAX package through its CPU executor:

- the DFSPH bodies: ``density``, ``alpha``, ``nonpressure``, ``divergence``
  with its count, ``correction``, ``nonpressure_warm``,
  ``density_alpha_divergence`` with its count, and the prepare-time
  ``rigid_volume`` of the walls;
- ``pressure`` (WCSPH, PCISPH, IISPH), ``pcisph_density_pred`` and the
  five IISPH bodies;
- (``check_viscosity``) the two passes of the implicit viscosity
  (``visc_prep``: the D(D+1)/2 sums of A, compared as one matrix, and b's
  rigid term; ``visc_matvec``).

The bodies with dynamic-rigid outputs, the contact passes and the DEM
contact: tests/test_torch_kinds_rigid.py.

Tolerance of a pass: max|a - b| <= 2e-5 * max(1, max|b|), as
tests/test_torch_pairs.py; neighbour counts exact.
"""
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_project_tpu import sim as jsim
from sph_project_tpu.scene import load_scene as jax_load_scene
from sph_project_tpu.ops import neighbors as jnbl
from sph_project_tpu.ops import pair_exec as jpair_exec
from sph_project_tpu.ops.pairs import slab_pack
from sph_project_tpu.solvers import common as jcommon
from sph_project_tpu.solvers import dfsph as jdfsph
from sph_project_tpu.solvers import iisph as jiisph
from sph_project_tpu.solvers import pcisph as jpcisph
from sph_project_tpu.solvers import viscosity_cg as jvisc
from sph_project_tpu.utils.config import SimConfig as JaxSimConfig

from sph_project_tpu_torch import bridge
from sph_project_tpu_torch import sim as tsim
from sph_project_tpu_torch.scene import load_scene as torch_load_scene
from sph_project_tpu_torch.ops import pair_kernels
from sph_project_tpu_torch.solvers import common as tcommon
from sph_project_tpu_torch.solvers import dfsph as tdfsph
from sph_project_tpu_torch.solvers import iisph as tiisph
from sph_project_tpu_torch.solvers import pcisph as tpcisph
from sph_project_tpu_torch.utils.config import SimConfig as TorchSimConfig

from test_torch_pairs import assert_pass_close
from test_torch_scene import flatten_jax_state

ENGINES = ("pallas_dma", "pallas")
ENGINE_IDS = ("cell_list", "slab_window")


def box2d_config(method="dfsph"):
    """The 2D domain box: a 0.1 x 0.1 fluid block thrown at 2.5 m/s onto
    the floor of a 0.3 x 0.3 box of static walls."""
    return {
        "Configuration": {
            "domainStart": [0, 0], "domainEnd": [0.3, 0.3],
            "addDomainBox": True, "particleRadius": 0.01, "density0": 1000,
            "gravitation": [0, -9.81], "simulationMethod": method,
            "viscosityMethod": "standard", "timeStepSize": 1e-3,
            "viscosity": 0.05, "viscosity_b": 0.03},
        "FluidBlocks": [{"objectId": 0, "start": [0.1, 0.08],
                         "end": [0.2, 0.18], "translation": [0, 0],
                         "scale": [1, 1], "velocity": [0.0, -2.5],
                         "density": 1000.0, "color": [50, 100, 200],
                         "entryTime": -1.0}]}


def on_floor(config: dict) -> dict:
    """``config`` with its fluid block resting on the floor, so that the
    walls are neighbours of its lower rows."""
    block = config["FluidBlocks"][0]
    block["start"][1], block["end"][1] = 0.04, 0.14
    block["velocity"] = [0.0] * len(block["velocity"])
    return config


def implicit(config: dict, viscosity: float = 50.0) -> dict:
    """``config`` with implicit viscosity (fluid and walls)."""
    config["Configuration"].update(viscosityMethod="implicit",
                                   viscosity=viscosity, viscosity_b=viscosity)
    return config


# the JAX package's prepared states, by configuration, overrides and
# state_fn: the same for either of the port's engines
_JAX_STATES: dict = {}


def _jax_prepared(config, state_fn, overrides):
    """(JAX scene, its prepared state, the extra parameters of
    ``state_fn``), loaded and prepared once per module and key."""
    key = (json.dumps(config, sort_keys=True), state_fn,
           tuple(sorted(overrides.items())))
    if key not in _JAX_STATES:
        js, jst = jax_load_scene(config=JaxSimConfig(config=config),
                                 pair_block=64, pair_chunk=32, **overrides)
        kw = {}
        if state_fn is not None:
            kw, jst = state_fn(js.params, jst)
        jparams = dataclasses.replace(js.params, **kw)
        _JAX_STATES[key] = (jparams, jsim.prepare(jst, jparams), kw)
    return _JAX_STATES[key]


class KindSetup:
    """A JAX-prepared sorted state of ``config`` under ``overrides`` (the
    kernel kind), the port's sort of the same rows, and seeded fields.
    ``state_fn(JAX params, JAX state)`` may rebuild the loaded state before
    the JAX package prepares it; it returns (parameter overrides for both
    packages, the state)."""

    def __init__(self, config, engine, state_fn=None, **overrides):
        self.jparams, jstate, kw = _jax_prepared(config, state_fn, overrides)
        ts, _ = torch_load_scene(config=TorchSimConfig(config=config),
                                 pair_block=64, pair_backend=engine,
                                 **overrides)
        self.params = dataclasses.replace(ts.params, **kw)
        n, dim = self.params.n_pad, self.params.dim
        rng = np.random.default_rng(0)
        self.vel_np = rng.normal(0.0, 0.5, (n, dim)).astype(np.float32)
        self.kappa_np = rng.uniform(-50.0, 200.0, n).astype(np.float32)
        self.jstate = jstate
        self.jp = jstate.particles.replace(vel=self.vel_np)
        self.jrigid = jstate.rigid
        self.jenv = jstate.cached_neighbors
        self.jsl = jcommon.particle_slabs(self.jenv, self.jp,
                                          jcommon.STATIC_SLAB_KEYS)
        flat = flatten_jax_state(jstate)
        flat["particles.vel"] = self.vel_np
        tstate = bridge.state_from_numpy(flat, self.params)
        tstate, self.cells, perm = tsim.sort_state(tstate, self.params)
        self.perm = perm.numpy()
        self.tstate = tstate
        self.tp = tstate.particles
        self.trigid = tstate.rigid
        self.kappa = torch.from_numpy(self.kappa_np[self.perm])
        self.tenv = tsim.build_env(
            self.cells, tsim.produces_output(self.tp, self.trigid, self.params),
            self.params)
        self.fluid = self.tp.material.numpy() == 1
        self.jfluid = np.asarray(self.jp.material) == 1

    def j(self, x):
        """A JAX per-row output in the port's row order."""
        return np.asarray(x)[self.perm]

    def t(self, x):
        """A per-row array in the JAX row order as a port tensor."""
        return torch.from_numpy(np.ascontiguousarray(self.j(x)))

    def seeded(self, seed, lo, hi, shape=()):
        """Uniform values on the fluid rows, 0 elsewhere, JAX row order."""
        rng = np.random.default_rng(seed)
        x = rng.uniform(lo, hi, (self.params.n_pad,) + shape)
        mask = self.jfluid.reshape((-1,) + (1,) * len(shape))
        return np.where(mask, x, 0.0).astype(np.float32)


def _close(t, j, s, what, rows=None):
    rows = s.fluid if rows is None else rows
    j = s.j(j)
    assert np.abs(j[rows]).max() > 0, f"{what}: zero reference"
    assert_pass_close(np.asarray(t)[rows], j[rows], what)


# ---- the checks, one per pass ----------------------------------------------

def check_density(s):
    j = jcommon.compute_density(s.jp, s.jenv, s.jsl, s.jparams)
    t = tcommon.compute_density(s.tp, s.tenv, s.params)
    _close(t.numpy(), j, s, "density")


def check_alpha(s):
    j = jdfsph.compute_alpha(s.jp, s.jenv, s.jsl, s.jparams)
    t = tdfsph.compute_alpha(s.tp, s.tenv, s.params)
    _close(t.numpy(), j, s, "alpha")


def check_nonpressure(s):
    j, _, _ = jcommon.nonpressure_fused(s.jp, s.jrigid, s.jenv, s.jsl,
                                        s.jparams)
    t, _, _ = tcommon.nonpressure_fused(s.tp, s.trigid, s.tenv, s.params)
    _close(t.numpy(), j, s, "nonpressure")


def check_divergence(s):
    vs = slab_pack(s.jenv, {"v": s.jp.vel})["v"]
    j, jc = jdfsph._divergence_sum(s.jp, s.jp.vel, vs, s.jenv, s.jsl,
                                   s.jparams, with_count=True)
    t, tc = tdfsph._divergence_sum(s.tp, s.tp.vel, s.tenv, s.params,
                                   with_count=True)
    np.testing.assert_array_equal(tc.numpy()[s.fluid], s.j(jc)[s.fluid])
    _close(t.numpy(), j, s, "divergence")


def check_correction(s):
    j, _, _ = jdfsph._correction(s.jp, s.jrigid, jnp.asarray(s.kappa_np),
                                 None, s.jenv, s.jsl, s.jparams)
    t, _, _ = tdfsph._correction(s.tp, s.trigid, s.kappa, s.tenv, s.params)
    _close(t.numpy(), j, s, "correction")


def check_nonpressure_warm(s):
    kw = np.maximum(s.kappa_np, 0.0) * s.jfluid
    ja, _, _, jdv, _, _ = jdfsph.nonpressure_warm_fused(
        s.jp, s.jrigid, jnp.asarray(kw), s.jenv, s.jsl, s.jparams)
    ta, _, _, tdv, _, _ = tdfsph.nonpressure_warm_fused(
        s.tp, s.trigid, s.t(kw), s.tenv, s.params)
    _close(ta.numpy(), ja, s, "nonpressure_warm acceleration")
    _close(tdv.numpy(), jdv, s, "nonpressure_warm dv")


def check_density_alpha_divergence(s):
    jd, ja, jv, _ = jdfsph.density_alpha_divergence(s.jp, s.jenv, s.jsl,
                                                    s.jparams)
    td, ta, tv, _ = tdfsph.density_alpha_divergence(s.tp, s.tenv, s.params)
    _close(td.numpy(), jd, s, "fused density")
    _close(ta.numpy(), ja, s, "fused alpha")
    _close(tv.numpy(), jv, s, "fused divergence")
    cnt = pair_kernels.run("density_alpha_divergence", s.tenv,
                           {"pos": s.tp.pos, "vel": s.tp.vel,
                            "rest_volume": s.tp.rest_volume,
                            "material": s.tp.material}, s.params)["cnt"]
    vs = slab_pack(s.jenv, {"v": s.jp.vel})["v"]
    _, jc = jdfsph._divergence_sum(s.jp, s.jp.vel, vs, s.jenv, s.jsl,
                                   s.jparams, with_count=True)
    np.testing.assert_array_equal(cnt.numpy()[s.fluid], s.j(jc)[s.fluid])


def check_rigid_volume(s):
    """The prepare-time wall volumes: the port's pass against the JAX
    package's fixed-K sum (its list must not have cut anything)."""
    jst, jenv = jsim.Plumbing.neighbor_prep(s.jstate, s.jparams,
                                            exact_sort=True)
    jp = jst.particles
    cells = jnbl.flat_cell_ids(jp.pos, jp.material != 0, s.jparams)
    nb = jnbl.build_neighbors(jp.pos, cells, s.jparams)
    assert int(nb.k_overflow) == 0 and int(nb.cell_overflow) == 0
    j = jcommon.compute_rigid_volume_fixedk(jp, s.jparams)
    tst = bridge.state_from_numpy(flatten_jax_state(jst), s.params)
    tst, cells_t, perm = tsim.sort_state(tst, s.params)
    env = tsim.build_env(cells_t, tst.particles.material == 1, s.params)
    t = tcommon.compute_rigid_volume_fixedk(tst.particles, env, s.params)
    rigid = t.material.numpy() == 2
    assert rigid.sum() > 0
    perm = perm.numpy()
    for field in ("rest_volume", "mass"):
        assert_pass_close(getattr(t, field).numpy()[rigid],
                          np.asarray(getattr(j, field))[perm][rigid], field)


def check_pressure(s):
    pr = s.seeded(1, 0.0, 5000.0)
    jp = s.jp.replace(pressure=pr)
    jsl = dict(s.jsl, pressure=slab_pack(s.jenv, {"pr": pr})["pr"])
    j, _, _ = jcommon.pressure_acceleration(jp, s.jrigid, s.jenv, jsl,
                                            s.jparams, with_wrench=False)
    tp = s.tp.replace(pressure=s.t(pr))
    t, _, _ = tcommon.pressure_acceleration(tp, s.trigid, s.tenv, s.params)
    _close(t.numpy(), j, s, "pressure acceleration")


def check_pcisph_density_pred(s):
    """Predicted positions up to 0.3 particle radius off the sorted ones per
    axis: pairs at the support radius move inside and outside it."""
    r = 0.3 * s.params.particle_radius
    pos = np.asarray(s.jp.pos)
    shift = np.random.default_rng(3).uniform(-r, r, pos.shape)
    pred = np.where(s.jfluid[:, None], pos + shift, pos).astype(np.float32)
    pred_slab = slab_pack(s.jenv, {"x": pred})["x"]
    j, j_err = jpcisph._density_star_predicted(s.jp, pred, pred_slab, s.jenv,
                                               s.jsl, s.jparams)
    t, t_err = tpcisph.density_star_predicted(s.tp, s.t(pred), s.tenv,
                                              s.params)
    assert_pass_close(t.numpy(), s.j(j), "predicted density")
    assert np.asarray(j).max() > 0
    assert_pass_close(float(t_err), float(j_err), "density error")


def _iisph_inputs(s):
    star_prev = s.seeded(4, 950.0, 1050.0)
    jdii = jiisph.compute_dii(s.jp, star_prev, s.jenv, s.jsl, s.jparams)
    jaii = jiisph.compute_aii(s.jp, jdii, None, s.jenv, s.jsl, s.jparams)
    jstar = jiisph.compute_density_star(s.jp, s.jenv, s.jsl, s.jparams)
    return star_prev, jdii, jaii, jstar


def check_iisph(s):
    """d_ii, a_ii and rho* against the JAX functions; the two kernels of
    ``refine`` (d_ij p_j, sum_i) against the JAX kernels recorded from a run
    of its ``refine``, fed seeded pressures and sums d_ij p_j."""
    star_prev, jdii, jaii, jstar = _iisph_inputs(s)
    dii = tiisph.compute_dii(s.tp, s.t(star_prev), s.tenv, s.params)
    _close(dii.numpy(), jdii, s, "d_ii")
    dii = s.t(jdii)
    dpi = tiisph._dpi(s.tp, s.params)
    aii = tiisph.compute_aii(s.tp, dii, dpi, s.tenv, s.params)
    _close(aii.numpy(), jaii, s, "a_ii")
    star = tiisph.compute_density_star(s.tp, s.tenv, s.params)
    _close(star.numpy(), jstar, s, "advected density")

    calls = []
    run = jpair_exec.run

    def spy(kern, env, slabs, fields, params):
        calls.append((kern, slabs, fields))
        return run(kern, env, slabs, fields, params)

    jpair_exec.run = spy
    try:
        jiisph.refine(s.jp, jdii, jaii, jstar, s.jenv, s.jsl, s.jparams)
    finally:
        jpair_exec.run = run
    assert len(calls) == 2
    pr = s.seeded(5, 0.0, 3000.0)
    dp = np.random.default_rng(6).normal(
        0.0, 10.0, (s.params.n_pad, s.params.dim)).astype(np.float32)
    up = slab_pack(s.jenv, {"pr": pr, "dp": dp})
    kern, slabs, fields = calls[0]
    j = jpair_exec.run(kern, s.jenv, dict(slabs, pr=up["pr"]), fields,
                       s.jparams)["dp"]
    tp = s.tp
    t = pair_kernels.run("iisph_dij_pj", s.tenv,
                         {"pos": tp.pos, "material": tp.material,
                          "density": tp.density, "rest_volume": tp.rest_volume,
                          "pressure": s.t(pr)}, s.params)["dp"]
    _close(t.numpy(), j, s, "sum d_ij p_j")
    kern, slabs, fields = calls[1]
    j = jpair_exec.run(kern, s.jenv, dict(slabs, pr=up["pr"], dp=up["dp"]),
                       dict(fields, pr=jnp.asarray(pr),
                            dij_pj=jnp.asarray(dp)), s.jparams)["s"]
    t = pair_kernels.run("iisph_sum_i", s.tenv,
                         {"pos": tp.pos, "material": tp.material,
                          "rest_volume": tp.rest_volume, "dii": dii,
                          "pressure": s.t(pr), "dij_pj": s.t(dp),
                          "dpi": dpi}, s.params)["s"]
    _close(t.numpy(), j, s, "sum_i")


def check_viscosity(s):
    """The two passes of the implicit solve, recorded from a JAX solve (its
    first pass is the prep, its second the matvec at x0 = v), and the
    preconditioner's closed-form inverse."""
    calls = []
    real = jpair_exec.run

    def record(kern, env, slabs, fields, params):
        out = real(kern, env, slabs, fields, params)
        calls.append(out)
        return out

    jpair_exec.run = record
    try:
        jvisc.implicit_viscosity_solve(s.jp, s.jrigid, s.jstate, s.jenv,
                                       s.jsl, s.jparams)
    finally:
        jpair_exec.run = real
    fluid = torch.from_numpy(s.fluid)
    tp = s.tp
    fields = {"pos": tp.pos, "vel": tp.vel, "material": tp.material,
              "mass": tp.mass, "density": tp.density,
              "rest_volume": tp.rest_volume, "inv_rho": tcommon._inv_rho(tp)}
    out = pair_kernels.run("visc_prep", s.tenv, fields, s.params,
                           produce=fluid)
    names = pair_kernels.out_names("visc_prep", s.params)
    assert len(names) == s.params.dim * (s.params.dim + 1) // 2 + \
        s.params.dim
    # the sums of A as one matrix: an off-diagonal sum cancels terms of the
    # diagonal's size (1e6 here), so its rounding is the matrix's
    a_names = names[:-s.params.dim]
    _close(np.stack([out[k].numpy() for k in a_names], -1),
           np.stack([np.asarray(calls[0][k]) for k in a_names], -1), s,
           "visc_prep A")
    _close(out["br"].numpy(), calls[0]["br"], s, "visc_prep br")
    x0 = torch.where(fluid[:, None], tp.vel, torch.zeros(()))
    acc = pair_kernels.run(
        "visc_matvec", s.tenv,
        dict({k: fields[k] for k in ("pos", "material", "mass", "density")},
             x=x0), s.params, produce=fluid)["acc"]
    _close(acc.numpy(), calls[1]["acc"], s, "visc_matvec")


CHECKS = {
    "density": check_density, "alpha": check_alpha,
    "nonpressure": check_nonpressure, "divergence": check_divergence,
    "correction": check_correction,
    "nonpressure_warm": check_nonpressure_warm,
    "density_alpha_divergence": check_density_alpha_divergence,
    "rigid_volume": check_rigid_volume, "pressure": check_pressure,
    "pcisph_density_pred": check_pcisph_density_pred, "iisph": check_iisph,
}


def kind_setups(config, **overrides):
    """A module fixture: the setup of ``config`` with its block on the
    floor, per engine."""
    @pytest.fixture(scope="module", params=ENGINES, ids=ENGINE_IDS)
    def setup(request):
        return KindSetup(on_floor(config()), request.param, **overrides)

    return setup


box2d = kind_setups(box2d_config)


def test_setup_is_2d_cubic(box2d):
    assert box2d.params.dim == 2 and box2d.params.kernel_type == "cubic"
    assert box2d.vel_np.shape[1] == 2 and (~box2d.fluid).sum() > 100


@pytest.mark.parametrize("name", CHECKS)
def test_pass(box2d, name):
    CHECKS[name](box2d)

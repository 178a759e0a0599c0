"""Each pair pass of the port against its JAX counterpart.

The JAX package prepares (sorts) a state; the bridge carries it to the port
row for row; the port sorts it by its own cell ids (``perm``) and runs the
plain version of each pair body, here under the cell-list engine
(tests/test_torch_slab.py runs the same checks under the slab-window engine).
Outputs are compared row for row through ``perm``. Velocities and
stiffnesses are made from a seed with numpy so every term of every body is
non-trivial.

Tolerance: max|a - b| <= 2e-5 * max(1, max|b|): float32 sums over <= ~60
terms in another order. Neighbour counts are compared exactly.
"""
import numpy as np
import pytest
import torch

from sph_project_tpu import sim as jsim
from sph_project_tpu.ops import neighbors as jnbl
from sph_project_tpu.ops.pairs import slab_pack
from sph_project_tpu.solvers import common as jcommon
from sph_project_tpu.solvers import dfsph as jdfsph

from sph_project_tpu_torch import bridge
from sph_project_tpu_torch import sim as tsim
from sph_project_tpu_torch.ops import pair_kernels
from sph_project_tpu_torch.solvers import common as tcommon
from sph_project_tpu_torch.solvers import dfsph as tdfsph

from test_torch_scene import box_config, flatten_jax_state, load_both

TOL = 2e-5


def assert_pass_close(a, b, what):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    err = np.max(np.abs(a - b)) if a.size else 0.0
    assert err <= TOL * max(1.0, np.max(np.abs(b))), f"{what}: max err {err}"


class Setup:
    """A JAX-prepared sorted state and the port's sort of the same rows."""

    def __init__(self, config, engine="pallas_dma", **jax_kw):
        js, jst, ts, _ = load_both(
            config, port_kw=dict(pair_block=64, pair_backend=engine),
            pair_block=64, pair_chunk=32, **jax_kw)
        self.jparams, self.params = js.params, ts.params
        jstate = jsim.prepare(jst, js.params)
        n = self.params.n_pad
        rng = np.random.default_rng(0)
        vel = rng.normal(0.0, 0.5, (n, 3)).astype(np.float32)
        kappa = rng.uniform(-50.0, 200.0, n).astype(np.float32)
        self.vel_np, self.kappa_np = vel, kappa
        self.jp = jstate.particles.replace(vel=vel)
        self.jrigid = jstate.rigid
        self.jstate = jstate
        self.jenv = jstate.cached_neighbors
        self.jsl = jcommon.particle_slabs(self.jenv, self.jp,
                                          jcommon.STATIC_SLAB_KEYS)
        flat = flatten_jax_state(jstate)
        flat["particles.vel"] = vel
        tstate = bridge.state_from_numpy(flat, self.params)
        # the JAX env's produce rows are fluid; carry kappa through the sort
        tstate, self.cells, self.perm = tsim.sort_state(tstate, self.params)
        self.perm = self.perm.numpy()
        self.tstate = tstate
        self.tp = tstate.particles
        self.trigid = tstate.rigid
        self.kappa = torch.from_numpy(kappa[self.perm])
        self.produce = tsim.produces_output(self.tp, self.trigid, self.params)
        self.tenv = tsim.build_env(self.cells, self.produce, self.params)
        self.fluid = self.tp.material.numpy() == 1

    def j(self, x):
        """A JAX per-row output in the port's row order."""
        return np.asarray(x)[self.perm]


@pytest.fixture(scope="module")
def box():
    return Setup(box_config())


def test_sort_keeps_rows(box):
    assert sorted(box.perm.tolist()) == list(range(box.params.n_pad))
    np.testing.assert_array_equal(box.tp.pos.numpy(), box.j(box.jp.pos))


def test_density_pass(box):
    j = jcommon.compute_density(box.jp, box.jenv, box.jsl, box.jparams)
    t = tcommon.compute_density(box.tp, box.tenv, box.params)
    assert_pass_close(t.numpy()[box.fluid], box.j(j)[box.fluid], "density")


def test_alpha_pass(box):
    j = jdfsph.compute_alpha(box.jp, box.jenv, box.jsl, box.jparams)
    t = tdfsph.compute_alpha(box.tp, box.tenv, box.params)
    assert_pass_close(t.numpy(), box.j(j), "alpha")


def test_nonpressure_pass(box):
    j, _, _ = jcommon.nonpressure_fused(box.jp, box.jrigid, box.jenv, box.jsl,
                                        box.jparams)
    t, _, _ = tcommon.nonpressure_fused(box.tp, box.trigid, box.tenv,
                                        box.params)
    assert_pass_close(t.numpy(), box.j(j), "nonpressure")


@pytest.mark.parametrize("with_count", [False, True])
def test_divergence_pass(box, with_count):
    vs = slab_pack(box.jenv, {"v": box.jp.vel})["v"]
    j = jdfsph._divergence_sum(box.jp, box.jp.vel, vs, box.jenv, box.jsl,
                               box.jparams, with_count=with_count)
    t = tdfsph._divergence_sum(box.tp, box.tp.vel, box.tenv, box.params,
                               with_count=with_count)
    if with_count:
        (j, jc), (t, tc) = j, t
        np.testing.assert_array_equal(tc.numpy()[box.fluid],
                                      box.j(jc)[box.fluid])
    assert_pass_close(t.numpy()[box.fluid], box.j(j)[box.fluid], "divergence")


def test_correction_pass(box):
    j, _, _ = jdfsph._correction(box.jp, box.jrigid, box.kappa_np, None,
                                 box.jenv, box.jsl, box.jparams)
    t, _, _ = tdfsph._correction(box.tp, box.trigid, box.kappa, box.tenv,
                                 box.params)
    assert_pass_close(t.numpy(), box.j(j), "correction")


def test_nonpressure_warm_pass(box):
    """The fused non-pressure + warm-correction pass: both the acceleration
    and the warm dv."""
    kw = np.where(box.fluid, np.maximum(box.kappa.numpy(), 0.0),
                  0.0).astype(np.float32)
    kw_j = np.empty_like(kw)
    kw_j[box.perm] = kw
    ja, _, _, jdv, _, _ = jdfsph.nonpressure_warm_fused(
        box.jp, box.jrigid, kw_j, box.jenv, box.jsl, box.jparams)
    ta, _, _, tdv, _, _ = tdfsph.nonpressure_warm_fused(
        box.tp, box.trigid, torch.from_numpy(kw), box.tenv, box.params)
    assert np.abs(np.asarray(jdv)).max() > 0
    assert_pass_close(ta.numpy(), box.j(ja), "nonpressure_warm a")
    assert_pass_close(tdv.numpy(), box.j(jdv), "nonpressure_warm dv")


def test_density_solver_warm_from_carried_stiffness(box):
    """correct_density_error(kappa0=...): the warm path whose correction is a
    pass of its own (the step takes it when the non-pressure pass cannot carry
    the correction). Same iterations, velocities and accumulated stiffness."""
    kj = np.empty_like(box.kappa_np)
    kj[box.perm] = box.kappa.numpy()
    ja = jdfsph.compute_alpha(box.jp, box.jenv, box.jsl, box.jparams)
    jp, _, jitr, jerr, jk = jdfsph.correct_density_error(
        box.jp, box.jrigid, ja, box.jenv, box.jsl, box.jparams, kappa0=kj)
    ta = tdfsph.compute_alpha(box.tp, box.tenv, box.params)
    tp, _, titr, terr, tk = tdfsph.correct_density_error(
        box.tp, box.trigid, ta, box.tenv, box.params, kappa0=box.kappa)
    assert titr == int(jitr) >= 1
    assert np.abs(np.asarray(jk)).max() > 0
    assert_pass_close(tk.numpy(), box.j(jk), "accumulated stiffness")
    assert_pass_close(tp.vel.numpy(), box.j(jp.vel), "corrected velocity")
    assert_pass_close(float(terr), float(jerr), "error")


def _check_dad(s, jout):
    jd, ja, jv, _ = jout
    td, ta, tv, _ = tdfsph.density_alpha_divergence(s.tp, s.tenv, s.params)
    assert_pass_close(td.numpy(), s.j(jd), "dad density")
    assert_pass_close(ta.numpy(), s.j(ja), "dad alpha")
    assert_pass_close(tv.numpy(), s.j(jv), "dad deriv0")
    cnt = pair_kernels.run("density_alpha_divergence", s.tenv,
                           {"pos": s.tp.pos, "vel": s.tp.vel,
                            "rest_volume": s.tp.rest_volume,
                            "material": s.tp.material}, s.params)["cnt"]
    return cnt.numpy()


def test_density_alpha_divergence_pass(box):
    jout = jdfsph.density_alpha_divergence(box.jp, box.jenv, box.jsl,
                                           box.jparams)
    cnt = _check_dad(box, jout)
    vs = slab_pack(box.jenv, {"v": box.jp.vel})["v"]
    _, jc = jdfsph._divergence_sum(box.jp, box.jp.vel, vs, box.jenv, box.jsl,
                                   box.jparams, with_count=True)
    np.testing.assert_array_equal(cnt[box.fluid], box.j(jc)[box.fluid])


def test_density_alpha_divergence_vs_pallas_dma():
    """The same pass against the TPU kernel itself (pair_dma, Pallas
    interpret mode) on a tiny scene."""
    cfg = box_config()
    cfg["Configuration"]["domainEnd"] = [0.24, 0.24, 0.24]
    cfg["FluidBlocks"][0].update(start=[0.08, 0.08, 0.08],
                                 end=[0.14, 0.14, 0.14])
    s = Setup(cfg, pair_backend="pallas_dma")
    assert int(s.jenv.overflow) == 0
    jout = jdfsph.density_alpha_divergence(s.jp, s.jenv, s.jsl, s.jparams)
    _check_dad(s, jout)


def test_rigid_volume_pass():
    js, jst, ts, _ = load_both(box_config(), pair_block=64, pair_chunk=32)
    jstate, jenv = jsim.Plumbing.neighbor_prep(jst, js.params,
                                               exact_sort=True)
    jp = jstate.particles
    # the JAX side sums over its fixed-K list: K must not have cut anything
    cells = jnbl.flat_cell_ids(jp.pos, jp.material != 0, js.params)
    nb = jnbl.build_neighbors(jp.pos, cells, js.params)
    assert int(nb.k_overflow) == 0 and int(nb.cell_overflow) == 0
    j = jcommon.compute_rigid_volume_fixedk(jp, js.params)
    tstate = bridge.state_from_numpy(flatten_jax_state(jstate), ts.params)
    tstate, cells_t, perm = tsim.sort_state(tstate, ts.params)
    env = tsim.pairs.make_pair_env(cells_t, tstate.particles.material == 1,
                                   ts.params)
    t = tcommon.compute_rigid_volume_fixedk(tstate.particles, env, ts.params)
    rigid = t.material.numpy() == 2
    assert rigid.sum() > 0
    perm = perm.numpy()
    for field in ("rest_volume", "mass"):
        assert_pass_close(getattr(t, field).numpy()[rigid],
                          np.asarray(getattr(j, field))[perm][rigid], field)

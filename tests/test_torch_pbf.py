"""The port's PBF step and its three pair passes against the JAX package, 3D.

Both packages load one scene; the JAX package prepares (sorts) it, the
bridge carries the state to the port row for row, and the port sorts it by
its own cell ids (``perm``). Velocities and the moved positions of a PBF
iteration (the sorted positions plus a seeded shift of the fluid rows) are
made with numpy. Each pass runs on the moved positions over the environment
of the sort, in both packages, under both of the port's engines (their plain
versions):

- ``pbf_density``, ``pbf_lambda`` and ``pbf_fix`` (the port's pass fed the
  JAX package's result of the pass before it), and ``nonpressure`` under the
  poly6 kind at the sorted positions; the neighbour counts at the moved
  positions equal;
- on the domain-box scene (static walls: the rigid branches of lambda and
  the position fix) and on ``test_solvers.py``'s 3D dam break (PBF,
  ``pbfCorrK`` 0).

The JAX side runs with ``pair_block=1``: its slab executor then takes each
row's candidates from the 27 cells around its cell at the sort, the
step-start grid that the port's engines walk (``solvers/pbf.py``), so the two
agree pair for pair at any moved positions. With the JAX package's own block
size its window admits more pairs on moved positions; the candidacy test
counts them, iteration by iteration of real steps.

The steps: tests/test_torch_pbf_steps.py.

Tolerance of a pass: max|a - b| <= 2e-5 * max(1, max|b|), as
tests/test_torch_pairs.py; counts exact.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_project_tpu import sim as jsim
from sph_project_tpu.ops import pair_exec
from sph_project_tpu.ops.pairs import slab_pack
from sph_project_tpu.solvers import common as jcommon
from sph_project_tpu.solvers import pbf as jpbf

from sph_project_tpu_torch import bridge
from sph_project_tpu_torch import sim as tsim
from sph_project_tpu_torch.ops import pair_kernels, pairs
from sph_project_tpu_torch.solvers import common as tcommon
from sph_project_tpu_torch.solvers import pbf as tpbf

from test_solvers import dam_break_cfg
from test_torch_pairs import assert_pass_close
from test_torch_scene import box_config, flatten_jax_state, load_both

ENGINES = pytest.mark.parametrize("engine", ["pallas_dma", "pallas"],
                                  ids=["cell_list", "slab_window"])


def dam_config():
    """tests/test_solvers.py's 3D dam break under PBF: pbfCorrK 0, dt 5e-4."""
    return dam_break_cfg("pbf", dt=5e-4, extra={"pbfCorrK": 0.0}).config


class PbfSetup:
    """A JAX-prepared sorted state, the port's sort of the same rows, and the
    moved positions of one iteration: the sorted positions plus a shift of
    the fluid rows, normal with ``shift * h`` per component."""

    def __init__(self, config, engine="pallas_dma", jax_block=1, shift=0.15,
                 seed=0, **overrides):
        js, jst, ts, tst = load_both(
            config, port_kw=dict(overrides, pair_block=64, pair_backend=engine),
            pair_block=jax_block, pair_chunk=256 if jax_block == 1 else 32,
            **overrides)
        self.jparams, self.params = js.params, ts.params
        jstate = jsim.prepare(jst, js.params)
        n, dim = self.params.n_pad, self.params.dim
        h = self.params.support_radius
        rng = np.random.default_rng(seed)
        vel = rng.normal(0.0, 0.5, (n, dim)).astype(np.float32)
        fluid = np.asarray(jstate.particles.material) == 1
        dx = rng.normal(0.0, shift * h, (n, dim))
        self.jp = jstate.particles.replace(vel=vel)
        self.jrigid = jstate.rigid
        self.jenv = jstate.cached_neighbors
        self.jsl = jcommon.particle_slabs(self.jenv, self.jp,
                                          jcommon.STATIC_SLAB_KEYS)
        self.x = (np.asarray(self.jp.pos)
                  + np.where(fluid[:, None], dx, 0.0)).astype(np.float32)
        flat = flatten_jax_state(jstate)
        flat["particles.vel"] = vel
        tstate = bridge.state_from_numpy(flat, self.params)
        tstate, cells, perm = tsim.sort_state(tstate, self.params)
        self.perm = perm.numpy()
        self.tp = tstate.particles
        self.trigid = tstate.rigid
        self.fluid = self.tp.material == 1
        self.tenv = tsim.build_env(
            cells, tsim.produces_output(self.tp, self.trigid, self.params),
            self.params)
        self.tpm = self.tp.replace(pos=torch.from_numpy(self.x[self.perm]))

    def j(self, x):
        """A JAX per-row output in the port's row order."""
        return np.asarray(x)[self.perm]

    def t(self, x):
        """A JAX per-row array as a port tensor in the port's row order."""
        return torch.from_numpy(np.ascontiguousarray(self.j(x)))

    def jax_passes(self):
        """The JAX package's density, lambda and position fix at the moved
        positions, each fed its own pass before."""
        xs = slab_pack(self.jenv, {"x": self.x})["x"]
        args = (self.jenv, self.jsl, self.jparams)
        dens = jpbf.compute_density_moving(self.jp, self.x, xs, *args)
        lam = jpbf.compute_lambda(self.jp, dens, self.x, xs, *args)
        ls = slab_pack(self.jenv, {"l": lam})["l"]
        dx = jpbf.fix_position(self.jp, lam, ls, dens, self.x, xs, *args)
        return dens, lam, dx

    def jax_counts(self):
        """Neighbours within h at the moved positions, per row, through the
        JAX package's executor."""
        def kern(cx):
            _, d2, mask = cx.geometry(pos_blk="x", pos_slab="x")
            return {"n": cx.sum(jnp.ones_like(d2), mask)}

        xs = slab_pack(self.jenv, {"x": self.x})["x"]
        return pair_exec.run(kern, self.jenv, {"x": xs},
                             {"pos": self.jp.pos, "x": self.x},
                             self.jparams)["n"]

    def port_counts(self):
        return pair_kernels.run(
            "pbf_density", self.tenv,
            {"pos": self.tpm.pos, "rest_volume": self.tpm.rest_volume},
            self.params, produce=self.fluid, flags=pair_kernels.COUNT)["cnt"]


def check_passes(s: PbfSetup):
    """The three PBF passes and nonpressure@kind of the port against the JAX
    package's on one setup."""
    jd, jl, jdx = s.jax_passes()
    f = s.fluid.numpy()
    td = tpbf.compute_density_moving(s.tpm, s.tenv, s.params, s.fluid)
    assert_pass_close(td.numpy()[f], s.j(jd)[f], "pbf density")
    tl = tpbf.compute_lambda(s.tpm, s.t(jd), s.tenv, s.params, s.fluid)
    assert np.abs(np.asarray(jl)).max() > 0
    assert_pass_close(tl.numpy(), s.j(jl), "pbf lambda")
    tdx = tpbf.fix_position(s.tpm, s.t(jl), s.tenv, s.params, s.fluid)
    assert np.abs(np.asarray(jdx)).max() > 0
    assert_pass_close(tdx.numpy(), s.j(jdx), "pbf position fix")
    jc = s.j(s.jax_counts())
    tc = s.port_counts().numpy()
    assert tc[f].sum() > 0
    np.testing.assert_array_equal(tc[f], jc[f])
    ja, _, _ = jcommon.nonpressure_fused(s.jp, s.jrigid, s.jenv, s.jsl,
                                         s.jparams)
    ta, _, _ = tcommon.nonpressure_fused(s.tp, s.trigid, s.tenv, s.params)
    assert np.abs(np.asarray(ja)).max() > 0
    assert_pass_close(ta.numpy(), s.j(ja), "nonpressure")


@ENGINES
def test_passes_walled_box(engine):
    s = PbfSetup(box_config("pbf"), engine)
    assert s.params.kernel_type == "poly6" and s.params.has_rigid
    check_passes(s)


@ENGINES
def test_passes_dam_break(engine):
    s = PbfSetup(dam_config(), engine)
    assert s.params.pbf_corr_k == 0.0
    check_passes(s)


def test_passes_cubic_kind():
    """PBF under the cubic kernel (a PBF method override on a scene of the
    cubic spline, as ``load_scene(..., simulation_method="pbf")`` gives in
    both packages): the distance forms of the cubic spline, s_corr on."""
    s = PbfSetup(box_config(), simulation_method="pbf")
    assert s.params.kernel_type == "cubic" and s.params.pbf_corr_k > 0
    check_passes(s)


def test_fix_s_corr_term():
    """The position fix with s_corr on (the default k 0.001) on the walled
    box, under the slab-window engine."""
    cfg = box_config("pbf")
    s = PbfSetup(cfg, "pallas", shift=0.05, seed=3)
    assert s.params.pbf_corr_k == 0.001
    _, jl, jdx = s.jax_passes()
    tdx = tpbf.fix_position(s.tpm, s.t(jl), s.tenv, s.params, s.fluid)
    assert_pass_close(tdx.numpy(), s.j(jdx), "pbf position fix, s_corr")


# ---- moved-position candidacy ----------------------------------------------

def candidacy_counts(x: torch.Tensor, env: pairs.SlabEnv,
                     fluid: torch.Tensor):
    """At positions ``x`` over ``env`` (its cells and windows from the sort):
    (pairs of a fluid row within h, those outside the row's 3^dim step-start
    cells, those outside the cells but inside the JAX slab executor's
    row-matched window of the row's block)."""
    n = x.shape[0]
    gx, gy, gz = pairs.grid3(env.grid)
    cells = env.cells.long()
    cz, cy, cx = cells % gz, (cells // gz) % gy, cells // gz // gy
    live = cells < gx * gy * gz
    idx = torch.arange(n)
    tot = miss = extra = 0
    for i in torch.nonzero(fluid).flatten().split(512):
        d2 = ((x[i][:, None, :] - x[None, :, :]) ** 2).sum(-1)
        near = (d2 < env.dh2) & live[None] & (idx[None] != i[:, None])
        ddx, ddy = cx[None] - cx[i][:, None], cy[None] - cy[i][:, None]
        rowm = (ddx.abs() <= 1) & (ddy.abs() <= 1)
        sten = rowm & ((cz[None] - cz[i][:, None]).abs() <= 1)
        seg = ((ddx + 1) * 3 + (ddy + 1) if env.dim == 3 else ddx + 1)
        seg = seg.clamp(0, env.starts.shape[1] - 1)
        b = (i // env.block)[:, None].expand_as(seg)
        ws = env.starts.long()[b, seg]
        win = rowm & (idx[None] >= ws) & (idx[None] < ws + env.lens.long()[b, seg])
        tot += int(near.sum())
        miss += int((near & ~sten).sum())
        extra += int((near & win & ~sten).sum())
    return tot, miss, extra


def record_candidacy(config, steps, block=64, **overrides):
    """The counts of every iteration of ``steps`` PBF steps of the port (slab
    engine of ``block`` rows, the JAX package's window), in order."""
    from sph_project_tpu_torch.scene import load_scene
    from sph_project_tpu_torch.utils.config import SimConfig
    sc, st = load_scene(config=SimConfig(config=config), pair_block=block,
                        pair_backend="pallas", **overrides)
    sim = tsim.Simulation(sc, st, device="cpu")
    log = []
    orig = tpbf.compute_density_moving

    def spy(p, env, params, produce):
        log.append(candidacy_counts(p.pos, env, produce))
        return orig(p, env, params, produce)

    tpbf.compute_density_moving = spy
    try:
        for _ in range(steps):
            sim.step()
    finally:
        tpbf.compute_density_moving = orig
    return log


def test_candidacy_dam_break():
    """On the 3D dam break the iterations move particles farther than the
    step-start stencil reaches: in the first step (a) 0 in the first two
    iterations and 1.1-1.6% of the pairs within h after (measured 304, 776,
    544 of 48,618-50,118), about half of them (b) in the JAX package's window
    (137, 356, 246); in the second step 1-5% of the pairs, at most a quarter
    in the window. Per-pass equality with the JAX package's own block holds
    where (b) is 0."""
    log = record_candidacy(dam_config(), 2)
    for k, (tot, miss, extra) in enumerate(log):
        print(f"iteration {k}: {tot} pairs within h, (a) {miss} outside the "
              f"step-start stencil, (b) {extra} of them in the JAX window")
        assert 0 <= extra <= miss < 0.05 * tot
    assert log[0][1] == log[1][1] == 0
    assert all(m > 0 for _, m, _ in log[2:])
    assert all(e > 0 for _, _, e in log[2:5])

"""Steps of DFSPH, WCSPH, PCISPH and IISPH in 2D against the JAX package,
on the 2D domain box of tests/test_torch_kinds.py (a block thrown onto the
floor of a box of static walls, cubic spline); DFSPH also with implicit
viscosity 500. (At the 3D tests' 2000 the CG of this 2D box stalls in its
second step: its float32 residual stays above cg_tol = 1e-6 and the solve
runs to cg_max_iter = 1000 iterations, where rounding decides the result,
1.2e-5 m from the same state after one step; at 500 every solve converges,
in 21-24 iterations.) ``pbf_2d.json`` under these methods (2D, poly6):
tests/test_torch_kinds_steps_pbf2d.py; poly6 in 3D and PBF with implicit
viscosity: tests/test_torch_kinds_steps_poly6.py.

Both packages load the scene with the method overridden and step it on the
CPU, the JAX ``Simulation`` through its CPU executor, the port's
``Simulation(device="cpu")`` through the plain versions of its kernels
(cell-list engine; DFSPH also slab-window). Every step: the same
diagnostics keys, the solver's iteration counts (and DFSPH's divergence
iterations) equal, and every fluid particle within 1e-5 of one of the JAX
package's (nearest-neighbour match).
"""
import numpy as np
import pytest

from sph_project_tpu import sim as jsim

from sph_project_tpu_torch import sim as tsim
from sph_project_tpu_torch.solvers import viscosity_cg as tvisc

from test_torch_dfsph import fluid_pos, nn_dist
from test_torch_kinds import box2d_config, implicit
from test_torch_scene import load_both

STEPS = 20
NN_TOL = 1e-5
WARM = dict(dfsph_warm_start=True, dfsph_warm_start_div=True)


def run_steps(config, steps=STEPS, nn_steps=STEPS, late_tol=None,
              density_rtol=None, **overrides):
    """``steps`` steps of ``config`` under ``overrides`` in both packages;
    iteration counts equal every step, the fluid within NN_TOL for the first
    ``nn_steps`` steps, then within ``late_tol`` with the mean density
    within ``density_rtol``. Returns the iteration counts and the drifts."""
    js, jst, ts, tst = load_both(config, port_kw=dict(overrides, pair_block=64),
                                 pair_block=64, pair_chunk=32, **overrides)
    jax_sim = jsim.Simulation(js, jst)
    port = tsim.Simulation(ts, tst, device="cpu")
    iters, drift = [], []
    for s in range(steps):
        jd, td = jax_sim.step(), port.step()
        assert set(td) == set(jd), f"step {s}: diagnostics keys differ"
        it = tuple(int(td[k]) for k in ("solver_iters", "div_iters")
                   if k in jd)
        assert it == tuple(int(jd[k]) for k in ("solver_iters", "div_iters")
                           if k in jd), f"step {s}: iterations {it}"
        for k in ("neighbor_overflow", "sort_overflow", "fluid_num"):
            assert int(td[k]) == int(jd[k]), f"step {s}: {k}"
        tp, jp = port.state.particles, jax_sim.state.particles
        a = fluid_pos(tp.pos.numpy(), tp.material.numpy())
        b = fluid_pos(jp.pos, jp.material)
        assert a.shape == b.shape and np.isfinite(a).all()
        d = float(nn_dist(a, b).max())
        if s < nn_steps:
            assert d < NN_TOL, f"step {s}: drift {d:.2e}"
        else:
            assert d < late_tol, f"step {s}: drift {d:.2e}"
            np.testing.assert_allclose(float(td["density_avg"]),
                                       float(jd["density_avg"]),
                                       rtol=density_rtol)
        iters.append(it)
        drift.append(d)
    return iters, drift


BOX_CASES = {"dfsph": {}, "dfsph_warm": WARM, "wcsph": {}, "pcisph": {},
             "iisph": {}, "dfsph_slab": dict(pair_backend="pallas"),
             "dfsph_implicit": {}}


@pytest.mark.parametrize("case", BOX_CASES)
def test_box2d_steps(case):
    """The 2D box per method; ``dfsph_implicit`` with implicit viscosity
    500 (module docstring)."""
    method = case.split("_")[0]
    config = box2d_config(method)
    if case.endswith("implicit"):
        config = implicit(config, 500.0)
    iters, _ = run_steps(config, **BOX_CASES[case])
    if case.endswith("implicit"):
        assert tvisc.last_solve["cg_iters"] > 1
    elif method != "wcsph":
        # the block lands on the floor within the 20 steps: the solvers work
        assert max(max(i) for i in iters) > 1

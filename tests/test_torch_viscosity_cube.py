"""Implicit viscosity with a dynamic body, the port against the JAX package.

tests/test_torch_rigid_steps.py's cube dropped into a pool, with implicit
viscosity 50 (8-9 CG iterations a step): 20 DFSPH steps through both
packages under each engine, with that file's checks and bars: iteration
counts equal every step, the body's com and rotation within 1e-5 and its
velocity and angular velocity within 1e-4 relative every step, the fluid
within 1e-5 after the run. The viscosity wrench on the cube comes from the
standard viscosity at the CG solution (``nonpressure+rigid`` in the port).
"""
import pytest

from sph_project_tpu_torch.solvers import viscosity_cg as tvisc

from test_torch_rigid_steps import (cube_pool_config, cube_small,  # noqa: F401
                                    run_coupled)


@pytest.mark.parametrize("overrides", [{}, dict(pair_backend="pallas")],
                         ids=["cell_list", "slab_window"])
def test_cube_pool_implicit_matches_jax(cube_small, overrides):  # noqa: F811
    cfg = cube_pool_config(cube_small, "dfsph")
    cfg["Configuration"].update(viscosityMethod="implicit", viscosity=50.0,
                                viscosity_b=50.0)
    _, port, _ = run_coupled(cfg, 20, **overrides)
    assert port.params.viscosity_method == "implicit"
    assert tvisc.last_solve["cg_iters"] > 1
    # the cube has met the pool: the viscous fluid slowed it down
    vy = float(port.state.rigid.vel[1, 1])
    assert -1.5 < vy < -0.05

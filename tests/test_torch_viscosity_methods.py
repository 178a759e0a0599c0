"""Implicit viscosity under the other pressure solvers, the port against the
JAX package: the domain-box scene of tests/test_torch_viscosity.py at
viscosity 50 for 10 steps with DFSPH warm-started (the warm correction then
runs as a pass of its own, not inside the non-pressure pass), WCSPH, PCISPH
and IISPH, under the cell-list engine. Iteration counts equal every step and
the fluid within 1e-5 after the run, as tests/test_torch_dfsph.py."""
import numpy as np
import pytest

from sph_project_tpu import sim as jsim
from sph_project_tpu_torch import sim as tsim

from test_torch_dfsph import fluid_pos, nn_dist
from test_torch_scene import load_both
from test_torch_viscosity import implicit_config


@pytest.mark.parametrize("overrides", [
    dict(dfsph_warm_start=True, dfsph_warm_start_div=True),
    dict(simulation_method="wcsph"), dict(simulation_method="pcisph"),
    dict(simulation_method="iisph")],
    ids=["dfsph_warm", "wcsph", "pcisph", "iisph"])
def test_implicit_viscosity_under_each_method(overrides):
    js, jst, ts, tst = load_both(implicit_config(50.0),
                                 port_kw=dict(overrides, pair_block=64),
                                 pair_block=64, pair_chunk=32, **overrides)
    jax_sim = jsim.Simulation(js, jst)
    port = tsim.Simulation(ts, tst, device="cpu")
    for s in range(10):
        jd = jax_sim.step()
        td = port.step()
        assert set(td) == set(jd), f"step {s}: diagnostics keys differ"
        for k in ("solver_iters", "div_iters", "fluid_num"):
            if k in jd:
                assert int(td[k]) == int(jd[k]), \
                    f"step {s}: {k} {int(td[k])} vs JAX {int(jd[k])}"
    jp, tp = jax_sim.state.particles, port.state.particles
    a = fluid_pos(tp.pos.numpy(), tp.material.numpy())
    b = fluid_pos(jp.pos, jp.material)
    assert a.shape == b.shape and np.isfinite(a).all()
    d = nn_dist(a, b)
    assert d.max() < 1e-5, f"trajectory drift {d.max():.2e}"

"""The port's spatial decomposition against the JAX package's.

The same case runs through the port's ``spatial_step_fn`` in D = 4 gloo
ranks (``parallel/launch.py``) and through the JAX package's
``spatial_step_fn`` on the first 4 devices of the 8-device virtual CPU mesh
(tests/conftest.py), 3 steps each. The two packages add float32 sums in
other orders (the JAX executor's slab windows against the port's cell
runs), so their fluid agrees within 1e-5 (nearest-neighbour match, the bar
of tests/test_torch_dfsph.py), the iteration counts are equal every step,
and neither reports a neighbour overflow; body states within 1e-5.
"""
import jax
import numpy as np
import pytest
from scipy.spatial import cKDTree

from test_torch_dfsph import fluid_pos
from test_torch_spatial import ENGINE, cube_config, dam, spatial_runs

from sph_project_tpu import sim as jsim
from sph_project_tpu.parallel import spatial as jspatial
from sph_project_tpu.scene import load_scene as jax_load_scene
from sph_project_tpu.utils.config import SimConfig as JaxSimConfig

D = 4
STEPS = 3


def cases(tmp_dir):
    """name -> (configuration, load_scene overrides)."""
    return {
        "dfsph_cold": (dam(), {}),
        "dfsph_warm": (dam(dfsphWarmStart=True, dfsphWarmStartDiv=True), {}),
        "wcsph": (dam("wcsph"), {}),
        "cube": (cube_config(tmp_dir), {}),
        "implicit": (dam(viscosityMethod="implicit", viscosity=50.0,
                         viscosity_b=10.0), {}),
    }


def jax_spatial(config, overrides):
    """The JAX package's spatial step on D devices: its final state and the
    per-step diagnostics."""
    scene, state = jax_load_scene(config=JaxSimConfig(config=config),
                                  **ENGINE, **overrides)
    params = scene.params
    mesh = jspatial.make_mesh(D)
    state = jax.jit(lambda s: jsim.prepare(s, params))(state)
    state = jspatial.shard_state(state.replace(cached_neighbors=None), mesh,
                                 params)
    step = jspatial.spatial_step_fn(params, mesh, state)
    diags = []
    for _ in range(STEPS):
        state, diag = step(state)
        diags.append({k: np.asarray(v).item() for k, v in diag.items()})
    return state, diags


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case through both packages' spatial steps (the port's ranks run
    while the JAX package runs here)."""
    tmp = str(tmp_path_factory.mktemp("spatial_jax"))
    all_cases = cases(tmp)
    wait = spatial_runs([dict(name=name, config=cfg,
                              overrides=dict(ENGINE, **ov), steps=STEPS)
                         for name, (cfg, ov) in all_cases.items()], (D,), tmp)
    out = {name: jax_spatial(cfg, ov) for name, (cfg, ov) in all_cases.items()}
    port = wait()
    return {name: (out[name], port[name, D]) for name in all_cases}


@pytest.mark.parametrize("name", ["dfsph_cold", "dfsph_warm", "wcsph", "cube",
                                  "implicit"])
def test_spatial_matches_jax_spatial(runs, name):
    (jstate, jdiags), port = runs[name]
    rows, tdiags = port["rows"], port["ranks"][0]["diags"]
    assert len(tdiags) == len(jdiags) == STEPS
    for td, jd in zip(tdiags, jdiags):
        assert td["neighbor_overflow"] == 0 and jd["neighbor_overflow"] == 0
        for k in ("solver_iters", "div_iters"):
            if k in jd:
                assert td[k] == jd[k], (k, td[k], jd[k])
    a = fluid_pos(rows["particles.pos"], rows["particles.material"])
    b = fluid_pos(jstate.particles.pos, jstate.particles.material)
    assert a.shape == b.shape and a.shape[0] > 0
    drift = float(cKDTree(b).query(a)[0].max())
    assert drift < 1e-5, f"fluid drift {drift:.2e}"
    if name == "cube":
        for k in ("com", "vel", "omega"):
            np.testing.assert_allclose(rows[f"rigid.{k}"],
                                       np.asarray(getattr(jstate.rigid, k)),
                                       rtol=0, atol=1e-5)

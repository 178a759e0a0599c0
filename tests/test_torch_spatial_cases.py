"""The spatial decomposition on paths tests/test_torch_spatial.py does not
reach, against the single-device port.

The cases, each at D = 2 and 4 (gloo over the CPU, one launch per D, every
case in it), with tests/test_torch_spatial.py's engine and bars (sorted
positions bit-equal, iteration counts and the CG's equal every step,
``neighbor_overflow`` and each rank's shortfall 0, a body's com bit-equal
and its velocities within 1e-6):

- ``squeeze``: tests/test_rigid.py's three-box squeeze (two cubes close on
  a third at 0.8 m/s in zero gravity, WCSPH, no fluid) for 45 steps; the
  cubes touch from about step 38, so the all-reduced contact tables carry
  real pairs between bodies, several channels at once;
- ``pbf_2d_dfsph``: ``pbf_2d.json`` under DFSPH for 20 steps: the 2D walk
  of the halo rows and the 2D branch of the shortfall's stencil reach;
- ``emitter``: ``buckling_emitter_small.json`` (implicit viscosity, a
  static body, the emitter's placeholders above ``gravitationUpper``) for
  4 steps, the fluid count equal to one device's every step. The scene's
  sheet is seeded on planes 0.03 m apart, one of them at 2.53 m, and falls
  at 2.2 m/s: with ``gravitationUpper`` at 2.5 that plane would turn fluid
  in step 14. The case puts ``gravitationUpper`` at 2.525, so the plane
  turns fluid in step 3 and the fluid count grows under the
  decomposition within four steps; nothing else of the scene changes.
"""
import json
import os

import numpy as np
import pytest

from test_torch_scene import ROOT  # noqa: F401  (one torch thread a process)
from test_rigid import write_cube_obj
from test_torch_rigid_steps import squeeze_config
from test_torch_spatial import (COUNTS, ENGINE, SIZES, single_device,
                                sorted_fluid, spatial_runs)

SCENES = os.path.join(ROOT, "data", "scenes")


def scene_config(name: str) -> dict:
    with open(os.path.join(SCENES, name)) as f:
        return json.load(f)


def emitter_config() -> dict:
    cfg = scene_config("buckling_emitter_small.json")
    cfg["Configuration"]["gravitationUpper"] = 2.525
    return cfg


def cases(tmp_dir):
    """name -> (configuration, load_scene overrides, steps)."""
    cube = write_cube_obj(os.path.join(tmp_dir, "cube.obj"))
    return {
        "squeeze": (squeeze_config(cube), {}, 45),
        "pbf_2d_dfsph": (scene_config("pbf_2d.json"),
                         dict(simulation_method="dfsph"), 20),
        "emitter": (emitter_config(), {}, 4),
    }


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = str(tmp_path_factory.mktemp("spatial_cases"))
    all_cases = cases(tmp)
    specs = [dict(name=name, config=cfg, overrides=dict(ENGINE, **ov),
                  steps=steps) for name, (cfg, ov, steps) in all_cases.items()]
    wait = spatial_runs(specs, SIZES, tmp)
    out = {name: single_device(cfg, ov, steps)
           for name, (cfg, ov, steps) in all_cases.items()}
    out.update(wait())
    return out


@pytest.mark.parametrize("D", SIZES)
@pytest.mark.parametrize("name", ["squeeze", "pbf_2d_dfsph", "emitter"])
def test_spatial_case_matches_single_device(runs, name, D):
    state, diags, cg = runs[name]
    res = runs[name, D]
    rows, rank0 = res["rows"], res["ranks"][0]
    p = state.particles
    a = sorted_fluid(p.pos.numpy(), p.material.numpy())
    b = sorted_fluid(rows["particles.pos"], rows["particles.material"])
    assert a.shape == b.shape and a.shape[0] > 0
    np.testing.assert_array_equal(a, b)
    assert len(rank0["diags"]) == len(diags)
    for d1, d2 in zip(diags, rank0["diags"]):
        assert d2["neighbor_overflow"] == 0
        assert d1["fluid_num"] == d2["fluid_num"]
        for k in COUNTS:
            if k in d1:
                assert d1[k] == d2[k], (k, d1[k], d2[k])
    for r in res["ranks"]:
        assert r["diags"] == rank0["diags"]
        assert r["H"] == rank0["H"]
    assert [r["shortfall"] for r in res["ranks"]] == [0] * D
    assert rank0["cg_iters"] == cg
    if name == "squeeze":
        np.testing.assert_array_equal(state.rigid.com.numpy(),
                                      rows["rigid.com"])
        np.testing.assert_allclose(state.rigid.vel.numpy(),
                                   rows["rigid.vel"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(state.rigid.omega.numpy(),
                                   rows["rigid.omega"], rtol=0, atol=1e-6)
        # the cubes met: the middle one, at rest until then, was pushed,
        # and the outer ones lost speed
        v = rows["rigid.vel"]
        assert np.abs(v[1]).max() > 0
        assert v[0, 0] < 0.8 and v[2, 0] > -0.8
    if name == "pbf_2d_dfsph":
        assert a.shape[1] == 2
    if name == "emitter":
        assert diags[-1]["fluid_num"] > diags[0]["fluid_num"]

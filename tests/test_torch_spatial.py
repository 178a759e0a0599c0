"""The port's spatial decomposition against the single-device port.

``parallel/spatial.py`` runs each case in D = 2 and D = 4 processes
(``parallel/launch.py``: gloo over the CPU, one torch thread a rank), on
tests/test_spatial.py's dam (``pair_block=64, pair_chunk=32``); the same
case runs on one device in this process. After the steps, with their
reasons:

- the sorted fluid positions are bit-equal: every rank's rows take their
  candidates in the order one device takes them, so each pair sum is the
  single device's (PBF for one step only: see its case);
- the iteration counts (and the CG's) are equal every step, and
  ``neighbor_overflow`` is 0: the halo held every neighbour;
- a body's com is bit-equal, its velocity and angular velocity within 1e-6:
  the wrenches are all-reduced, so they add in another order (the bar of
  tests/test_spatial.py:145-153).

The ranks start once per module (one launch per D, all cases in it); each
case and D is then a test of its own.
"""
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

from test_torch_scene import ROOT  # noqa: F401  (one torch thread a process)
from test_spatial import dam_cfg

from sph_project_tpu_torch import sim as tsim
from sph_project_tpu_torch.parallel import launch
from sph_project_tpu_torch.solvers import viscosity_cg

SIZES = (2, 4)
ENGINE = dict(pair_block=64, pair_chunk=32)


def dam(method="dfsph", **conf):
    """tests/test_spatial.py's dam under ``method``, with ``conf`` added to
    its Configuration."""
    cfg = dam_cfg(method).config
    cfg["Configuration"].update(conf)
    return cfg


def cube_config(tmp_dir):
    """tests/test_spatial.py:118-154's scene: a dynamic cube dropped into a
    shallow pool."""
    from test_rigid import write_cube_obj
    cube = write_cube_obj(os.path.join(tmp_dir, "cube.obj"), size=0.08)
    cfg = dam("dfsph")
    cfg["FluidBlocks"][0]["end"] = [0.5, 0.12, 0.4]
    cfg["RigidBodies"] = [{
        "objectId": 1, "geometryFile": cube,
        "translation": [0.3, 0.16, 0.25], "rotationAxis": [0, 1, 0],
        "rotationAngle": 0.0, "scale": [1, 1, 1], "velocity": [0, -0.2, 0],
        "density": 400.0, "color": [255, 255, 255], "isDynamic": True,
        "entryTime": -1.0}]
    return cfg


def entry_config():
    """tests/test_spatial.py:225-241's dam: WCSPH with a second block that
    enters at t = 1 ms (in step 3)."""
    cfg = dam("wcsph")
    cfg["FluidBlocks"].append({
        "objectId": 1, "start": [0.1, 0.3, 0.1], "end": [0.2, 0.4, 0.2],
        "translation": [0, 0, 0], "scale": [1, 1, 1],
        "velocity": [0, -0.5, 0], "density": 1000.0,
        "color": [200, 50, 50], "entryTime": 0.001})
    return cfg


def cases(tmp_dir):
    """name -> (configuration, load_scene overrides, steps)."""
    cube = cube_config(tmp_dir)
    return {
        "dfsph_cold": (dam(), {}, 3),
        "dfsph_cold_slab": (dam(), dict(pair_backend="pallas"), 3),
        "dfsph_warm_adaptive": (dam(dfsphWarmStart=True,
                                    dfsphWarmFactorHi=1.0), {}, 3),
        "dfsph_warm_div": (dam(dfsphWarmStart=True, dfsphWarmStartDiv=True),
                           {}, 3),
        "wcsph": (dam("wcsph"), {}, 3),
        "pcisph": (dam("pcisph"), {}, 3),
        "iisph": (dam("iisph"), {}, 3),
        # PBF on this dam (the reference's constants in 3D: particles move
        # several cells a step at up to 2 rho0) for one step. From step 2 on
        # the halo of the seeded plane population x 1.5 misses rows (103 at
        # D = 2, reported in neighbor_overflow; a halo_plane_max of 1200
        # holds them); and at D = 4 the plain passes' float32 sums differ from
        # one device's in the last bit (9.9e-6 after two steps, 2e-2 after
        # three): torch.sum over a row's candidates zero-padded to its
        # chunk's width adds them in an order that depends on that width,
        # which depends on the other rows of the chunk, and the ranks chunk
        # other rows than one device. A sum whose order ignores the padding
        # made the three steps bit-equal at D = 2 and 4, but moves the
        # single-device path off the JAX package where the plain versions'
        # order is held to it (tests/test_torch_kinds_steps_pbf2d.py). The
        # kernels on the card add a row's terms in candidate order alone.
        "pbf": (dam("pbf"), dict(pair_block=1), 1),
        "cube": (cube, {}, 3),
        "cube_shape_matching": (cube, dict(rigid_solver="shape_matching"), 3),
        "implicit": (dam(viscosityMethod="implicit", viscosity=50.0,
                         viscosity_b=10.0), {}, 3),
        "entry": (entry_config(), {}, 4),
    }


def single_device(config, overrides, steps):
    """The case on one device (CPU): its state and per-step diagnostics and
    CG iterations."""
    case = dict(config=config, overrides=dict(ENGINE, **overrides))
    scene, state = launch.load_case(case)
    sim = tsim.Simulation(scene, state, device="cpu")
    diags, cg = [], []
    for _ in range(steps):
        diags.append({k: v.item() for k, v in sim.step().items()})
        if scene.params.viscosity_method == "implicit":
            cg.append(int(viscosity_cg.last_solve["cg_iters"]))
    return sim.state, diags, cg


def spatial_runs(specs, sizes, tmp):
    """Start the ranks of each size in ``sizes`` at once, each running every
    case of ``specs`` (``launch.run_cases``); returns a function that waits
    for them and gives {(name, D): ``launch.gather_results``}."""
    pool = ThreadPoolExecutor(len(sizes))
    futures = {D: pool.submit(
        launch.launch, "sph_project_tpu_torch.parallel.launch:run_cases", D,
        dict(cases=specs, out_dir=os.path.join(tmp, f"d{D}", "out")),
        os.path.join(tmp, f"d{D}"), device="cpu", timeout=600)
        for D in sizes}

    def wait():
        for f in futures.values():
            f.result()
        pool.shutdown()
        return {(c["name"], D): launch.gather_results(
            os.path.join(tmp, f"d{D}", "out"), c["name"], D)
            for c in specs for D in sizes}

    return wait


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Every case at each D (in the ranks) and on one device (here, in the
    meantime)."""
    tmp = str(tmp_path_factory.mktemp("spatial"))
    all_cases = cases(tmp)
    specs = [dict(name=name, config=cfg, overrides=dict(ENGINE, **ov),
                  steps=steps) for name, (cfg, ov, steps) in all_cases.items()]
    wait = spatial_runs(specs, SIZES, tmp)
    out = {name: single_device(cfg, ov, steps)
           for name, (cfg, ov, steps) in all_cases.items()}
    out.update(wait())
    return out


def sorted_fluid(pos, material):
    r = np.asarray(pos)[np.asarray(material) != 0]
    return r[np.lexsort(r.T)]


COUNTS = ("solver_iters", "div_iters")
CASES = ("dfsph_cold", "dfsph_cold_slab", "dfsph_warm_adaptive",
         "dfsph_warm_div", "wcsph", "pcisph", "iisph", "pbf", "cube",
         "cube_shape_matching", "implicit", "entry")


@pytest.mark.parametrize("D", SIZES)
@pytest.mark.parametrize("name", CASES)
def test_spatial_matches_single_device(runs, name, D):
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
        for k in COUNTS:
            if k in d1:
                assert d1[k] == d2[k], (k, d1[k], d2[k])
    for r in res["ranks"]:
        assert r["diags"] == rank0["diags"]      # global: alike on each rank
        assert r["H"] == rank0["H"]
    # each rank's shortfall at the state the steps left, which the next step
    # would see
    shortfall = [r["shortfall"] for r in res["ranks"]]
    if name == "pbf":
        assert sum(shortfall) > 0       # step 2 outgrows the halo: reported
    else:
        assert shortfall == [0] * D
    assert rank0["cg_iters"] == cg
    if "cube" in name:
        np.testing.assert_array_equal(state.rigid.com.numpy(),
                                      rows["rigid.com"])
        np.testing.assert_allclose(state.rigid.vel.numpy(),
                                   rows["rigid.vel"], rtol=0, atol=1e-6)
        np.testing.assert_allclose(state.rigid.omega.numpy(),
                                   rows["rigid.omega"], rtol=0, atol=1e-6)
        assert np.abs(rows["rigid.vel"][1]).max() > 0   # the body moved
    if name == "entry":
        assert (rows["particles.material"] != 0).sum() > \
            (runs["wcsph"][0].particles.material != 0).sum().item()

"""The port's PBF in 2D against the JAX package.

- The three PBF passes and ``nonpressure`` under the poly6 kind, as in
  tests/test_torch_pbf.py (moved positions from a numpy seed, the JAX side
  with ``pair_block=1``, both of the port's engines' plain versions, counts
  exact), on the configuration of ``tests/test_parity.py``'s PBF parity test
  (the reference's own 2D PBF constants: h 1.12, dt 0.05, s_corr on; with a
  viscosity of 0.5 so that the non-pressure pass has sums) and on the
  shipped ``pbf_2d.json`` (1,840 fluid particles, 7,168 rows).
- Steps of that parity configuration in both packages (the JAX package's
  own blocks of 64): every fluid particle within 1e-5 of the JAX package's
  for the first 5 steps (measured 2.4e-7 to 9.5e-6; at dt 0.05 a float32
  rounding difference doubles about every step, 1.3e-5 at step 6), then by
  the JAX test's own bound, 2e-3, after 20 steps (measured 3.4e-4).
- Moved-position candidacy in 2D: on the parity configuration and on
  ``pbf_2d.json`` no pair within h at the moved positions of any iteration
  lies outside the step-start stencil, so (a) and (b) are 0 and the passes
  agree with the JAX package's at its own block size.

Tolerance of a pass: max|a - b| <= 2e-5 * max(1, max|b|); counts exact.
"""
import os

import numpy as np
import pytest

from sph_project_tpu import sim as jsim

from sph_project_tpu_torch import sim as tsim

from test_torch_dfsph import fluid_pos, nn_dist
from test_torch_pbf import ENGINES, PbfSetup, check_passes, record_candidacy
from test_torch_scene import SCENES, _scene_config, load_both

PARITY_STEPS = 5


def parity_config():
    """tests/test_parity.py test_pbf_oracle_parity's configuration."""
    return {"Configuration": {
        "domainStart": [0.0, 0.0], "domainEnd": [40.0, 40.0],
        "addDomainBox": False, "particleRadius": 1.11,
        "supportRadius": 1.12, "particleSpacing": 0.88,
        "density0": 1000, "gravitation": [0.0, -9.81],
        "simulationMethod": "pbf", "viscosityMethod": "standard",
        "viscosity": 0.0, "timeStepSize": 0.05},
        "FluidBlocks": [{"objectId": 1, "start": [10.0, 1.3],
                         "end": [23.0, 5.7], "translation": [0, 0],
                         "scale": [1, 1], "velocity": [0, 0],
                         "density": 1000.0, "color": [50, 100, 200],
                         "entryTime": -1.0}]}


@ENGINES
def test_passes_parity_config(engine):
    s = PbfSetup(parity_config(), engine, viscosity=0.5)
    assert s.params.dim == 2 and s.params.kernel_type == "poly6"
    check_passes(s)


@ENGINES
def test_passes_pbf_2d_scene(engine):
    s = PbfSetup(_scene_config("pbf_2d.json"), engine, viscosity=0.5)
    assert s.params.dim == 2 and s.params.n_pad == 7168
    check_passes(s)


def test_parity_config_steps():
    js, jst, ts, tst = load_both(parity_config(), port_kw=dict(pair_block=64),
                                 pair_block=64, pair_chunk=32)
    jax_sim = jsim.Simulation(js, jst)
    port = tsim.Simulation(ts, tst, device="cpu")
    for s in range(20):
        jd, td = jax_sim.step(), port.step()
        assert set(td) == set(jd)
        tp, jp = port.state.particles, jax_sim.state.particles
        a = fluid_pos(tp.pos.numpy(), tp.material.numpy())
        b = fluid_pos(jp.pos, jp.material)
        assert a.shape == b.shape and np.isfinite(a).all()
        d = nn_dist(a, b).max()
        if s < PARITY_STEPS:
            assert d < 1e-5, f"step {s}: drift {d:.2e}"
    assert d < 2e-3, f"20 steps: drift {d:.2e}"
    np.testing.assert_allclose(float(td["density_avg"]),
                               float(jd["density_avg"]), rtol=2e-3)


@pytest.mark.parametrize("name", ["parity", "pbf_2d.json"])
def test_candidacy_2d(name):
    config = parity_config() if name == "parity" else _scene_config(name)
    log = record_candidacy(config, 2)
    assert len(log) == 10 and all(t > 0 for t, _, _ in log)
    assert all(m == e == 0 for _, m, e in log), log


def test_pbf_2d_scene_loads_and_steps():
    """pbf_2d.json through the port's entry points under both engines: equal
    diagnostics of the two engines' plain versions, the fluid count kept, the
    density of the reference's 2D water."""
    from sph_project_tpu_torch.scene import load_scene
    diags = {}
    for engine in ("pallas_dma", "pallas"):
        sc, st = load_scene(os.path.join(SCENES, "pbf_2d.json"),
                            pair_backend=engine, pair_block=64)
        sim = tsim.Simulation(sc, st, device="cpu")
        diags[engine] = [{k: float(v) for k, v in sim.step().items()}
                         for _ in range(3)]
    for a, b in zip(*diags.values()):
        assert a["fluid_num"] == b["fluid_num"] == 1840
        assert a["solver_iters"] == 5 and a["solver_err"] == 0.0
        np.testing.assert_allclose(a["density_avg"], b["density_avg"],
                                   rtol=1e-5)
        assert 900.0 < a["density_avg"] < 1100.0

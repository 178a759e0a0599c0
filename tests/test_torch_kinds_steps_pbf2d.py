"""``pbf_2d.json`` (2D, poly6: a PBF file keeps its poly6 kernel under an
override of the method) under DFSPH, cold and warm, WCSPH and IISPH against
the JAX package, with tests/test_torch_kinds_steps.py's ``run_steps``.

Its block falls freely for 17 steps of 0.05 s and lands on the domain floor
in step 18 (DFSPH iterates 147 times there). The landing amplifies float32
rounding differences, as the reference's 2D constants do under PBF
(tests/test_torch_pbf_2d.py): every method keeps its iteration counts equal
every step and the fluid within 1e-5 for the first 19 steps (measured at
most 4.8e-6); at step 20 the fluid is held to the JAX PBF parity test's
bound, 2e-3 (measured 8.4e-6 DFSPH, 1.4e-5 WCSPH, 8.9e-4 IISPH), and the
mean density to 1e-3 of the JAX package's.

PCISPH cannot run ``pbf_2d.json`` in either package: its stiffness sums the
kernel gradient over a lattice at 0.97 particle diameters, and at the
scene's spacing (diameter 2.22, h 1.12) that lattice has no point inside
the support radius, so both packages divide by zero, as the last test
checks.
"""
import os

import pytest

from sph_project_tpu.core.params import make_params as jax_make_params
from sph_project_tpu.solvers import pcisph as jpcisph

from sph_project_tpu_torch.scene import load_scene as torch_load_scene
from sph_project_tpu_torch.solvers import pcisph as tpcisph

from test_torch_kinds_steps import WARM, run_steps
from test_torch_scene import SCENES, _scene_config

# steps held to 1e-5, and the bounds of the steps after
PBF_2D_NN_STEPS = 19
PBF_2D_LATE_TOL = 2e-3
PBF_2D_DENSITY_RTOL = 1e-3


@pytest.mark.parametrize("case", ["dfsph", "dfsph_warm", "wcsph", "iisph"])
def test_pbf_2d_scene_steps(case):
    method = case.split("_")[0]
    overrides = dict(simulation_method=method,
                     **(WARM if case.endswith("warm") else {}))
    iters, _ = run_steps(_scene_config("pbf_2d.json"),
                         nn_steps=PBF_2D_NN_STEPS, late_tol=PBF_2D_LATE_TOL,
                         density_rtol=PBF_2D_DENSITY_RTOL, **overrides)
    if method != "wcsph":
        assert max(i[0] for i in iters) > 1, "the block never landed"


def test_pbf_2d_scene_pcisph_divides_by_zero():
    """Both packages' PCISPH stiffness has no lattice point inside the
    support radius at pbf_2d.json's spacing."""
    scene, _ = torch_load_scene(os.path.join(SCENES, "pbf_2d.json"),
                                simulation_method="pcisph")
    params = scene.params
    assert params.particle_diameter * 0.97 > params.support_radius
    kw = dict(dim=2, particle_radius=params.particle_radius,
              support_radius=params.support_radius, dt=params.dt)
    with pytest.raises(ZeroDivisionError):
        jpcisph.compute_pcisph_k(jax_make_params(100, **kw))
    with pytest.raises(ZeroDivisionError):
        tpcisph.compute_pcisph_k(params)

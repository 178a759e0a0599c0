"""Steps against the JAX package: IISPH and DFSPH (through the slab-window
engine) under the poly6 kernel in 3D, as tests/test_torch_kinds_steps_poly6.py,
and PBF with implicit viscosity, whose solve runs in PBF's non-pressure
stage as under the other methods, in both packages with the JAX executor at
``pair_block=1`` (the step-start stencil, tests/test_torch_pbf.py), PBF's 5
iterations every step:

- 2D, tests/test_torch_pbf_2d.py's parity configuration (the reference's 2D
  PBF constants) with viscosity 5: the fluid within 1e-5 for the first 5
  steps, as that file's PBF test, and within its 2e-3 after 20 (measured
  4.0e-6 at step 5, 1.5e-4 at step 20: at dt 0.05 a rounding difference
  doubles about every step);
- 3D, tests/test_solvers.py's dam break under PBF (tests/test_torch_pbf.py
  ``dam_config``) with viscosity 5: one step within 1e-5 (measured 1.9e-6),
  as tests/test_torch_pbf_steps.py holds the 3D PBF step (the reference's
  2D-tuned constants make the 3D flow chaotic after it).
"""
import pytest

from test_torch_kinds import implicit
from test_torch_kinds_steps_poly6 import poly6_box_steps
from test_torch_pbf import dam_config
from test_torch_pbf_2d import parity_config
from test_torch_pbf_steps import run_against_jax

BOX_CASES = {"iisph": {}, "dfsph_slab": dict(pair_backend="pallas")}
PBF_2D_NN_STEPS = 5
PBF_2D_TOL = 2e-3


@pytest.mark.parametrize("case", BOX_CASES)
def test_poly6_box_steps(case):
    poly6_box_steps(case, BOX_CASES)


def test_pbf_implicit_2d_steps():
    params, out = run_against_jax(implicit(parity_config(), 5.0), 20,
                                  jax_block=64)
    assert params.viscosity_method == "implicit" and params.dim == 2
    for s, (_, _, d, _) in enumerate(out):
        assert d < (1e-5 if s < PBF_2D_NN_STEPS else PBF_2D_TOL), \
            f"step {s}: drift {d:.2e}"


def test_pbf_implicit_3d_step():
    config = implicit(dam_config(), 5.0)
    params, out = run_against_jax(config, 1)
    assert params.viscosity_method == "implicit" and params.dim == 3
    assert out[0][2] < 1e-5, f"drift {out[0][2]:.2e}"

"""The implicit viscosity's two pair passes in 2D against the JAX
package's (tests/test_torch_kinds.py ``check_viscosity``: the 2D domain box
with implicit viscosity 50 and the block on the floor, under the cubic
spline and under poly6, both engines; poly6 in 3D in
tests/test_torch_kinds_visc_3d.py), the 2x2 inverse of its preconditioner,
and PBF's three passes under the cubic spline in 2D (a PBF file selects
poly6; the override keeps the cubic spline), at moved positions against the
JAX executor with ``pair_block=1`` as tests/test_torch_pbf.py.

Tolerance of a pass: max|a - b| <= 2e-5 * max(1, max|b|); of the inverse
1e-5 of the largest |entry| of the float64 inverse.
"""
import numpy as np
import pytest
import torch

from sph_project_tpu_torch.solvers import viscosity_cg as tvisc

from test_torch_kinds import (ENGINE_IDS, ENGINES, KindSetup, box2d_config,
                              check_viscosity, implicit, on_floor)
from test_torch_pbf import PbfSetup, check_passes

# here 2D; tests/test_torch_kinds_visc_3d.py runs poly6 in 3D
COMBOS = {"cubic_2d": (box2d_config, {}),
          "poly6_2d": (box2d_config, {"kernel_type": "poly6"})}


@pytest.mark.parametrize("engine", ENGINES, ids=ENGINE_IDS)
@pytest.mark.parametrize("combo", COMBOS)
def test_viscosity_passes(combo, engine):
    viscosity_passes(COMBOS, combo, engine)


def viscosity_passes(combos, combo, engine):
    config, overrides = combos[combo]
    s = KindSetup(implicit(on_floor(config())), engine, **overrides)
    assert (s.params.kernel_type, s.params.dim) == \
        (overrides.get("kernel_type", "cubic"), 3 if combo == "poly6_3d" else 2)
    check_viscosity(s)


@pytest.mark.parametrize("engine", ENGINES, ids=ENGINE_IDS)
def test_pbf_passes_cubic(engine):
    """PBF's passes under the cubic spline (a PBF file selects poly6; the
    override keeps the cubic spline) in the 2D box, walls included."""
    s = PbfSetup(box2d_config("pbf"), engine, kernel_type="cubic")
    assert s.params.dim == 2 and s.params.kernel_type == "cubic"
    check_passes(s)


def test_inverse2_matches_float64():
    """Seeded 2x2 matrices, the preconditioner's kind (I plus a symmetric
    part) and general ones with a condition number under 100: within 1e-5
    of the largest |entry| of the float64 inverse."""
    rng = np.random.default_rng(0)
    s = rng.normal(0.0, 0.3, (4000, 2, 2))
    sym = np.eye(2) + 0.5 * (s + s.transpose(0, 2, 1))
    gen = rng.normal(0.0, 1.0, (4000, 2, 2))
    for m in (sym, gen):
        m = m[np.linalg.cond(m) < 100].astype(np.float32)
        assert len(m) > 1000
        want = np.linalg.inv(m.astype(np.float64))
        got = tvisc.inverse2(torch.from_numpy(m)).numpy()
        err = np.abs(got - want).max(axis=(1, 2))
        assert (err <= 1e-5 * np.abs(want).max(axis=(1, 2))).all(), err.max()

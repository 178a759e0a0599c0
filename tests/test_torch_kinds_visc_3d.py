"""The implicit viscosity's two pair passes under poly6 in 3D against the
JAX package's: tests/test_torch_kinds_visc.py's check on the 3D domain box
(implicit viscosity 50, the block on the floor), both engines.

Tolerance of a pass: max|a - b| <= 2e-5 * max(1, max|b|).
"""
import pytest

from test_torch_kinds import ENGINE_IDS, ENGINES
from test_torch_kinds_visc import viscosity_passes
from test_torch_scene import box_config

COMBOS = {"poly6_3d": (box_config, {"kernel_type": "poly6"})}


@pytest.mark.parametrize("engine", ENGINES, ids=ENGINE_IDS)
@pytest.mark.parametrize("combo", COMBOS)
def test_viscosity_passes(combo, engine):
    viscosity_passes(COMBOS, combo, engine)

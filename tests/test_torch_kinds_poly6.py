"""The pair passes of DFSPH, WCSPH, PCISPH and IISPH under the poly6 kernel
in 3D against the JAX package: tests/test_torch_kinds.py's checks (see its
docstring) on the 3D domain box under ``kernel_type="poly6"``, its block on
the floor, under both engines.

Tolerance of a pass: max|a - b| <= 2e-5 * max(1, max|b|); counts exact.
"""
import pytest

from test_torch_kinds import CHECKS, kind_setups
from test_torch_scene import box_config

box = kind_setups(box_config, kernel_type="poly6")


def test_setup_kind(box):
    assert box.params.kernel_type == "poly6"
    assert box.params.dim == 3


@pytest.mark.parametrize("name", CHECKS)
def test_pass(box, name):
    CHECKS[name](box)

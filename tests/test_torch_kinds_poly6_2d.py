"""The pair passes of DFSPH, WCSPH, PCISPH and IISPH under the poly6 kernel
in 2D against the JAX package: tests/test_torch_kinds.py's checks (see its
docstring) on the 2D domain box under ``kernel_type="poly6"``, its block on
the floor, under both engines.

Tolerance of a pass: max|a - b| <= 2e-5 * max(1, max|b|); counts exact.
"""
import pytest

from test_torch_kinds import CHECKS, box2d_config, kind_setups

box = kind_setups(box2d_config, kernel_type="poly6")


def test_setup_kind(box):
    assert box.params.kernel_type == "poly6"
    assert box.params.dim == 2


@pytest.mark.parametrize("name", CHECKS)
def test_pass(box, name):
    CHECKS[name](box)

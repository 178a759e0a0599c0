"""Steps under the poly6 kernel in 3D against the JAX package: DFSPH cold
and warm, WCSPH and PCISPH on the 3D domain box of tests/test_torch_scene.py
(a block thrown onto the floor of a box of static walls) under
``kernel_type="poly6"``, 20 steps with tests/test_torch_kinds_steps.py's
``run_steps`` (iteration counts equal every step, the fluid within 1e-5;
measured at most 6.7e-7). IISPH, DFSPH through the slab-window engine and
PBF with implicit viscosity: tests/test_torch_kinds_steps_pbf_implicit.py.
"""
import pytest

from test_torch_kinds_steps import WARM, run_steps
from test_torch_scene import box_config

# here DFSPH cold and warm, WCSPH and PCISPH;
# tests/test_torch_kinds_steps_pbf_implicit.py runs IISPH and DFSPH through
# the slab-window engine with this test
BOX_CASES = {"dfsph": {}, "dfsph_warm": WARM, "wcsph": {}, "pcisph": {}}


def poly6_box_steps(case, box_cases):
    """20 steps of the 3D box under poly6 for ``case`` (method, then the
    variant of ``box_cases``)."""
    method = case.split("_")[0]
    iters, _ = run_steps(box_config(method), kernel_type="poly6",
                         **box_cases[case])
    if method != "wcsph":
        # poly6 (W(0) = 0) gives the block a low density: the correctors of
        # DFSPH iterate in the divergence solve only
        assert max(max(i) for i in iters) > 1


@pytest.mark.parametrize("case", BOX_CASES)
def test_poly6_box_steps(case):
    poly6_box_steps(case, BOX_CASES)

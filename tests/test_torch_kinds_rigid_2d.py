"""The port's pair passes with dynamic rigid bodies in 2D, under the cubic
spline and under poly6, against the JAX package's: the tests of
tests/test_torch_kinds_rigid.py (see its docstring) on its hand-built 2D
state, under both engines.
"""
from test_torch_kinds_rigid import (box_fixture, cube_obj,  # noqa: F401
                                    test_state_has_wrench_and_contact_pairs,
                                    test_nonpressure_wrench,
                                    test_correction_wrench,
                                    test_nonpressure_warm_wrenches,
                                    test_pressure_wrench,
                                    test_density_alpha_divergence_svol,
                                    test_rigid_contact_pass,
                                    test_rigid_volume_after_rigid_motion,
                                    test_rigid_dem_pass)

box = box_fixture(("cubic_2d", "poly6_2d"))

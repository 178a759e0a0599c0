"""The shape-matching backend's DEM contact pass, ``rigid_dem``, under the
cubic spline in 3D against the JAX package's ``rigid_contact_wrench``:
tests/test_torch_kinds_rigid.py's test (see its docstring) on its coupled
cubes, under both engines.
"""
from test_torch_kinds_rigid import (box_fixture, cube_obj,  # noqa: F401
                                    test_rigid_dem_pass)

box = box_fixture(("cubic_3d",))

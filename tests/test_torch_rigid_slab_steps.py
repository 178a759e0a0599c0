"""Coupled steps of the port against the JAX package's under the slab-window
engine, and the three-box squeeze: the scenes, checks and tolerances of
tests/test_torch_rigid_steps.py (split from it so that each file stays short
on one test worker)."""
import numpy as np
import pytest

from test_rigid import write_cube_obj
from test_torch_rigid_steps import (check_cube_pool, cube_small,  # noqa: F401
                                    run_coupled, squeeze_config)


@pytest.fixture(scope="module")
def cube(tmp_path_factory):
    return write_cube_obj(str(tmp_path_factory.mktemp("mesh") / "cube.obj"))


@pytest.mark.parametrize("method", ["dfsph", "wcsph", "pcisph", "iisph"])
def test_cube_pool_steps_match_jax_slab(cube_small, method):  # noqa: F811
    check_cube_pool(cube_small, method, 5, pair_backend="pallas")


def test_three_box_squeeze_matches_jax(cube):
    """The squeeze through both packages, then tests/test_rigid.py's own
    assertions on the port's bodies."""
    _, port, _ = run_coupled(squeeze_config(cube), 45)
    rigid = port.state.rigid
    m = rigid.mass[:3].numpy().astype(np.float64)
    p0 = (m[:, None] * np.array([[0.8, 0, 0], [0, 0, 0], [-0.8, 0, 0]])
          ).sum(axis=0)
    v = rigid.vel[:3].numpy().astype(np.float64)
    com = rigid.com[:3].numpy()
    p1 = (m[:, None] * v).sum(axis=0)
    scale = float(np.abs(m[:, None] * v).sum()) + float(np.abs(m).sum()) * 0.8
    np.testing.assert_allclose(p1, p0, atol=0.05 * scale)
    assert abs(v[1, 0]) < 0.25, f"middle box launched: {v[1]}"
    assert abs(com[1, 0] - 0.30) < 0.02, f"middle box displaced: {com[1]}"
    assert v[0, 0] < 0.5 and v[2, 0] > -0.5
    assert com[0, 0] < com[1, 0] < com[2, 0]

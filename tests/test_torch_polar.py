"""The polar factor of ``ops/polar.py`` against the JAX package's.

``polar_rotation_plain`` (what ``polar_rotation`` runs on CPU tensors, and
what ``csrc/polar.cu`` is held to on the card) against the JAX package's
``rigid/shape_matching.py`` ``_polar_rotation``, on seeded numpy batches in
3D and 2D, within 1e-5: R = U V^T is unique for a nonsingular A, and so is
the fixed R wherever the smallest singular value is single, so R is
compared and not U or V. Cases:

- random: random orthogonal factors (rotations and reflections) around
  singular values in [0.2, 2];
- reflections: det(A) < 0, det(U V^T) = -1 before the fix, the
  smallest singular value well apart from the others;
- repeated singular values: c I, and c Q for a rotation Q;
- near rank-deficient: the smallest singular value 1e-3 of the largest;
- identity pads: the bodies with no particle, whose covariance
  ``shape_matching_step`` sets to I.

The kernel against this version on the card: ``test_torch_polar_card.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_project_tpu.rigid import shape_matching as jsm

from sph_project_tpu_torch.ops import polar

import test_torch_scene  # noqa: F401  (one torch thread a process)

TOL = 1e-5
N = 64


def orthogonal(rng, n, dim, proper=None):
    """n random orthogonal (dim, dim) matrices; ``proper`` True: rotations,
    False: reflections, None: either."""
    q, r = np.linalg.qr(rng.normal(size=(n, dim, dim)))
    q = q * np.sign(np.diagonal(r, axis1=1, axis2=2))[:, None, :]
    if proper is not None:
        flip = (np.linalg.det(q) > 0) != proper
        q[flip, :, 0] *= -1.0
    return q


def with_singular_values(rng, sigma, dim, det_sign=None):
    """U diag(sigma) V^T of random orthogonal U, V; ``det_sign`` the sign of
    det(U V^T) (None: either)."""
    n = sigma.shape[0]
    u = orthogonal(rng, n, dim)
    v = orthogonal(rng, n, dim, None if det_sign is None else
                   (np.linalg.det(u) > 0) == (det_sign > 0))
    return u @ (sigma[:, :, None] * np.swapaxes(v, 1, 2))


def cases(dim):
    rng = np.random.default_rng(100 + dim)
    spread = np.sort(rng.uniform(0.2, 2.0, (N, dim)), 1)[:, ::-1]
    c = rng.uniform(0.1, 5.0, (N, 1, 1))
    # the fixed column belongs to the smallest singular value: kept apart
    # from the others, so that the column, and with it R, is determined
    apart = np.array([2.0, 1.0, 0.4][:dim - 1] + [0.4]) * \
        rng.uniform(0.9, 1.1, (N, dim))
    near = np.concatenate([np.ones((N, 1)),
                           rng.uniform(0.3, 0.8, (N, dim - 2)),
                           np.full((N, 1), 1e-3)], 1)
    return {
        "random": with_singular_values(rng, spread, dim),
        "reflections": with_singular_values(rng, apart, dim, det_sign=-1),
        "repeated": np.concatenate([c * np.eye(dim)[None],
                                    c * orthogonal(rng, N, dim, True)]),
        "near_rank_deficient": with_singular_values(rng, near, dim),
        "identity_pads": np.broadcast_to(np.eye(dim), (8, dim, dim)),
    }


@pytest.mark.parametrize("dim", [3, 2])
@pytest.mark.parametrize("case", ["random", "reflections", "repeated",
                                  "near_rank_deficient", "identity_pads"])
def test_polar_rotation_plain_matches_jax(case, dim):
    A = np.ascontiguousarray(cases(dim)[case], dtype=np.float32)
    if case == "reflections":
        assert (np.linalg.det(A) < 0).all()
    want = np.asarray(jsm._polar_rotation(jnp.asarray(A)))
    got = polar.polar_rotation(torch.from_numpy(A))
    assert got.dtype == torch.float32 and got.shape == A.shape
    got = got.numpy()
    assert np.abs(got - want).max() <= TOL
    got64 = got.astype(np.float64)
    np.testing.assert_allclose(np.linalg.det(got64), 1.0, atol=TOL)
    np.testing.assert_allclose(np.swapaxes(got64, 1, 2) @ got64,
                               np.broadcast_to(np.eye(dim), A.shape),
                               atol=TOL)


def test_polar_rotation_routes_by_device():
    """The CPU takes the plain version and counts no launch; the kernel's
    wrapper refuses a tensor that is not on a card."""
    A = torch.eye(3).repeat(4, 1, 1)
    before = polar.launches["polar"]
    assert torch.equal(polar.polar_rotation(A),
                       polar.polar_rotation_plain(A))
    assert polar.launches["polar"] == before
    with pytest.raises(ValueError):
        polar.polar_rotation_cuda(A)

"""``csrc/polar.cu`` against its plain version, on the card.

Needs a CUDA device and skips without one; this file imports no JAX, so it
runs on the card's host:

    python3 -m pytest -m cuda tests/test_torch_polar_card.py -q

Seeded (O, d, d) float32 batches in 3D and 2D (general matrices, c I, and
the identity pads of the bodies with no particle): the kernel's R within
1e-5 of ``polar_rotation_plain``'s (``torch.linalg.svd`` and ``det`` on the
same card), det R = 1 and R^T R = I within 1e-5, one launch counted.
``tests/test_torch_polar.py`` holds the plain version to the JAX package's.
"""
import numpy as np
import pytest
import torch

from sph_project_tpu_torch.ops import polar

TOL = 1e-5


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: csrc/polar.cu runs only on the card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [3, 2])
def test_polar_kernel_matches_plain(card, dim):
    rng = np.random.default_rng(dim)
    A = np.concatenate([rng.normal(size=(256, dim, dim)),
                        rng.uniform(0.1, 5.0, (16, 1, 1)) * np.eye(dim),
                        np.broadcast_to(np.eye(dim), (8, dim, dim))])
    A = torch.from_numpy(A.astype(np.float32)).to(card)
    before = polar.launches["polar"]
    got = polar.polar_rotation(A)
    assert polar.launches["polar"] == before + 1
    want = polar.polar_rotation_plain(A)
    assert float((got - want).abs().max()) <= TOL
    g = got.double()
    assert float((torch.linalg.det(g) - 1.0).abs().max()) <= TOL
    eye = torch.eye(dim, dtype=torch.float64, device=card)
    assert float((g.transpose(1, 2) @ g - eye).abs().max()) <= TOL

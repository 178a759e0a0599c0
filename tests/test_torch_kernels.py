"""The port's smoothing kernels pointwise against the JAX package's.

Both evaluate the same float32 expressions with the same folded constants,
so they agree to a few ulps; the tolerance (1e-6 of the largest value) is
float32 rounding of one expression, with room for a different sqrt/rsqrt
lowering on the JAX side.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_project_tpu.ops import kernels as jk
from sph_project_tpu_torch.ops import kernels as tk

H = 0.04


def _close(a, b, rel=1e-6):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.max(np.abs(a - b)) <= rel * max(1.0, np.max(np.abs(b)))


def _d2_samples():
    rng = np.random.default_rng(0)
    r = np.concatenate([rng.uniform(0.0, H, 2000),
                        # lattice distances of the seeded scenes, incl. |R|=h
                        0.02 * np.sqrt(np.arange(0, 5)),
                        [0.0, 1e-6, 0.5 * H, H]]).astype(np.float32)
    return (r * r).astype(np.float32)


@pytest.mark.parametrize("dim", [2, 3])
def test_cubic_w_gw_d2_matches_jax(dim):
    d2 = _d2_samples()
    jw, jgw = jk.cubic_w_gw_d2(jnp.asarray(d2), H, dim)
    tw, tgw = tk.cubic_w_gw_d2(torch.from_numpy(d2), H, dim)
    inside = d2 < np.float32(H * H)
    _close(np.asarray(jw)[inside], tw.numpy()[inside])
    _close(np.asarray(jgw)[inside], tgw.numpy()[inside])


@pytest.mark.parametrize("dim", [2, 3])
def test_cubic_W_and_grad_coef_match_jax(dim):
    r = np.sqrt(_d2_samples()).astype(np.float32)
    r = np.concatenate([r, np.float32([1.5 * H])])
    _close(np.asarray(jk.W(jnp.asarray(r), H, dim)),
           tk.W(torch.from_numpy(r), H, dim).numpy())
    _close(np.asarray(jk.grad_W_coef(jnp.asarray(r), H, dim)),
           tk.grad_W_coef(torch.from_numpy(r), H, dim).numpy())
    assert tk.W0(H, dim) == jk.W0(H, dim)


def test_cubic_constants_fold_like_jax():
    h, k, k2, g6 = tk.cubic_constants(H, 3)
    assert (h, k) == (H, jk.cubic_W0(H, 3))
    assert k2 == k * 2.0 and g6 == 6.0 * k / (H * H)


def test_other_kernels_not_ported():
    with pytest.raises(NotImplementedError, match="A.9"):
        tk.W(torch.zeros(3), H, 3, kind="poly6")

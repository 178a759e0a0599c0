"""The port's smoothing kernels pointwise against the JAX package's.

Both evaluate the same float32 expressions with the same folded constants,
so they agree to a few ulps; the tolerance (1e-6 of the largest value) is
float32 rounding of one expression, with room for a different sqrt/rsqrt
lowering on the JAX side.
"""
import math

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
    """PBF's poly6 kind is computed (as the JAX package computes it); a kind
    neither package has raises."""
    r = np.sqrt(_d2_samples()).astype(np.float32)
    _close(np.asarray(jk.W(jnp.asarray(r), H, 3, "poly6")),
           tk.W(torch.from_numpy(r), H, 3, kind="poly6").numpy())
    with pytest.raises(ValueError, match="kind"):
        tk.W(torch.zeros(3), H, 3, kind="quintic")


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("kind", ["cubic", "poly6"])
def test_kind_dispatch_matches_jax(kind, dim):
    """W, W0, grad_W_coef and the vector gradient of either kind (poly6 W
    and the spiky gradient under "poly6"), and the squared-distance forms of
    the shared passes (JAX common._w_d2, _gw_coef)."""
    from sph_project_tpu.core.params import make_params
    from sph_project_tpu.solvers import common as jcommon
    r = np.concatenate([np.sqrt(_d2_samples()),
                        np.float32([1.5 * H])]).astype(np.float32)
    _close(np.asarray(jk.W(jnp.asarray(r), H, dim, kind)),
           tk.W(torch.from_numpy(r), H, dim, kind).numpy())
    _close(np.asarray(jk.grad_W_coef(jnp.asarray(r), H, dim, kind)),
           tk.grad_W_coef(torch.from_numpy(r), H, dim, kind).numpy())
    assert tk.W0(H, dim, kind) == jk.W0(H, dim, kind)
    rng = np.random.default_rng(1)
    R = rng.uniform(-H, H, (500, dim)).astype(np.float32)
    _close(np.asarray(jk.grad_W(jnp.asarray(R), H, dim, kind=kind)),
           tk.grad_W(torch.from_numpy(R), H, dim, kind=kind).numpy())
    params = make_params(100, dim=dim, support_radius=H, kernel_type=kind)
    d2 = _d2_samples()
    inside = d2 < np.float32(H * H)
    _close(np.asarray(jcommon._w_d2(jnp.asarray(d2), params))[inside],
           tk.w_d2(torch.from_numpy(d2), H, dim, kind).numpy()[inside])
    _close(np.asarray(jcommon._gw_coef(jnp.asarray(d2), params))[inside],
           tk.gw_d2(torch.from_numpy(d2), H, dim, kind).numpy()[inside])


def test_poly6_spiky_forms_match_jax():
    r = np.sqrt(_d2_samples()).astype(np.float32)
    _close(np.asarray(jk.poly6_W(jnp.asarray(r), H)),
           tk.poly6_W(torch.from_numpy(r), H).numpy())
    rng = np.random.default_rng(2)
    for dim in (2, 3):
        R = rng.uniform(-H, H, (500, dim)).astype(np.float32)
        _close(np.asarray(jk.spiky_grad_W(jnp.asarray(R), H)),
               tk.spiky_grad_W(torch.from_numpy(R), H).numpy())
        _close(np.asarray(jk.cubic_grad_W(jnp.asarray(R), H, dim)),
               tk.cubic_grad_W(torch.from_numpy(R), H, dim).numpy())


def test_kind_constants_fold_like_jax():
    h, h2, h3, p6, sp, k6 = tk.kind_constants(H, 3)
    assert (h, h2, h3) == (H, H * H, H * H * H)
    assert p6 == 315.0 / 64.0 / math.pi and sp == -45.0 / math.pi
    assert k6 == 6.0 * jk.cubic_W0(H, 3)

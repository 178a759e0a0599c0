"""The port's permute against the JAX package's Pallas permute kernel.

The JAX kernel runs in Pallas interpret mode on the CPU. Both move every
field bit for bit, so the comparison is bit equality, dtypes included.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_project_tpu.ops import permute as jperm
from sph_project_tpu_torch.ops import permute as tperm

N = 1024   # the JAX kernel takes N % 128 == 0


def _near_identity(n, seed):
    """A near-identity permutation, as a step's re-sort gives: local swaps
    plus a few long jumps (x-plane crossers)."""
    rng = np.random.default_rng(seed)
    perm = np.arange(n)
    for _ in range(n // 8):
        i = rng.integers(0, n - 3)
        j = i + rng.integers(1, 3)
        perm[[i, j]] = perm[[j, i]]
    for _ in range(4):
        i, j = rng.integers(0, n, 2)
        perm[[i, j]] = perm[[j, i]]
    return perm


def _fields(seed):
    rng = np.random.default_rng(seed)
    return {
        "pos": rng.normal(size=(N, 3)).astype(np.float32),
        "density": rng.uniform(500, 1500, N).astype(np.float32),
        "material": rng.integers(0, 3, N).astype(np.int32),
        "object_id": rng.integers(-1, 20, N).astype(np.int32),
    }


@pytest.mark.parametrize("seed", [0, 1])
def test_plain_permute_matches_pallas_kernel(seed):
    perm = _near_identity(N, seed)
    fields = _fields(seed)
    jout, overflow = jperm.permute_fields(
        jnp.asarray(perm, jnp.int32),
        {k: jnp.asarray(v) for k, v in fields.items()}, interpret=True)
    assert int(overflow) == 0
    tout = tperm.permute_fields(torch.from_numpy(perm),
                                {k: torch.from_numpy(v) for k, v in fields.items()})
    for k, v in fields.items():
        t = tout[k].numpy()
        assert t.dtype == v.dtype, k
        np.testing.assert_array_equal(t, np.asarray(jout[k]), err_msg=k)
        np.testing.assert_array_equal(t, v[perm], err_msg=k)


def test_cuda_wrapper_checks_inputs():
    perm = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="int64"):
        tperm.permute_fields_cuda(perm, {"x": torch.zeros(8)})
    with pytest.raises(ValueError, match="32-bit"):
        tperm.permute_fields_cuda(torch.arange(8), {"x": torch.zeros(8, dtype=torch.int8)})

"""The port's permute against the JAX package's Pallas permute kernel.

The JAX kernel runs in Pallas interpret mode on the CPU. Both move every
field bit for bit, so the comparison is bit equality, dtypes included.
"""
import dataclasses

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


def test_sort_state_carries_warm_start_fields():
    """With both warm starts on, the per-step sort moves 12 fields in one
    call: the 9 particle fields of a scene with walls, the two carried
    stiffnesses, which live on the state, and the cell ids. Each bit-equal to
    plain indexing by the permutation."""
    from sph_project_tpu_torch import sim as tsim
    from test_torch_scene import box_config, load_both
    _, _, ts, state = load_both(box_config(), port_kw=dict(
        dfsph_warm_start=True, dfsph_warm_start_div=True))
    keys, extras = tsim.permuted_keys(ts.params)
    assert len(keys) == 9 and extras == ("dfsph_kappa", "dfsph_kappa_v")
    cold = tsim.permuted_keys(dataclasses.replace(
        ts.params, dfsph_warm_start=False, dfsph_warm_start_div=False))
    assert cold == (keys, ())
    rng = np.random.default_rng(2)
    n = ts.params.n_pad
    state = state.replace(
        dfsph_kappa=torch.from_numpy(rng.normal(size=n).astype(np.float32)),
        dfsph_kappa_v=torch.from_numpy(rng.normal(size=n).astype(np.float32)))
    moved = {}
    real = tperm.permute_fields
    try:
        tperm.permute_fields = lambda perm, arrays: moved.update(
            arrays) or real(perm, arrays)
        out, cells_sorted, perm = tsim.sort_state(state, ts.params)
    finally:
        tperm.permute_fields = real
    assert len(moved) == 12 and (perm != torch.arange(n)).any()
    assert torch.equal(cells_sorted, moved["cells"][perm])
    for k in keys:
        assert torch.equal(getattr(out.particles, k),
                           getattr(state.particles, k)[perm]), k
    for k in extras:
        assert torch.equal(getattr(out, k), getattr(state, k)[perm]), k


def test_cuda_wrapper_checks_inputs():
    perm = torch.arange(8, dtype=torch.int32)
    with pytest.raises(ValueError, match="int64"):
        tperm.permute_fields_cuda(perm, {"x": torch.zeros(8)})
    with pytest.raises(ValueError, match="32-bit"):
        tperm.permute_fields_cuda(torch.arange(8), {"x": torch.zeros(8, dtype=torch.int8)})

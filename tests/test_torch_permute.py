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


# ---- the resort's packed gather ----------------------------------------------
# field sets of the flagship's carried rows: without rigid_rest_pos (13 words
# a row: odd), with it (16: even), and a 2D state (11); widths 1, 2 and 3,
# float32 and int32
WIDE = {"pos": 3, "vel": 3, "mass": 1, "rest_volume": 1, "density": 1,
        "material": 1, "object_id": 1, "is_dynamic": 1, "cells": 1}
FIELD_SETS = {"3d_13": WIDE, "3d_16": dict(WIDE, rigid_rest_pos=3),
              "2d_11": dict(WIDE, pos=2, vel=2)}
INT_FIELDS = ("material", "object_id", "is_dynamic", "cells")


def _field_set(name, n, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for k, w in FIELD_SETS[name].items():
        shape = (n,) if w == 1 else (n, w)
        out[k] = (rng.integers(-5, 2 ** 20, shape).astype(np.int32)
                  if k in INT_FIELDS else
                  rng.normal(size=shape).astype(np.float32))
    return out


def _perm(kind, n, seed):
    if kind == "near_identity":
        return _near_identity(n, seed)
    return np.random.default_rng(seed).permutation(n)


def _words_np(fields):
    n = next(iter(fields.values())).shape[0]
    return np.concatenate([v.reshape(n, -1).view(np.int32)
                           for v in fields.values()], 1)


def _bits_equal(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.parametrize("kind", ["near_identity", "random"])
@pytest.mark.parametrize("n", [1000, 261])
@pytest.mark.parametrize("fset", list(FIELD_SETS))
def test_pack_unpack_match_compositions(fset, n, kind):
    """permute_pack is pack_words of the gathered fields, permute_unpack the
    gather of unpack_words' fields, bit for bit, dtypes kept: widths 1-3,
    float32 and int32, W of 13, 16 and 11 words, n not a multiple of 128 or
    of the kernel's tile."""
    assert n % 128 and n % tperm.TILE
    fields = {k: torch.from_numpy(v) for k, v in _field_set(fset, n, 3).items()}
    perm = torch.from_numpy(_perm(kind, n, 4))
    W = sum(FIELD_SETS[fset].values())
    packed = tperm.permute_pack(perm, fields)
    want = tperm.pack_words(tperm.permute_fields(perm, fields))
    assert packed.shape == (n, W) and _bits_equal(packed, want)
    words = torch.from_numpy(np.random.default_rng(5).integers(
        -2 ** 31, 2 ** 31, (n, W)).astype(np.int32))
    out = tperm.permute_unpack(perm, words, fields)
    want = tperm.permute_fields(perm, tperm.unpack_words(words, fields))
    assert list(out) == list(fields)
    for k in fields:
        assert _bits_equal(out[k], want[k]), k


@pytest.mark.parametrize("fset", list(FIELD_SETS))
def test_packed_permute_matches_pallas_kernel(fset):
    """The pack and the unpack against the JAX package's Pallas permute in
    interpret mode (N % 128 == 0), bit for bit."""
    perm = _near_identity(N, 6)
    fields = _field_set(fset, N, 7)
    jout, overflow = jperm.permute_fields(
        jnp.asarray(perm, jnp.int32),
        {k: jnp.asarray(v) for k, v in fields.items()}, interpret=True)
    assert int(overflow) == 0
    jout = {k: np.asarray(v) for k, v in jout.items()}
    tfields = {k: torch.from_numpy(v) for k, v in fields.items()}
    tperm_ = torch.from_numpy(perm)
    packed = tperm.permute_pack(tperm_, tfields).numpy()
    np.testing.assert_array_equal(packed, _words_np(jout))
    out = tperm.permute_unpack(tperm_, torch.from_numpy(_words_np(fields)),
                               tfields)
    for k, v in jout.items():
        assert out[k].numpy().dtype == v.dtype, k
        np.testing.assert_array_equal(out[k].numpy(), v, err_msg=k)


def _bad_inputs():
    n = 8
    ok = {"x": torch.zeros(n), "p": torch.zeros(n, 3, dtype=torch.int32)}
    int8 = {"x": torch.zeros(n, dtype=torch.int8)}
    short = {"x": torch.zeros(n - 1)}
    perm, perm32 = torch.arange(n), torch.arange(n, dtype=torch.int32)
    words = torch.zeros(n, 4, dtype=torch.int32)
    return {
        "fields_perm_int32": (tperm.permute_fields_cuda, (perm32, ok), "int64"),
        "fields_int8_row": (tperm.permute_fields_cuda, (perm, int8), "32-bit"),
        "fields_rows": (tperm.permute_fields_cuda, (perm, short), "rows"),
        "pack_perm_int32": (tperm.permute_pack_cuda, (perm32, ok), "int64"),
        "pack_int8_row": (tperm.permute_pack_cuda, (perm, int8), "32-bit"),
        "pack_rows": (tperm.permute_pack_cuda, (perm, short), "rows"),
        "unpack_perm_int32": (tperm.permute_unpack_cuda,
                              (perm32, words, ok), "int64"),
        "unpack_int8_row": (tperm.permute_unpack_cuda,
                            (perm, torch.zeros(n, 1, dtype=torch.int32), int8),
                            "32-bit"),
        "unpack_rows": (tperm.permute_unpack_cuda,
                        (perm, words[:n - 1], ok), "rows"),
        "unpack_width": (tperm.permute_unpack_cuda,
                         (perm, torch.zeros(n, 5, dtype=torch.int32), ok),
                         "words a row"),
    }


@pytest.mark.parametrize("case", list(_bad_inputs()))
def test_cuda_wrappers_check_inputs(case):
    """The kernel's wrappers refuse before any launch: a non-int64 perm, a
    row that is not whole 32-bit words, a row-count mismatch, a buffer whose
    width is not the fields'."""
    fn, args, match = _bad_inputs()[case]
    with pytest.raises(ValueError, match=match):
        fn(*args)


def _emulate(table, perm, srcs, dsts):
    """What csrc/permute.cu does under a layout table, on numpy word arrays
    (``srcs``, ``dsts``: flat uint32, in the table's order): stage each
    tile's rows at the planned words, then store every destination from
    them."""
    tile, nsrc, ndst, ncols, tile_words = table[:5]
    rest = table[5:]
    src_rows = [rest[4 * i:4 * i + 4] for i in range(nsrc)]
    rest = rest[4 * nsrc:]
    dst_rows = [rest[2 * o:2 * o + 2] for o in range(ndst)]
    cols = [rest[2 * ndst + 2 * c:2 * ndst + 2 * c + 2] for c in range(ncols)]
    n = len(perm)
    for r0 in range(0, n, tile):
        rows = perm[r0:r0 + tile]
        r = np.arange(len(rows))
        smem = np.zeros(tile_words, np.int64) - 1
        for (w, col, at, step), mem in zip(src_rows, srcs):
            for c in range(w):
                a = (at + r * step + c if step else
                     cols[col + c][0] + r * cols[col + c][1])
                assert (smem[a] == -1).all(), "a staged word written twice"
                smem[a] = mem[rows * w + c]
        for (w, at), mem in zip(dst_rows, dsts):
            span = smem[at:at + len(rows) * w]
            assert (span >= 0).all(), "a word unstaged"
            mem[r0 * w:(r0 + len(rows)) * w] = span


@pytest.mark.parametrize("offset", [0, 4, 12])
@pytest.mark.parametrize("use", ["fields", "pack", "unpack"])
@pytest.mark.parametrize("fset", ["3d_13", "3d_16", "2d_11"])
def test_plan_layout(fset, use, offset):
    """The layout table the wrappers give the kernel: every destination word
    staged once, spans 16-byte aligned where the destination's rows are (its
    base ``offset`` bytes past a boundary), spans disjoint, sources by row
    step where their columns lie in one destination; the kernel's data
    movement under the table is the gather."""
    n = 1000
    fields = _field_set(fset, n, 8)
    widths = list(FIELD_SETS[fset].values())
    W = sum(widths)
    cols = [sum(widths[:i]) for i in range(len(widths))]
    perm = _perm("random", n, 9)
    head = (16 - offset) % 16 // 4
    if use == "unpack":
        srcs = [_words_np(fields).reshape(-1).view(np.uint32)]
        sources = [(W, 0)]
    else:
        srcs = [v.reshape(-1).view(np.uint32) for v in fields.values()]
        sources = list(zip(widths, cols))
    dests = [(W, head)] if use == "pack" else [(w, head) for w in widths]
    dsts = [np.zeros(n * w, np.uint32) for w, _ in dests]
    table = tperm.plan(sources, dests)
    assert table[0] == tperm.TILE
    tile_words = table[4]
    spans = []
    for i in range(len(dests)):
        w, at = table[5 + 4 * len(sources) + 2 * i:][:2]
        assert (at + head) % 4 == 0
        spans.append((at, at + tperm.TILE * w))
    spans.sort()
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= tile_words
    steps = [table[5 + 4 * i + 3] for i in range(len(sources))]
    assert all(steps) == (use != "unpack")
    _emulate(table, perm, srcs, dsts)
    want = _words_np({k: v[perm] for k, v in fields.items()})
    got = np.concatenate([d.view(np.int32).reshape(n, w)
                          for d, (w, _) in zip(dsts, dests)], 1)
    np.testing.assert_array_equal(got, want)

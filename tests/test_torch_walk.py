"""Host side of the compacted candidate walk of the two CUDA pair kernels.

The kernels themselves run only on a card (``chip_smoke.py`` holds them to
their plain versions there). Here, on the CPU:

- the pile-up state the smoke run uses (rows with about 250 neighbours, more
  than any list of the walk holds) goes through both plain executors, which
  are what the kernels are held to, against the JAX package's executor
  (``pair_exec._exec_jax`` over the JAX window table of the same sorted rows)
  and against a brute-force sum over all pairs, neighbour counts exact;
- the piece of a window that the slab-window kernel finds for a row by binary
  search over the window's cell ids is the run of the cell table, for every
  row and segment;
- the ctypes mirror of ``struct PairArgs`` matches the header field for field,
  every shared header is part of every build's hash, and the tile and list
  sizes are constants of the sources that fit a block's shared memory.

Tolerance: max|a - b| <= 2e-5 * max(1, max|b|), as tests/test_torch_pairs.py.
"""
import ctypes
import dataclasses
import importlib
import re
import shutil
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_project_tpu.core.params import make_params as jax_make_params
from sph_project_tpu.core.state import ParticleState as JaxParticleState
from sph_project_tpu.ops import pair_exec
from sph_project_tpu.ops import pairs as jpairs
from sph_project_tpu.solvers import common as jcommon
from sph_project_tpu.solvers import dfsph as jdfsph

from sph_project_tpu_torch.core.params import MATERIAL_NONE
from sph_project_tpu_torch.ops import _build
from sph_project_tpu_torch.ops import pair_kernels as pk
from sph_project_tpu_torch.ops import pairs

from test_torch_pairs import Setup, assert_pass_close
from test_torch_scene import TPU_SIZING, box_config

CSRC = _build.CSRC


def header(name):
    with open(f"{CSRC}/{name}") as f:
        return f.read()


def constant(name, source):
    """The value of ``#define name <integer>`` in ``csrc/<source>``."""
    return int(re.search(rf"#define {name} (\d+)\b", header(source))[1])


def list_cap():
    return constant("LIST_CAP", "pair_walk.cuh")


@pytest.fixture(scope="module")
def pile():
    params, cells, produce, fields = pk.pile_up_case()
    envs = {"pair_pass": pairs.make_pair_env(cells, produce, params),
            "pair_slab": pairs.make_slab_env(cells, produce, params)}
    return params, cells, produce, fields, envs


def test_pile_up_case_has_what_breaks_a_list(pile):
    params, cells, produce, fields, envs = pile
    gx, gy, gz = params.grid_num
    n = params.n_pad
    assert cells.shape == (n,) and n % params.pair_block == 0 and n % 128 == 0
    assert bool((cells[1:] >= cells[:-1]).all())
    live = fields["material"] != MATERIAL_NONE
    assert (~live).sum() >= 128 and bool((cells[~live] == params.num_cells).all())
    assert not produce[~live].any() and produce.sum() > 1000
    occupied = torch.unique(cells[live])
    assert 0 in occupied.tolist() and params.num_cells - 1 in occupied.tolist()
    assert (gx - 1) * gy * gz + 3 in occupied.tolist()       # an edge cell
    assert occupied.numel() < params.num_cells // 2          # empty cells
    cnt = pk.run_plain_body("density_alpha_divergence", envs["pair_pass"],
                            fields, params)["cnt"]
    assert cnt.max() > 6 * list_cap() and (cnt[produce] == 0).any()
    # a row's run of candidates crosses several of the tiles a warp of the
    # cell-list kernel stages, and the widest window is longer than the tile
    # a block of the slab-window kernel stages
    runs = pairs.candidate_ranges(envs["pair_pass"],
                                  torch.nonzero(produce).flatten())[1]
    assert runs.max() >= 3 * constant("PASS_STAGE_CAP", "pair_pass.cu")
    assert envs["pair_slab"].lens.max() > constant("SLAB_STAGE_CAP",
                                                   "pair_slab.cu")


def brute_force(name, params, produce, fields):
    """The body summed over all pairs of real rows: no cells, no windows."""
    _, body, names, needs = pk.BODIES[name]
    comps = pairs.split({k: fields[k] for k in needs})
    n = params.n_pad
    live = fields["material"] != MATERIAL_NONE
    out = {k: torch.zeros(n) for k in names}
    rows_all = torch.nonzero(produce).flatten()
    cand = torch.arange(n)[None, :]
    for rows in rows_all.split(256):
        cx = pairs.Cx(comps, rows[:, None], cand, live[None, :],
                      params.support_radius ** 2, 3)
        res = body(cx, params, 0)
        for k in names:
            out[k][rows] = res[k]
    return out


@pytest.mark.parametrize("engine", ["pair_pass", "pair_slab"])
@pytest.mark.parametrize("name", ["density_alpha_divergence",
                                  "nonpressure_warm", "visc_prep",
                                  "visc_matvec"])
def test_pile_up_plain_matches_brute_force(pile, name, engine):
    params, _, produce, fields, envs = pile
    out = pk.run_plain_body(name, envs[engine], fields, params)
    ref = brute_force(name, params, produce, fields)
    assert set(out) == set(ref)
    for k in out:
        if k == "cnt":
            np.testing.assert_array_equal(out[k].numpy(), ref[k].numpy())
        assert float(ref[k].abs().max()) > 0
        assert_pass_close(out[k].numpy(), ref[k].numpy(), f"{engine}/{name}.{k}")
        assert not out[k][~produce].any()


@pytest.fixture(scope="module")
def pile_jax(pile):
    """The JAX package's sums on the pile-up state: its window table over the
    same sorted rows, its bodies, its executor (``pair_exec._exec_jax``, what
    ``pair_exec.run`` takes on the CPU), with slabs wide enough that no window
    is cut. ``{body: {output: (N,) or (N, 3) array}}``."""
    params, cells, _, fields, envs = pile
    live = fields["material"] != MATERIAL_NONE
    jparams = jax_make_params(
        int(live.sum()), particle_radius=params.particle_radius,
        support_radius=params.support_radius, domain_end=params.domain_end,
        pair_block=params.pair_block, pair_slab=1152, pair_chunk=2,
        has_dynamic_rigid=False)
    a, b = dataclasses.asdict(jparams), dataclasses.asdict(params)
    assert {k for k in a if a[k] != b[k]} <= TPU_SIZING | {"pair_chunk"}
    n = params.n_pad
    f = {k: jnp.asarray(v.numpy()) for k, v in fields.items()}
    zero = jnp.zeros(n, jnp.float32)
    jp = JaxParticleState(
        pos=f["pos"], vel=f["vel"], acc=jnp.zeros((n, 3), jnp.float32),
        rest_volume=f["rest_volume"], mass=f["mass"], density=f["density"],
        pressure=zero, material=f["material"], object_id=f["object_id"],
        is_dynamic=jnp.zeros(n, jnp.int32),
        rigid_rest_pos=jnp.zeros((n, 3), jnp.float32), entry_time=zero,
        entry_material=f["material"])
    jenv = jpairs.make_pair_env(jp.pos, jnp.asarray(cells.numpy()), jparams)
    assert int(jenv.overflow) == 0 and jenv.big_ids is None
    np.testing.assert_array_equal(np.asarray(jenv.lens),
                                  envs["pair_slab"].lens.numpy())
    jsl = jcommon.particle_slabs(jenv, jp, jcommon.STATIC_SLAB_KEYS)
    sums = []
    run = pair_exec.run
    pair_exec.run = lambda *args: sums.append(run(*args)) or sums[-1]
    try:
        jdfsph.density_alpha_divergence(jp, jenv, jsl, jparams)
        # without dynamic rigid bodies the object tables only give a shape
        tables = SimpleNamespace(force=jnp.zeros((1, 3)),
                                 torque=jnp.zeros((1, 3)))
        jdfsph.nonpressure_warm_fused(jp, tables, f["kappa"], jenv, jsl,
                                      jparams)
    finally:
        pair_exec.run = run
    assert len(sums) == 2
    return {name: {k: np.asarray(v) for k, v in out.items()}
            for name, out in zip(("density_alpha_divergence",
                                  "nonpressure_warm"), sums)}


@pytest.mark.parametrize("engine", ["pair_pass", "pair_slab"])
@pytest.mark.parametrize("name", ["density_alpha_divergence",
                                  "nonpressure_warm"])
def test_pile_up_plain_matches_jax(pile, pile_jax, name, engine):
    """Both plain executors on the pile-up state against the JAX package's
    sums on the same rows, neighbour counts exact."""
    params, _, produce, fields, envs = pile
    out = pk.run(name, envs[engine], fields, params)
    ref = pile_jax[name]
    assert set(out) == set(ref)
    rows = produce.numpy()
    for k in out:
        if k == "cnt":
            assert ref[k][rows].max() > 6 * list_cap()
            np.testing.assert_array_equal(out[k].numpy()[rows], ref[k][rows])
        assert np.abs(ref[k][rows]).max() > 0
        assert_pass_close(out[k].numpy()[rows], ref[k][rows],
                          f"{engine}/{name}.{k}")


def window_pieces_by_search(env):
    """What pair_slab.cu computes per row and segment: the piece
    [lower_bound(want*gz + z-1), lower_bound(want*gz + z+1 + 1)) of the
    block's window, searched over the window's cell ids; empty where the row
    of cells does not exist."""
    gx, gy, gz = env.grid
    cells = env.cells.numpy().astype(np.int64)
    n, B = env.n, env.block
    lo = np.zeros((n, 9), np.int64)
    hi = np.zeros((n, 9), np.int64)
    for i in np.nonzero(cells < gx * gy * gz)[0]:
        cz, rest = cells[i] % gz, cells[i] // gz
        cy, cx = rest % gy, rest // gy
        zlo, zhi = max(cz - 1, 0), min(cz + 1, gz - 1)
        for s, (dx, dy) in enumerate(pairs.SEGMENTS):
            x, y = cx + dx, cy + dy
            if not (0 <= x < gx and 0 <= y < gy):
                continue
            ws = int(env.starts[i // B, s])
            we = ws + int(env.lens[i // B, s])
            want = (x * gy + y) * gz
            lo[i, s] = ws + np.searchsorted(cells[ws:we], want + zlo)
            hi[i, s] = lo[i, s] + np.searchsorted(cells[lo[i, s]:we],
                                                  want + zhi + 1)
    return lo, hi


@pytest.mark.parametrize("state", ["pile_up", "box"])
def test_window_piece_is_the_cell_table_run(pile, state):
    """The slab-window kernel narrows each row to a piece of its block's
    window by cell id; that piece is exactly the run the cell-list kernel
    reads from the cell table, so the two test the same candidates in the
    same order."""
    if state == "pile_up":
        env = pile[4]["pair_slab"]
    else:
        env = Setup(box_config(), engine="pallas").tenv
    lo, hi = window_pieces_by_search(env)
    rows = torch.arange(env.n)
    # the count the smoke run takes of what the slab-window kernel tests
    piece_lo, piece_len = pairs.window_pieces(env, rows)
    np.testing.assert_array_equal(piece_len.numpy(), hi - lo)
    np.testing.assert_array_equal(piece_lo.numpy()[hi > lo], lo[hi > lo])
    run_lo, run_len = pairs.candidate_ranges(env, rows)
    run_lo, run_len = run_lo.numpy(), run_len.numpy()
    np.testing.assert_array_equal(hi - lo, run_len)
    full = run_len > 0
    assert full.sum() > 1000
    np.testing.assert_array_equal(lo[full], run_lo[full])
    # every run lies inside its block's window, so a staged tile holds it
    starts = env.starts.numpy().repeat(env.block, 0)
    ends = starts + env.lens.numpy().repeat(env.block, 0)
    assert (lo[full] >= starts[full]).all() and (hi[full] <= ends[full]).all()


_CTYPES = {"int": ctypes.c_int, "float": ctypes.c_float}


def test_pair_args_mirror_matches_header():
    """``pair_kernels.PairArgs`` against the text of ``struct PairArgs``."""
    text = re.search(r"struct PairArgs \{(.*?)\n\};", header("pair_bodies.cuh"),
                     re.S)[1]
    n_const = int(re.search(r"#define N_CONST (\d+)",
                            header("pair_bodies.cuh"))[1])
    assert n_const == pk.N_CONST
    want = []
    for line in text.splitlines():
        line = line.split("//")[0].strip().rstrip(";")
        if not line:
            continue
        if "*" in line:
            want.append((line.split("*")[1].strip(), ctypes.c_void_p))
            continue
        kind, names = line.split(None, 1)
        for name in names.split(","):
            name = name.strip()
            size = re.fullmatch(r"(\w+)\[(\w+)\]", name)
            if size:
                count = n_const if size[2] == "N_CONST" else int(size[2])
                want.append((size[1], _CTYPES[kind] * count))
            else:
                want.append((name, _CTYPES[kind]))
    got = list(pk.PairArgs._fields_)
    assert [k for k, _ in got] == [k for k, _ in want]
    for (k, a), (_, b) in zip(got, want):
        assert ctypes.sizeof(a) == ctypes.sizeof(b) and (
            a is b or (a._type_ is b._type_ and a._length_ == b._length_)), k
    assert "rows" not in dict(got)


def test_tile_and_list_sizes_are_constants_that_fit():
    """One value each for the list and the two tiles, set in the sources and
    nowhere else; the widest block's shared memory fits the 227 KB a block of
    the card can have, and the cell-list kernel's the 48 KB a kernel gets
    unasked."""
    for name in ("pair_walk.cuh", "pair_pass.cu", "pair_slab.cu"):
        assert not re.search(r"#\s*if", header(name).replace("#pragma", "")), name
    assert "stage_cap" not in header("pair_bodies.cuh")
    assert constant("MAX_BLOCK", "pair_slab.cu") == pk.SLAB_MAX_BLOCK
    lists = 4 * list_cap()
    threads = constant("PASS_THREADS", "pair_pass.cu")
    cell_list = 16 * (threads // 32) * constant("PASS_STAGE_CAP", "pair_pass.cu") \
        + lists * threads
    slab = 16 * constant("SLAB_STAGE_CAP", "pair_slab.cu") \
        + lists * pk.SLAB_MAX_BLOCK
    assert cell_list <= 48 * 1024 < slab <= 227 * 1024
    assert "cudaFuncAttributeMaxDynamicSharedMemorySize" in header("pair_slab.cu")


def test_walk_header_is_part_of_every_build(tmp_path, monkeypatch):
    """Both pair kernels include the walk, the walk includes the bodies, and
    an edit to the walk renames every built library (the bodies' header:
    tests/test_torch_slab.py)."""
    csrc = tmp_path / "csrc"
    shutil.copytree(CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    for name in pk.ENGINES:
        assert '#include "pair_walk.cuh"' in (csrc / f"{name}.cu").read_text()
    assert '#include "pair_bodies.cuh"' in (csrc / "pair_walk.cuh").read_text()
    before = [_build._target(name)[1] for name in _build.SOURCES]
    with open(csrc / "pair_walk.cuh", "a") as f:
        f.write("// edited\n")
    after = [_build._target(name)[1] for name in _build.SOURCES]
    assert all(a != b for a, b in zip(after, before))


def test_build_flags_are_fixed(monkeypatch):
    """The flags are part of the hash, keep the rounding rules, and nothing
    in the environment adds to them."""
    plain = [_build._target(name)[1] for name in _build.SOURCES]
    flags = list(_build.NVCC_FLAGS)
    assert "-fmad=false" in flags and "--use_fast_math" not in flags
    monkeypatch.setattr(_build, "NVCC_FLAGS", [*flags, "-DLIST_CAP=48"])
    assert all(a != b for a, b in zip(
        plain, [_build._target(name)[1] for name in _build.SOURCES]))
    monkeypatch.undo()
    for var in ("SPH_NVCC_FLAGS", "NVCC_FLAGS", "NVCC_APPEND_FLAGS"):
        monkeypatch.setenv(var, "--use_fast_math")
    try:
        assert importlib.reload(_build).NVCC_FLAGS == flags
    finally:
        monkeypatch.undo()
        importlib.reload(_build)

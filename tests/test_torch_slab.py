"""The port's slab-window pair engine against the JAX package's.

On the CPU the JAX package's default engine is its slab engine
(``ops/pairs.make_pair_env`` windows, run by ``pair_exec._exec_jax``), and the
TPU kernel itself (``pair_exec._exec_pallas``) runs in Pallas interpret mode.
The port's ``pairs.make_slab_env`` and ``pairs.run_plain_slab`` are held to
both on the small domain-box scene with blocks of 64 rows, and to the port's
own cell-list engine on the same state.

Tolerance: max|a - b| <= 2e-5 * max(1, max|b|), as tests/test_torch_pairs.py;
neighbour counts and window lengths are compared exactly.
"""
import dataclasses
import shutil

import numpy as np
import pytest
import torch

from sph_project_tpu.ops import pair_exec
from sph_project_tpu.solvers import dfsph as jdfsph

from sph_project_tpu_torch import sim as tsim
from sph_project_tpu_torch.ops import pair_kernels
from sph_project_tpu_torch.ops import pairs as tpairs
from sph_project_tpu_torch.rigid.integrator import channel_table
from sph_project_tpu_torch.solvers import common as tcommon

import test_torch_pairs as cell_tests
from test_torch_pairs import Setup, assert_pass_close
from test_torch_scene import box_config, load_both


@pytest.fixture(scope="module")
def slab():
    s = Setup(box_config(), engine="pallas")
    assert isinstance(s.tenv, tpairs.SlabEnv)
    return s


def test_window_table_matches_jax(slab):
    """Same blocks, same windows: the port's stable sort of the bridged state
    is the identity, so block b holds the same rows in both packages."""
    n, B = slab.params.n_pad, slab.params.pair_block
    np.testing.assert_array_equal(slab.perm, np.arange(n))
    env, jenv = slab.tenv, slab.jenv
    assert env.block == B == 64 and env.nb == jenv.nb == n // B
    assert int(jenv.overflow) == 0
    np.testing.assert_array_equal(env.lens.numpy(), np.asarray(jenv.lens))
    np.testing.assert_array_equal(env.rows.numpy(), np.asarray(jenv.rows))
    # the JAX side clamps a start so that its fixed-width slab fits the array
    # (empty windows start at n): equal wherever it did not clamp
    S = jenv.slab_width // 9
    starts, jstarts = env.starts.numpy(), np.asarray(jenv.starts)
    free = starts <= n - S
    assert free[env.lens.numpy() > 0].sum() > 100
    np.testing.assert_array_equal(starts[free], jstarts[free])
    np.testing.assert_array_equal(jstarts[~free], max(n - S, 0))
    # blocks of sentinel rows only have empty windows
    dead = (slab.cells.numpy() == slab.params.num_cells).reshape(-1, B).all(1)
    assert dead.any() and (env.lens.numpy()[dead] == 0).all()


# every pass of tests/test_torch_pairs.py again, now run_plain_slab against
# the JAX pass on the JAX slab env
@pytest.mark.parametrize("check,args", [
    (cell_tests.test_density_pass, ()),
    (cell_tests.test_alpha_pass, ()),
    (cell_tests.test_nonpressure_pass, ()),
    (cell_tests.test_divergence_pass, (False,)),
    (cell_tests.test_divergence_pass, (True,)),
    (cell_tests.test_correction_pass, ()),
    (cell_tests.test_density_alpha_divergence_pass, ()),
    (cell_tests.test_nonpressure_warm_pass, ()),
], ids=["density", "alpha", "nonpressure", "divergence", "divergence_count",
        "correction", "density_alpha_divergence", "nonpressure_warm"])
def test_slab_pass_matches_jax(slab, check, args):
    check(slab, *args)


def test_slab_pass_matches_pallas_kernel(monkeypatch):
    """The TPU kernel itself: ``_exec_pallas`` in interpret mode on what
    ``prepare_inputs`` hands it, with slabs of 256, the least width that cuts
    no window of a fluid block here (W = 2304 in three tiles of 768 lanes, so
    the accumulation across tiles runs)."""
    s = Setup(box_config(), engine="pallas", pair_slab=256)
    assert int(s.jenv.overflow) == 0 and s.jenv.slab_width == 9 * 256
    assert s.jenv.big_ids is None
    tiles = []

    def through_pallas(kern, blocks, slabs_c, meta, row_off, params):
        tiles.append(meta["jidx"].shape[1])
        return pair_exec._exec_pallas(kern, blocks, slabs_c, meta, row_off,
                                      params, interpret=True)

    monkeypatch.setattr(pair_exec, "_exec_jax", through_pallas)
    jout = jdfsph.density_alpha_divergence(s.jp, s.jenv, s.jsl, s.jparams)
    assert tiles == [2304]
    cell_tests._check_dad(s, jout)


def _fields(s):
    """The fields of every body; those of WCSPH, PCISPH and IISPH, the body
    coms and the CG vector made from a seed with numpy."""
    p = s.tp
    n = s.params.n_pad
    rng = np.random.default_rng(6)

    def seeded(x):
        return torch.from_numpy(x.astype(np.float32))

    pressure = seeded(rng.uniform(0.0, 5000.0, n))
    rho2 = torch.clamp_min(p.density * p.density, 1e-12)
    return {"pos": p.pos, "vel": p.vel, "material": p.material,
            "mass": p.mass, "rest_volume": p.rest_volume,
            "inv_rho": tcommon._inv_rho(p), "object_id": p.object_id,
            "kappa": s.kappa,
            "k_rho": s.kappa / torch.clamp_min(p.density, 1e-12),
            "pressure": pressure, "density": p.density,
            "p_rho2": pressure / rho2,
            "dpi": s.params.density0 * p.rest_volume / rho2,
            "inv_star2": 1.0 / seeded(rng.uniform(900.0, 1100.0, n)) ** 2,
            "pred": p.pos + seeded(rng.uniform(-0.003, 0.003, (n, 3))),
            "dii": seeded(rng.normal(0.0, 1e-2, (n, 3))),
            "dij_pj": seeded(rng.normal(0.0, 10.0, (n, 3))),
            "is_dynamic": p.is_dynamic,
            "com": seeded(rng.uniform(0.0, 0.3, (s.params.max_objects, 3))),
            "chan": channel_table(s.trigid, s.params),
            "x": seeded(rng.normal(0.0, 0.5, (n, 3))),
            "lam": seeded(rng.normal(0.0, 1e-3, n))}


@pytest.mark.parametrize("name", list(pair_kernels.BODIES))
def test_slab_matches_cell_list(slab, name):
    """The two engines of the port on one state: equal neighbour counts, sums
    within the tolerance."""
    cell_env = tpairs.make_pair_env(slab.cells, slab.produce, slab.params)
    produce = slab.tp.material == 2 if name == "rigid_volume" else None
    flags = 1 if name in ("divergence", "pbf_density") else 0
    out = [pair_kernels.run_plain_body(name, env, _fields(slab), slab.params,
                                       produce, flags)
           for env in (slab.tenv, cell_env)]
    for k in out[0]:
        if k == "cnt":
            assert out[0][k].sum() > 0
            np.testing.assert_array_equal(out[0][k].numpy(), out[1][k].numpy())
        assert_pass_close(out[0][k].numpy(), out[1][k].numpy(), f"{name}.{k}")


def test_engine_selection():
    """``pair_backend`` picks the engine by the JAX package's names."""
    params = load_both(box_config())[2].params
    for backend, engine in (("auto", "pallas_dma"), ("pallas_dma", "pallas_dma"),
                            ("pallas", "pallas")):
        assert dataclasses.replace(
            params, pair_backend=backend).resolved_pair_backend() == engine
    with pytest.raises(ValueError, match="cpu"):
        dataclasses.replace(params, pair_backend="jax").resolved_pair_backend()
    cells = torch.zeros(params.n_pad, dtype=torch.int32)
    produce = torch.zeros(params.n_pad, dtype=torch.bool)
    assert type(tsim.build_env(cells, produce, params)) is tpairs.PairEnv
    env = tpairs.make_slab_env(cells, produce, dataclasses.replace(
        params, pair_block=1024))
    with pytest.raises(ValueError, match="512"):
        pair_kernels.run_cuda("density", env, {}, params)


def test_shared_header_is_part_of_every_build(tmp_path, monkeypatch):
    """The built library's name hashes the source and the shared header, so an
    edit to a body in ``pair_bodies.cuh`` rebuilds both pair kernels."""
    from sph_project_tpu_torch.ops import _build
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", str(csrc))
    engines = tuple(pair_kernels.ENGINES)
    assert set(engines) <= set(_build.SOURCES)
    for name in engines:
        assert '#include "pair_bodies.cuh"' in (csrc / f"{name}.cu").read_text()
    before = [_build._target(name)[1] for name in engines]
    assert before == [_build._target(name)[1] for name in engines]
    with open(csrc / "pair_bodies.cuh", "a") as f:
        f.write("// edited\n")
    after = [_build._target(name)[1] for name in engines]
    assert all(a != b for a, b in zip(after, before))

"""The parts of the port's spatial decomposition, each on its own.

- ``halo_extend`` at D = 4 against the JAX package's ``halo_extend`` under
  ``shard_map`` on the conftest mesh: bit-equal, zeros at the mesh's ends,
  dtypes kept;
- the halo coverage shortfall on a layout built to be short by a known
  count at every rank boundary;
- the global resort at D = 4 against ``sim.sort_state`` on one device, of a
  state whose rows were shuffled: every carried array bit-equal, int dtypes
  kept, and the sorted cell ids;
- the windows of the slab-window environment over an extended layout (halo
  sentinels: -1 in front, ``num_cells`` at the back) against the JAX
  package's ``pairs.make_pair_env``'s, and no candidate range for a sentinel
  row;
- the particle-axis sharding (``parallel/sharding.py``) at D = 2 against one
  device, every array bit-equal.

The ranks (``parallel/launch.py``, gloo over the CPU) start once per module.
"""
import dataclasses
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from test_torch_scene import ROOT  # noqa: F401  (one torch thread a process)
from test_torch_spatial import (ENGINE, cube_config, dam, entry_config,
                                single_device)

from sph_project_tpu.ops import pairs as jpairs
from sph_project_tpu.parallel import spatial as jspatial
from sph_project_tpu.scene import load_scene as jax_load_scene
from sph_project_tpu.utils.config import SimConfig as JaxSimConfig

from sph_project_tpu_torch import bridge
from sph_project_tpu_torch import sim as tsim
from sph_project_tpu_torch.ops import pairs
from sph_project_tpu_torch.parallel import launch, sharding

D = 4
N_LOCAL = 256
HALO = 64


def resort_case(tmp_dir):
    """The cube scene with every carried array the sort can move: a body's
    rest positions, a deferred block's entry time and material, the warm
    starts' carries and the implicit viscosity's ``visc_x``."""
    cfg = cube_config(tmp_dir)
    cfg["Configuration"].update(dfsphWarmStart=True, dfsphWarmStartDiv=True,
                                viscosityMethod="implicit", viscosity=50.0)
    cfg["FluidBlocks"].append(dict(entry_config()["FluidBlocks"][1],
                                   objectId=2))
    return dict(config=cfg, overrides=dict(ENGINE))


def halo_inputs():
    rng = np.random.default_rng(7)
    n = D * N_LOCAL
    return {"vec": rng.normal(size=(n, 3)).astype(np.float32),
            "ids": rng.integers(-5, 1000, n).astype(np.int32)}


def short_layout(params):
    """Sorted cell ids over D ranks of N_LOCAL rows under ``params``' grid,
    and the count the halo of HALO rows misses. A neighbour's stencil reaches
    ``reach`` cells back and forth in flat order. Rank r's rows lie one a
    cell from ``r * 4 * reach + reach`` on, but for a run of rows in one cell
    at each end: its last ``tail[r]`` rows sit within ``reach`` of rank
    r + 1's first cell, its first ``head[r]`` rows within ``reach`` of rank
    r - 1's last; the last rank ends in rows of no cell (``num_cells``),
    which no rank needs."""
    g = params.grid_num
    reach = g[1] * g[2] + g[2] + 1
    tail = (100, 64, 80)          # rows of ranks 0-2 rank r + 1 reaches
    head = (0, 90, 30, 120)       # rows of ranks 1-3 rank r - 1 reaches
    cells = []
    for r in range(D):
        base = r * 4 * reach
        c = base + reach + 1 + np.arange(N_LOCAL)
        c[:head[r]] = base + 1
        if r < D - 1:
            c[N_LOCAL - tail[r]:] = base + 4 * reach - reach // 2
        cells.append(c)
    cells = np.concatenate(cells).astype(np.int32)
    assert (np.diff(cells) >= 0).all() and cells.max() < params.num_cells
    cells[-20:] = params.num_cells
    missed = sum(max(t - HALO, 0) for t in tail) + \
        sum(max(h - HALO, 0) for h in head)
    return cells, missed


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """The probes at D = 4 and the particle-axis sharding at D = 2, started
    together; the scenes and scene parameters they use."""
    tmp = str(tmp_path_factory.mktemp("parts"))
    case = resort_case(tmp)
    scene, _ = launch.load_case(case)
    # the dam in a domain long enough in x for four ranks' layouts
    wide = dict(config=dam(domainEnd=[1.2, 0.5, 0.5]), overrides={})
    cells, missed = short_layout(launch.load_case(wide)[0].params)
    n_pad = scene.params.n_pad
    probes = [dict(name="halo_vec", kind="halo", x=halo_inputs()["vec"],
                   H=HALO),
              dict(name="halo_ids", kind="halo", x=halo_inputs()["ids"],
                   H=HALO),
              dict(name="shortfall", kind="shortfall", case=wide,
                   cells=cells, H=HALO),
              dict(name="resort", kind="resort", case=case,
                   perm=np.random.default_rng(3).permutation(n_pad))]
    sharded = dict(name="sharded", mode="sharded",
                   config=dam(dfsphWarmStart=True), overrides=dict(ENGINE),
                   steps=2)
    pool = ThreadPoolExecutor(2)
    jobs = [pool.submit(launch.launch,
                        "sph_project_tpu_torch.parallel.launch:run_probes", D,
                        dict(probes=probes, out_dir=os.path.join(tmp, "p")),
                        os.path.join(tmp, "p"), device="cpu"),
            pool.submit(launch.launch,
                        "sph_project_tpu_torch.parallel.launch:run_cases", 2,
                        dict(cases=[sharded], out_dir=os.path.join(tmp, "s")),
                        os.path.join(tmp, "s"), device="cpu")]
    for j in jobs:
        j.result()
    pool.shutdown()
    out = []
    for r in range(D):
        with open(os.path.join(tmp, "p", f"probes.rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return dict(probes=out, case=case, perm=probes[3]["perm"], missed=missed,
                sharded=launch.gather_results(os.path.join(tmp, "s"),
                                              "sharded", 2),
                sharded_case=sharded)


@pytest.mark.parametrize("field", ["vec", "ids"])
def test_halo_extend_matches_jax(ranks, field):
    x = halo_inputs()[field]
    mesh = jspatial.make_mesh(D)
    want = np.asarray(jax.jit(jax.shard_map(
        lambda v: jspatial.halo_extend(v, HALO, jspatial.AXIS), mesh=mesh,
        in_specs=P(jspatial.AXIS), out_specs=P(jspatial.AXIS),
        check_vma=False))(jnp.asarray(x)))
    got = np.concatenate([p[f"halo_{field}"] for p in ranks["probes"]])
    assert got.dtype == x.dtype and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    ext = N_LOCAL + 2 * HALO
    assert not got[:HALO].any() and not got[-HALO:].any()
    # an interior rank: its left's tail, its own rows, its right's head
    np.testing.assert_array_equal(
        got[ext:2 * ext],
        np.concatenate([x[N_LOCAL - HALO:N_LOCAL], x[N_LOCAL:2 * N_LOCAL],
                        x[2 * N_LOCAL:2 * N_LOCAL + HALO]]))


def test_halo_shortfall_counts_missed_rows(ranks):
    got = sum(p["shortfall"] for p in ranks["probes"])
    assert ranks["missed"] > 0
    assert got == ranks["missed"]


def test_global_resort_matches_sort_state(ranks):
    case = ranks["case"]
    scene, state = launch.load_case(case)
    perm = torch.from_numpy(ranks["perm"])
    arrays = dict(bridge.walk(state))
    for path in sharding.particle_paths(state):
        arrays[path] = arrays[path][perm]
    want, cells, _ = tsim.sort_state(bridge.build(arrays), scene.params)
    want = bridge.state_to_numpy(want)
    keys, extras = tsim.permuted_keys(scene.params)
    assert {"rigid_rest_pos", "entry_time", "entry_material"} <= set(keys)
    assert {"visc_x", "dfsph_kappa", "dfsph_kappa_v"} <= set(extras)
    for k, v in want.items():
        if v.ndim >= 1 and (k.startswith("particles.") or "." not in k):
            got = np.concatenate([p["resort"][k] for p in ranks["probes"]])
        else:
            got = ranks["probes"][0]["resort"][k]
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)
    np.testing.assert_array_equal(
        np.concatenate([p["resort"]["cells"] for p in ranks["probes"]]),
        cells.numpy())
    assert not np.array_equal(ranks["perm"], np.arange(len(ranks["perm"])))


def test_slab_windows_over_halo_sentinels_match_jax():
    """Rank 0's and the last rank's extended layouts at once: H rows of -1
    in front and of ``num_cells`` at the back of the sorted dam."""
    cfg = dam()
    block = 64
    tscene, tstate = launch.load_case(dict(config=cfg, overrides=dict(
        ENGINE, pair_backend="pallas")))
    params = tscene.params
    st, cells, _ = tsim.sort_state(tstate, params)
    H = 2 * block
    n = params.n_pad + 2 * H
    ext = torch.cat([torch.full((H,), -1, dtype=torch.int32), cells,
                     torch.full((H,), params.num_cells, dtype=torch.int32)])
    pos = torch.cat([torch.zeros(H, 3), st.particles.pos, torch.zeros(H, 3)])
    produce = torch.zeros(n, dtype=torch.bool)
    produce[H:n - H] = tsim.produces_output(st.particles, st.rigid, params)
    env = pairs.make_slab_env(ext, produce, params)
    _, _, ok = pairs._ranges(env, torch.arange(n))
    assert not ok[:H].any() and not ok[n - H:].any()
    lo, ln = pairs.window_pieces(env, torch.arange(n))
    assert not ln[:H].any() and not ln[n - H:].any()

    jscene, _ = jax_load_scene(config=JaxSimConfig(config=cfg), **ENGINE)
    jparams = dataclasses.replace(jscene.params, pair_slab=n,
                                  pair_slab_big=0)
    jenv = jpairs.make_pair_env(jnp.asarray(pos.numpy()),
                                jnp.asarray(ext.numpy()), jparams)
    assert int(jenv.overflow) == 0
    lens = env.lens.numpy()
    np.testing.assert_array_equal(lens, np.asarray(jenv.lens))
    # with a window cap of every row, the JAX window's valid columns are
    # [its start, its end)
    valid = np.asarray(jenv.valid).reshape(lens.shape + (n,))
    first = np.where(valid.any(-1), valid.argmax(-1), -1)
    starts = env.starts.numpy()
    np.testing.assert_array_equal(np.where(lens > 0, starts, -1),
                                  np.where(lens > 0, first, -1))
    assert lens[: H // block].sum() == 0 and lens[-(H // block):].sum() == 0
    assert (lens > 0).any()


def test_sharded_matches_single_device(ranks):
    case = ranks["sharded_case"]
    state, diags, _ = single_device(case["config"], {}, case["steps"])
    res = ranks["sharded"]
    assert res["ranks"][0]["diags"] == diags
    for k, v in bridge.state_to_numpy(
            state.replace(cached_neighbors=None)).items():
        assert res["rows"][k].dtype == v.dtype, k
        np.testing.assert_array_equal(res["rows"][k], v, err_msg=k)

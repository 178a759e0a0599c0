"""The spatial decomposition's exact, fixed-shape resort and its captured
step class, on the CPU over gloo (``parallel/launch.py``).

- ``global_resort`` at D = 1, 2 and 4 against ``sim.sort_state`` on one
  device, on tests/test_torch_spatial_parts.py's cube scene (every carried
  array the sort moves) with its rows rotated by half the state and then
  some (most rows change rank) and with its rows shuffled: every array
  bit-equal, int dtypes kept, and the sorted cell ids.
- The resort's collectives have the same shapes for both states: one
  all-gather of the (n_pad, W) int32 buffer of every rank's packed rows,
  nothing sized by the data.
- ``spatial.SpatialSimulation``, which steps eagerly under gloo, against
  ``spatial_step_fn`` from the same state at D = 2, 3 steps of the dam:
  diagnostics equal and every rank's rows bit-equal.
- A capture asked for under gloo raises; ``collectives.capturable`` says
  NCCL on the card, past one rank with NCCL's graph-mixing support off.

On the card, ``chip_smoke.py`` phase 9 holds the captured step (world size 1
over NCCL) bit-equal to the eager one and to one device, and
``tools/spatial_multicard.py`` does so on four cards.
"""
import os
import pickle
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from test_torch_scene import ROOT  # noqa: F401  (one torch thread a process)
from test_torch_spatial import ENGINE, dam
from test_torch_spatial_parts import resort_case

from sph_project_tpu_torch import bridge
from sph_project_tpu_torch import sim as tsim
from sph_project_tpu_torch.parallel import collectives, launch, sharding
from sph_project_tpu_torch.parallel import spatial

SIZES = (1, 2, 4)
ORDERS = ("shifted", "shuffled")
CLASS_D = 2
CLASS_STEPS = 3


def row_order(kind, n):
    if kind == "shifted":
        return np.roll(np.arange(n), n // 2 + 17)
    return np.random.default_rng(11).permutation(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The resort probes at every D and the step class at D = 2, started
    together; returns the case and, by D, every rank's probe results."""
    tmp = str(tmp_path_factory.mktemp("resort"))
    case = resort_case(tmp)
    n_pad = launch.load_case(case)[0].params.n_pad
    step_case = dict(config=dam(), overrides=dict(ENGINE))
    jobs = {}
    with ThreadPoolExecutor(len(SIZES)) as pool:
        for D in SIZES:
            probes = [dict(name=kind, kind="resort", case=case,
                           perm=row_order(kind, n_pad)) for kind in ORDERS]
            if D == CLASS_D:
                probes.append(dict(name="step_class", kind="step_class",
                                   case=step_case, steps=CLASS_STEPS))
            out = os.path.join(tmp, f"d{D}")
            jobs[D] = pool.submit(
                launch.launch,
                "sph_project_tpu_torch.parallel.launch:run_probes", D,
                dict(probes=probes, out_dir=out), out, device="cpu")
        for j in jobs.values():
            j.result()
    res = {}
    for D in SIZES:
        res[D] = []
        for r in range(D):
            with open(os.path.join(tmp, f"d{D}", f"probes.rank{r}.pkl"),
                      "rb") as f:
                res[D].append(pickle.load(f))
    return dict(case=case, step_case=step_case, ranks=res)


@pytest.mark.parametrize("kind", ORDERS)
@pytest.mark.parametrize("D", SIZES)
def test_global_resort_matches_sort_state(runs, D, kind):
    scene, state = launch.load_case(runs["case"])
    n = scene.params.n_pad
    order = torch.from_numpy(row_order(kind, n))
    arrays = dict(bridge.walk(state))
    for path in sharding.particle_paths(state):
        arrays[path] = arrays[path][order]
    want, cells, perm = tsim.sort_state(bridge.build(arrays), scene.params)
    if D > 1 and kind == "shifted":
        # sorted row j came from row perm[j]: most rows change rank
        nl = n // D
        moved = (perm.numpy() // nl) != (np.arange(n) // nl)
        assert moved.mean() > 0.5
    probes = [p[kind] for p in runs["ranks"][D]]
    for k, v in bridge.state_to_numpy(want).items():
        if v.ndim >= 1 and (k.startswith("particles.") or "." not in k):
            got = np.concatenate([p[k] for p in probes])
        else:
            got = probes[0][k]
        assert got.dtype == v.dtype, k
        np.testing.assert_array_equal(got, v, err_msg=k)
    np.testing.assert_array_equal(
        np.concatenate([p["cells"] for p in probes]), cells.numpy())


@pytest.mark.parametrize("D", SIZES)
def test_global_resort_shapes_do_not_depend_on_data(runs, D):
    scene, state = launch.load_case(runs["case"])
    params = scene.params
    keys, extras = tsim.permuted_keys(params)
    p = state.particles
    # the cell id, then each carried array's 32-bit words a row
    words = 1 + sum(getattr(p, k)[0].numel() for k in keys) + \
        sum(getattr(state, k)[0].numel() for k in extras)
    want = [dict(op="all_gather", shape=(params.n_pad, words),
                 dtype="torch.int32",
                 recv_bytes=(D - 1) * params.n_pad // D * words * 4)]
    for rank in runs["ranks"][D]:
        for kind in ORDERS:
            assert rank[kind]["traffic"] == want, kind


def test_spatial_simulation_matches_step_fn(runs):
    ranks = runs["ranks"][CLASS_D]
    for rank in ranks:
        res = rank["step_class"]
        assert len(res["class"]) == CLASS_STEPS
        assert res["class"] == res["step_fn"]
        for k, v in res["step_fn_rows"].items():
            got = res["class_rows"][k]
            assert got.dtype == v.dtype, k
            np.testing.assert_array_equal(got, v, err_msg=k)
    # the ranks agree on the global diagnostics
    assert ranks[0]["step_class"]["class"] == ranks[1]["step_class"]["class"]


def test_capture_under_gloo_raises():
    scene, state = launch.load_case(dict(config=dam(),
                                         overrides=dict(ENGINE)))
    mesh = collectives.Mesh(rank=0, size=1, device=torch.device("cpu"),
                            group=None, backend="gloo")
    with pytest.raises(ValueError, match="cannot be captured"):
        spatial.SpatialSimulation(scene, state, mesh, capture=True)


@pytest.mark.parametrize("backend, device, size, mixing, want", [
    ("nccl", "cuda", 1, None, True), ("nccl", "cuda", 4, None, False),
    ("nccl", "cuda", 4, "1", False), ("nccl", "cuda", 4, "0", True),
    ("gloo", "cuda", 1, "0", False), ("gloo", "cpu", 4, "0", False)])
def test_capturable_is_nccl_on_the_card(backend, device, size, mixing, want,
                                        monkeypatch):
    """NCCL on the card; past one rank only with NCCL's graph-mixing
    support off."""
    if mixing is None:
        monkeypatch.delenv("NCCL_GRAPH_MIXING_SUPPORT", raising=False)
    else:
        monkeypatch.setenv("NCCL_GRAPH_MIXING_SUPPORT", mixing)
    mesh = collectives.Mesh(rank=0, size=size, device=torch.device(device),
                            group=None, backend=backend)
    assert collectives.capturable(mesh) is want

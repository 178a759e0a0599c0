"""Start the ranks of the multi-device path: one function in D processes.

:func:`launch` writes the call to a file in ``run_dir`` and starts D fresh
interpreters, ``python -m sph_project_tpu_torch.parallel.launch <call>
<rank>``. Each joins the process group through a file store in ``run_dir``
(:func:`init`), selects its card (``rank % device_count``: its own on a host
with D cards, all the same one on a host with one) or, with
``device="cpu"``, one thread, runs the function and leaves the group. The
ranks run on the card unless the caller asks for the CPU: over NCCL there,
unless ``backend`` is given, and over gloo on the CPU; without CUDA the
default raises. The parent waits for all of
them and raises if one fails or the time runs out, after stopping the rest;
each rank's output is in ``run_dir/rank<r>.log``. It is the counterpart of
the JAX package's 8-device virtual CPU mesh: the ranks are real processes,
which talk through gloo on the CPU and through NCCL between cards.

The functions a rank runs live here, in the port, so a rank imports no test
module and nothing of JAX. :func:`run_cases` loads scenes, prepares each on
the rank's device, shards it and steps it through the spatial (or the
particle-axis) decomposition, and writes every rank's rows, diagnostics,
halo, step times and kernel launches to ``out_dir``; :func:`run_probes`
runs the decomposition's parts (the halo exchange, the shortfall count, the
global resort) on given data.
"""
from __future__ import annotations

import dataclasses
import os
import pickle
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def init(backend: str, rank: int, world_size: int, store: str) -> None:
    """Join the default process group through the file store ``store``."""
    dist.init_process_group(backend, init_method=f"file://{store}",
                            rank=rank, world_size=world_size)


def launch(target: str, world_size: int, kwargs: dict, run_dir: str,
           backend: str | None = None, device: str = "cuda",
           timeout: float = 600.0) -> None:
    """Run ``target`` (``"module:function"``) as ``function(rank,
    world_size, device=device, **kwargs)`` in ``world_size`` processes on
    ``device`` over a ``backend`` group (NCCL on the card, gloo on the CPU,
    unless given)."""
    if device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("launch(device='cuda'): CUDA is not available on "
                           "this host; pass device='cpu'")
    if backend is None:
        backend = "nccl" if device == "cuda" else "gloo"
    os.makedirs(run_dir, exist_ok=True)
    store = os.path.join(run_dir, "store")
    if os.path.exists(store):
        os.remove(store)
    call = os.path.join(run_dir, "call.pkl")
    with open(call, "wb") as f:
        pickle.dump(dict(target=target, world_size=world_size, kwargs=kwargs,
                         backend=backend, device=device, store=store), f)
    env = dict(os.environ, PYTHONPATH=_ROOT)
    if device == "cpu":
        env["OMP_NUM_THREADS"] = "1"
    procs, logs = [], []
    try:
        for rank in range(world_size):
            log = open(os.path.join(run_dir, f"rank{rank}.log"), "w")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", __name__, call, str(rank)], cwd=_ROOT,
                env=env, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            failed = [p for p in procs if p.poll() not in (None, 0)]
            if failed or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    bad = [r for r, p in enumerate(procs) if p.returncode != 0]
    if bad:
        tails = []
        for r in bad:
            with open(os.path.join(run_dir, f"rank{r}.log")) as f:
                tails.append(f"rank {r} (exit {procs[r].returncode}):\n"
                             + f.read()[-3000:])
        raise RuntimeError(f"{target} on {world_size} ranks failed:\n"
                           + "\n".join(tails))


def _main(call: str, rank: int) -> None:
    with open(call, "rb") as f:
        c = pickle.load(f)
    if c["device"] == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        torch.set_num_threads(max(1, (os.cpu_count() or 1)
                                  // c["world_size"]))
    else:
        torch.set_num_threads(1)
    init(c["backend"], rank, c["world_size"], c["store"])
    module, name = c["target"].split(":")
    fn = getattr(__import__(module, fromlist=[name]), name)
    try:
        fn(rank, c["world_size"], device=c["device"], **c["kwargs"])
    finally:
        dist.destroy_process_group()


# ---- rank functions ---------------------------------------------------------

def foreign_modules() -> list:
    """Loaded modules of JAX or of the JAX package: none, in the port."""
    return sorted(m for m in sys.modules if m.split(".")[0] in
                  ("jax", "jaxlib", "flax", "sph_project_tpu"))


def kernel_counts() -> dict:
    """Every kernel launch counter of the port (pair kernels, gather)."""
    from ..ops import pair_kernels
    from ..ops import permute as permlib
    return {**pair_kernels.launches, **permlib.launches}


def zero_kernel_counts() -> None:
    from ..ops import pair_kernels
    from ..ops import permute as permlib
    for d in (pair_kernels.launches, permlib.launches):
        for k in d:
            d[k] = 0


def load_case(case: dict):
    """(scene, state) of a case: ``scene`` a file or ``config`` a scene
    dict, with ``overrides`` for ``load_scene``."""
    from ..scene import load_scene
    from ..utils.config import SimConfig
    if case.get("config") is not None:
        return load_scene(config=SimConfig(config=case["config"]),
                          **case.get("overrides", {}))
    return load_scene(case["scene"], **case.get("overrides", {}))


def _numbers(diag: dict) -> dict:
    return {k: v.item() for k, v in diag.items()}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def run_cases(rank: int, world_size: int, cases: list, out_dir: str,
              device: str = "cuda") -> None:
    """Each case prepared on this rank's device from the whole scene, sharded
    and stepped ``case["steps"]`` times through ``spatial_step_fn`` (or,
    with ``mode="sharded"``, sharded, prepared and stepped through
    ``parallel/sharding.py``); writes
    ``<out_dir>/<name>.rank<r>.pkl``: this rank's rows and the body tables
    (``rows``, numpy by ``bridge`` name), the diagnostics, CG iterations
    (implicit viscosity) and wall ms of every step, the halo ``H`` and this
    rank's shortfall at the last state, the kernel launches of the steps,
    the backend and the foreign modules loaded."""
    from .. import bridge
    from .. import sim as simlib
    from ..solvers import viscosity_cg
    from . import sharding, spatial
    os.makedirs(out_dir, exist_ok=True)
    for case in cases:
        spatial_mode = case.get("mode", "spatial") == "spatial"
        mesh = (spatial.make_mesh(device) if spatial_mode
                else sharding.make_mesh(device))
        scene, state = load_case(case)
        params = scene.params
        if spatial_mode:
            state = simlib.prepare(state.to(mesh.device), params)
            state = spatial.shard_state(state, mesh, params)
            step = spatial.spatial_step_fn(params, mesh)
        else:
            state = sharding.shard_state(state, mesh, params)
            state = sharding.sharded_prepare_fn(params, mesh)(state)
            step = sharding.sharded_step_fn(params, mesh)
        diags, ms, cg = [], [], []
        zero_kernel_counts()
        for _ in range(case["steps"]):
            _sync(mesh.device)
            t0 = time.perf_counter()
            state, diag = step(state)
            _sync(mesh.device)
            ms.append((time.perf_counter() - t0) * 1e3)
            diags.append(_numbers(diag))
            if params.viscosity_method == "implicit":
                cg.append(int(viscosity_cg.last_solve["cg_iters"]))
        counts = {k: v for k, v in kernel_counts().items() if v}
        H = shortfall = 0
        if spatial_mode:
            # this rank's halo and its shortfall at the state the steps left
            params_sp = dataclasses.replace(params, spmd_axis=mesh.axis)
            st = spatial.global_resort(state, params_sp, mesh)
            _, env = spatial.SpatialPlumbing.neighbor_prep(st, params_sp)
            H, shortfall = env.halo, int(env.halo_shortfall)
        state = state.replace(cached_neighbors=None)
        res = dict(rows=bridge.state_to_numpy(state), diags=diags, ms=ms,
                   cg_iters=cg, launches=counts, foreign=foreign_modules(),
                   backend=mesh.backend, n_pad=params.n_pad, H=H,
                   shortfall=shortfall)
        _write(out_dir, f"{case['name']}.rank{rank}.pkl", res)


def run_probes(rank: int, world_size: int, probes: list, out_dir: str,
               device: str = "cuda") -> None:
    """The parts of the spatial decomposition on given data; writes
    ``<out_dir>/probes.rank<r>.pkl``, a dict by probe name. Each probe is a
    dict with ``name`` and ``kind``:

    - ``"halo"``: ``halo_extend`` of this rank's slice of ``x`` (a numpy
      array over every rank's rows) by ``H`` rows;
    - ``"shortfall"``: the halo coverage shortfall of this rank's slice of
      the sorted cell ids ``cells`` at halo ``H``, under the grid of the
      scene ``case`` (see :func:`load_case`);
    - ``"resort"``: the scene ``case`` as loaded, its particle rows
      reordered by ``perm``, sharded and put through ``global_resort``: this
      rank's rows (``bridge`` names) and sorted cell ids (``"cells"``)."""
    from .. import bridge
    from . import collectives, sharding, spatial
    mesh = spatial.make_mesh(device)
    collectives.bind(mesh)
    dev = mesh.device
    out = {}
    for pr in probes:
        kind = pr["kind"]
        if kind == "halo":
            x = torch.from_numpy(pr["x"])
            nl = x.shape[0] // world_size
            out[pr["name"]] = spatial.halo_extend(
                x[rank * nl:(rank + 1) * nl].to(dev), pr["H"],
                mesh).cpu().numpy()
            continue
        scene, state = load_case(pr["case"])
        params = dataclasses.replace(scene.params, spmd_axis=mesh.axis)
        if kind == "shortfall":
            cells = torch.from_numpy(pr["cells"])
            nl = cells.shape[0] // world_size
            out[pr["name"]] = int(spatial.SpatialPlumbing.
                                  _halo_coverage_shortfall(
                                      cells[rank * nl:(rank + 1) * nl].to(dev),
                                      pr["H"], params))
        elif kind == "resort":
            perm = torch.from_numpy(pr["perm"])
            arrays = dict(bridge.walk(state))
            for path in sharding.particle_paths(state):
                arrays[path] = arrays[path][perm]
            state = sharding.shard_state(bridge.build(arrays), mesh, params)
            state = spatial.global_resort(state, params, mesh)
            rows = bridge.state_to_numpy(state.replace(cached_neighbors=None))
            rows["cells"] = state.cached_neighbors.cpu().numpy()
            out[pr["name"]] = rows
        else:
            raise ValueError(f"unknown probe kind {kind!r}")
    _write(out_dir, f"probes.rank{rank}.pkl", out)


def _write(out_dir: str, name: str, obj) -> None:
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, name), "wb") as f:
        pickle.dump(obj, f)


def gather_results(out_dir: str, name: str, world_size: int) -> dict:
    """The results :func:`run_cases` wrote for case ``name``: per-rank
    entries as lists (``ranks``), and ``rows``, every rank's per-particle
    rows concatenated in rank order, the body tables and scalars of rank
    0."""
    ranks = []
    for r in range(world_size):
        with open(os.path.join(out_dir, f"{name}.rank{r}.pkl"), "rb") as f:
            ranks.append(pickle.load(f))
    rows = dict(ranks[0]["rows"])
    for k, v in rows.items():
        if v.ndim >= 1 and (k.startswith("particles.") or "." not in k):
            rows[k] = np.concatenate([res["rows"][k] for res in ranks])
    return dict(rows=rows, ranks=ranks)


if __name__ == "__main__":
    _main(sys.argv[1], int(sys.argv[2]))

"""Particle-axis sharding: the A/B reference of the spatial decomposition.

The JAX package's ``parallel/sharding.py`` shards every ``(n_pad, ...)``
array of the state over a 1-D mesh axis ``"p"`` and jits the single-device
step with those shardings; XLA inserts the collectives. PyTorch has no
partitioner, so the collectives are written out: each rank holds a
contiguous slice of the particle rows (:func:`shard_state`), and
:func:`sharded_step_fn` all-gathers the rows (one buffer), runs the
single-device step on the whole state, and keeps its slice. Every rank thus
runs the same step on the same data, and the result equals one device bit
for bit: the reference the spatial decomposition (``parallel/spatial.py``)
is held to, never a faster path. The pair environment of the last sort
(``cached_neighbors``) is derived data the step needs whole, so it stays
whole and alike on every rank.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .. import bridge
from .. import sim as simlib
from ..core.params import SimParams
from ..core.state import SimState
from . import collectives
from .collectives import Mesh

PARTICLE_AXIS = "p"


def make_mesh(device="cuda", axis: str = PARTICLE_AXIS) -> Mesh:
    """The mesh of every rank of the initialised default process group, this
    process's tensors on ``device``: the card the process has selected
    (``torch.cuda.set_device``) unless ``device="cpu"``. On a host without
    CUDA the default raises."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh(device='cuda'): CUDA is not "
                               "available on this host; pass device='cpu'")
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: torch.distributed is not initialised "
                           "(parallel.launch starts ranks that are)")
    return Mesh(rank=dist.get_rank(), size=dist.get_world_size(),
                device=device, group=dist.group.WORLD,
                backend=dist.get_backend(), axis=axis)


def particle_paths(state: SimState) -> list:
    """The paths (``bridge.walk``) of the per-particle arrays: the particles'
    and the state's own (``visc_x``, the DFSPH carries, ...); the body
    tables and the scalars are the others."""
    return [path for path, t in bridge.walk(state)
            if path[0] == "particles" or (len(path) == 1 and t.dim() >= 1)]


def shard_state(state: SimState, mesh: Mesh, params: SimParams) -> SimState:
    """This rank's slice of every per-particle array, the rest whole, on
    the mesh's device; no pair environment."""
    if params.n_pad % mesh.size:
        raise ValueError(f"n_pad {params.n_pad} does not divide over "
                         f"{mesh.size} ranks")
    nl = params.n_pad // mesh.size
    arrays = dict(bridge.walk(state))
    for path in particle_paths(state):
        arrays[path] = arrays[path][mesh.rank * nl:(mesh.rank + 1) * nl]
    return bridge.build({k: v.contiguous().to(mesh.device)
                         for k, v in arrays.items()})


def gather_state(state: SimState, mesh: Mesh, params: SimParams) -> SimState:
    """The whole state from every rank's slice (one all-gather); the pair
    environment kept as it is."""
    rows = particle_paths(state)
    arrays = dict(bridge.walk(state))
    like = {p: arrays[p] for p in rows}
    words = collectives.all_gather(collectives.pack_words(like), mesh)
    arrays.update(collectives.unpack_words(words, like))
    return bridge.build(arrays).replace(
        cached_neighbors=state.cached_neighbors)


def _slice(state: SimState, mesh: Mesh, params: SimParams) -> SimState:
    env = state.cached_neighbors
    return shard_state(state, mesh, params).replace(cached_neighbors=env)


def sharded_step_fn(params: SimParams, mesh: Mesh):
    """The single-device step over the sharded state: gather, step, slice
    (:50)."""
    step = simlib.get_step_fn(params)

    def fn(state: SimState):
        state, diag = step(gather_state(state, mesh, params))
        return _slice(state, mesh, params), diag

    return fn


def sharded_prepare_fn(params: SimParams, mesh: Mesh):
    """``sim.prepare`` over the sharded state (:58)."""
    def fn(state: SimState) -> SimState:
        return _slice(simlib.prepare(gather_state(state, mesh, params),
                                     params), mesh, params)

    return fn

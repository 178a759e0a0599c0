"""Spatial domain decomposition over ``torch.distributed``: x-slabs with halos.

The JAX package's ``parallel/spatial.py`` (line numbers below name its
functions). The state is kept globally cell-sorted, x-major, so an equal
split of the particle rows over the ranks is a split of the domain into
slabs along x. Each rank holds its slice of every per-particle array
(``sharding.shard_state``) and the body tables whole. A step:

1. a global resort (:func:`global_resort`): every rank's rows, cell ids
   first, packed with the gather kernel (``ops/permute.py``) and
   all-gathered into one buffer in rank order, one stable sort of the cell
   ids on every rank (the permutation one device would take, since the
   slices concatenate to the whole array), and the rank's slice of it
   unpacked from the buffer with the gather again: exact, and of fixed
   shapes. The sorted cell ids ride along, as the JAX package's
   ``cached_neighbors=cells`` does. This is the sharded sort XLA writes for
   the JAX package (:293-295), written out. DFSPH resorts twice a step,
   around its two segments (``solvers/dfsph.py``);
2. the physics of the single-device step through :class:`SpatialPlumbing`:
   every pair pass runs on the rank's rows extended by ``H`` rows from each
   neighbouring rank (:func:`halo_extend`, one exchange of all the pass's
   fields per pass, so solver iterations see their neighbours' current
   values) and keeps its own rows; residuals, CG dots, body wrenches,
   contact tables and extents are all-reduced (``solvers/common.py``
   ``global_sum`` and friends, under ``params.spmd_axis``).

A halo slot no rank sent (the ends of the mesh) gets the cell id -1 at the
front and ``num_cells`` at the back, which keeps the extended ids ascending;
neither produces nor is a candidate (``ops/pairs.py``, the kernels' ``mine``).
Only the rank's own rows produce. Each rank's rows then take their
candidates in the order one device takes them, and the kernels' sums match
one device's bit for bit (the plain versions' on the CPU too, unless
``torch.sum`` groups a row's terms otherwise in a chunk of other rows); the
global sums are added in float64 and come out alike (``common.global_sum``),
the per-object wrench tables add in another order.
Whether the halo held every candidate is checked every step
(:meth:`SpatialPlumbing._halo_coverage_shortfall`) and counted into
``neighbor_overflow``, never silent.

The mesh is :class:`collectives.Mesh` over every rank of the default
process group (:func:`make_mesh`), on the card unless asked otherwise;
``parallel/launch.py`` starts ranks. :class:`SpatialSimulation` holds a
rank's state and steps it, captured into a CUDA graph where it can be. The
JAX package's contact-producer environment has no counterpart: the port's
engines walk candidates per row.
"""
from __future__ import annotations

import dataclasses

import torch

from .. import sim as simlib
from ..core.params import MATERIAL_NONE, SimParams
from ..core.state import SimState
from ..ops import neighbors as nblib
from ..ops import pair_kernels
from ..ops import permute as permlib
from . import collectives, sharding
from .collectives import Mesh

AXIS = "x"
# rows the cell-list kernel groups (a warp); the slab-window kernel's group
# is its block, params.pair_block
WARP = 32

shard_state = sharding.shard_state


def make_mesh(device="cuda") -> Mesh:
    """The 1-D mesh of axis ``"x"`` over every rank of the initialised
    default group (:46), see ``sharding.make_mesh``."""
    return sharding.make_mesh(device, axis=AXIS)


def _group_rows(params: SimParams) -> int:
    """The engine's row group: a slab-window block, or a warp."""
    if params.resolved_pair_backend() == "pallas":
        return params.pair_block
    return WARP


def halo_width(params: SimParams, n_local: int) -> int:
    """Halo rows from each neighbour (:53): the scene's largest x-cell-plane
    population at seeding (``params.halo_plane_max``) times 1.5, for
    densification, rounded up to the engine's row group so the extended
    rows stay whole blocks, at most one neighbour's slice. Without a
    measured plane, the engine's window budget of the JAX package."""
    m = _group_rows(params)
    if params.halo_plane_max > 0:
        h = int(params.halo_plane_max * 1.5)
    elif params.resolved_pair_backend() == "pallas":
        h = max(params.pair_slab, params.pair_slab_big)
    else:
        h = params.pair_dma_su
    h = min(((h + m - 1) // m) * m, n_local // m * m)
    return max(h, m)


@dataclasses.dataclass
class SpatialEnv:
    """An engine environment over the halo-extended rows (:76)."""
    inner: object               # ops.pairs.PairEnv or SlabEnv
    halo: int
    halo_shortfall: torch.Tensor  # () i32
    mesh: Mesh

    @property
    def overflow(self) -> torch.Tensor:
        """The halo's shortfall: the inner environment has no caps."""
        return self.halo_shortfall

    def run(self, name: str, fields: dict, params: SimParams,
            produce: torch.Tensor | None = None, flags: int = 0) -> dict:
        """The pass ``pair_kernels.run`` routes here: :func:`spatial_run`."""
        return spatial_run(name, self, fields, params, produce, flags)


def halo_extend(x: torch.Tensor, H: int, mesh: Mesh) -> torch.Tensor:
    """(n_local, ...) -> (n_local + 2H, ...): the left rank's last H rows,
    the rank's own, the right rank's first H; zeros at the mesh's ends
    (:107)."""
    return extend_fields({"x": x}, H, mesh)["x"]


def extend_fields(fields: dict, H: int, mesh: Mesh) -> dict:
    """:func:`halo_extend` of every field (32-bit dtypes), in one exchange:
    the fields packed into one buffer per direction (:124)."""
    head = permlib.pack_words({k: v[:H] for k, v in fields.items()})
    tail = permlib.pack_words({k: v[-H:] for k, v in fields.items()})
    from_left, from_right = collectives.exchange(head, tail, mesh)
    left = permlib.unpack_words(from_left, fields)
    right = permlib.unpack_words(from_right, fields)
    return {k: torch.cat([left[k], v, right[k]]) for k, v in fields.items()}


class SpatialPlumbing(simlib.Plumbing):
    """The step's stages under the decomposition (:135): no sort (the global
    resort runs before), environments over halo-extended rows."""

    @staticmethod
    def neighbor_prep(state: SimState, params: SimParams):
        """The environment over the extended rows (:135-192): the resort's
        cell ids (``state.cached_neighbors``) extended by one exchange,
        sentinels in the slots no rank sent, only the rank's own rows
        producing."""
        mesh = collectives.mesh_of(params.spmd_axis)
        cells = state.cached_neighbors
        if not isinstance(cells, torch.Tensor):
            raise ValueError("SpatialPlumbing.neighbor_prep needs the cell "
                             "ids of the global resort in cached_neighbors")
        n_local = cells.shape[0]
        H = halo_width(params, n_local)
        ext = halo_extend(cells, H, mesh)
        if mesh.rank == 0:
            ext[:H] = -1
        if mesh.rank == mesh.size - 1:
            ext[-H:] = params.num_cells
        off = torch.zeros(H, dtype=torch.bool, device=cells.device)
        produce = torch.cat([off, simlib.produces_output(
            state.particles, state.rigid, params), off])
        inner = simlib.build_env(ext, produce, params)
        shortfall = SpatialPlumbing._halo_coverage_shortfall(cells, H, params)
        return state, SpatialEnv(inner=inner, halo=H, halo_shortfall=shortfall,
                                 mesh=mesh)

    @staticmethod
    def _halo_coverage_shortfall(cells_loc: torch.Tensor, H: int,
                                 params: SimParams) -> torch.Tensor:
        """Active rows a neighbouring rank needs that lie outside the H rows
        sent to it (:195): the rows within one stencil reach, in flat cell
        order, of the neighbour's first (last) owned cell, learnt by a
        scalar exchange. Nonzero means cross-rank pair sums missed
        neighbours."""
        mesh = collectives.mesh_of(params.spmd_axis)
        dev = cells_loc.device
        if mesh.size == 1:
            return torch.zeros((), dtype=torch.int32, device=dev)
        n_loc = cells_loc.shape[0]
        g = params.grid_num
        # the stencil of a cell reaches one plane, one row and one cell back
        # in flat order (:219-227)
        reach = g[1] * g[2] + g[2] + 1 if params.dim == 3 else g[1] + 1
        act = (cells_loc >= 0) & (cells_loc < params.num_cells)
        big = 2 ** 30
        cell = torch.where(act, cells_loc, torch.full_like(cells_loc, big))
        c_first = torch.min(cell).view(1)
        c_last = torch.max(torch.where(act, cell,
                                       torch.full_like(cell, -1))).view(1)
        left_last, right_first = collectives.exchange(c_first, c_last, mesh)
        i_loc = torch.arange(n_loc, device=dev)
        miss_r = act & (i_loc < n_loc - H) & (cell >= right_first - reach) & \
            (mesh.rank < mesh.size - 1)
        miss_l = act & (i_loc >= H) & (cell <= left_last + reach) & \
            (mesh.rank > 0)
        return (torch.sum(miss_r) + torch.sum(miss_l)).to(torch.int32)


def spatial_run(name: str, env: SpatialEnv, fields: dict, params: SimParams,
                produce: torch.Tensor | None = None, flags: int = 0) -> dict:
    """``pair_kernels.run`` under the decomposition (:242): the per-row
    fields the body reads extended (one exchange), the pass on the extended
    rows through the engine of ``env.inner`` (its CUDA kernel for CUDA
    tensors), its outputs cropped to the rank's rows. An explicit
    ``produce`` covers the rank's rows; the halo rows produce on their own
    ranks."""
    H = env.halo
    needs = pair_kernels.fields_of(name, flags)
    rows = {k: fields[k] for k in needs if k not in pair_kernels.TABLES}
    ext = extend_fields(rows, H, env.mesh)
    ext.update({k: fields[k] for k in needs if k in pair_kernels.TABLES})
    if produce is not None:
        off = torch.zeros(H, dtype=torch.bool, device=produce.device)
        produce = torch.cat([off, produce, off])
    out = pair_kernels.run(name, env.inner, ext, params, produce, flags)
    return {k: v[H:v.shape[0] - H] for k, v in out.items()}


def global_resort(state: SimState, params: SimParams, mesh: Mesh) -> SimState:
    """Sort the carried per-particle arrays by grid cell over the whole mesh
    (:293-295): this rank's rows of the globally sorted state, with their
    sorted cell ids in ``cached_neighbors``. The same rows and order as
    ``sim.sort_state`` on one device, and the same shapes every step, as
    XLA's sharded sort is for the JAX package: the gather kernel
    (``ops/permute.py``) packs the rank's rows, cell ids first, into its
    (n_local, W) int32 buffer; one all-gather makes the (n_pad, W) buffer of
    every rank's rows in rank order, which is the global row order; the
    stable sort of its cell ids is one device's permutation, and the kernel
    unpacks this rank's slice of it from the buffer into sorted fields, int
    dtypes kept. Nothing is read on the host. Each rank receives (D - 1) / D
    of the packed state per resort (PERF.md)."""
    p = state.particles
    cells = nblib.flat_cell_ids(p.pos, p.material != MATERIAL_NONE, params)
    keys, extras = simlib.permuted_keys(params)
    arrays = {"cells": cells}
    arrays.update({k: getattr(p, k) for k in keys})
    arrays.update({k: getattr(state, k) for k in extras})
    nl = cells.shape[0]
    own = torch.arange(nl, device=cells.device)
    rows = collectives.all_gather(permlib.permute_pack(own, arrays), mesh)
    perm = nblib.sort_permutation(rows[:, 0])
    out = permlib.permute_unpack(perm[mesh.rank * nl:(mesh.rank + 1) * nl],
                                 rows, arrays)
    cells_sorted = out.pop("cells")
    state = state.replace(**{k: out.pop(k) for k in extras})
    return state.replace(particles=p.replace(**out),
                         cached_neighbors=cells_sorted)


def spatial_step_fn(params: SimParams, mesh: Mesh):
    """The decomposed step (:273) over states of ``shard_state``: the global
    resort, then the physics through :class:`SpatialPlumbing` with
    ``spmd_axis`` set; DFSPH as its two segments around a second resort.
    Every method runs. Returns ``step(state) -> (state, diagnostics)``;
    the diagnostics are global, alike on every rank."""
    if params.n_pad % mesh.size:
        raise ValueError(f"n_pad {params.n_pad} does not divide over "
                         f"{mesh.size} ranks")
    n_local = params.n_pad // mesh.size
    blk = _group_rows(params)
    if n_local % blk:
        raise ValueError(f"a rank's {n_local} rows are not a multiple of "
                         f"the engine's row group {blk}")
    params_sp = dataclasses.replace(params, spmd_axis=mesh.axis)
    collectives.bind(mesh)

    if params.simulation_method == "dfsph":
        from ..solvers import dfsph

        def step(state: SimState):
            state = global_resort(state, params_sp, mesh)
            state, diag_a = dfsph.segment_a(state, params_sp, SpatialPlumbing)
            state = global_resort(state, params_sp, mesh)
            state, diag = dfsph.segment_b(state, params_sp, SpatialPlumbing)
            diag.update(diag_a)
            return state.replace(cached_neighbors=None), diag
    else:
        inner = simlib.get_step_fn(params_sp, plumbing=SpatialPlumbing)

        def step(state: SimState):
            state, diag = inner(global_resort(state, params_sp, mesh))
            return state.replace(cached_neighbors=None), diag

    return step


class SpatialSimulation(simlib.Simulation):
    """:class:`sim.Simulation` over the spatial decomposition: the whole
    ``state`` prepared on the mesh's device, this rank's slice of it held
    (:func:`shard_state`), stepped by :func:`spatial_step_fn`. Every rank of
    the mesh builds one and steps it alike.

    As the JAX package compiles the decomposed step into one program
    (``jax.jit(step, donate_argnums=0)``, :332), the step is captured into
    a CUDA graph where :func:`collectives.capturable` says it can be (NCCL
    on the card; past one rank with NCCL's graph-mixing support off, as
    ``parallel/launch.py`` starts its ranks): one eager warm-up step on a
    copy of the state, which also makes every NCCL communicator the step
    uses, then the capture, the all-reduces of the solvers' residuals and
    the halo exchanges inside their loops' WHILE nodes, the resort's
    all-gather in the graph; ``step`` replays once, ``run(n)`` n times with
    no host read. Synchronise before any NCCL call outside the graph while
    a replay may run (NCCL without graph-mixing support). Elsewhere the
    step runs eagerly, its loops reading their all-reduced flags on the
    host: under gloo (the host stages its buffers) and on the CPU.
    ``capture=True`` where the step cannot be captured raises;
    ``capture=False`` steps eagerly on the card too."""

    def __init__(self, scene, state: SimState, mesh: Mesh,
                 capture: bool | None = None):
        can = collectives.capturable(mesh)
        if capture is None:
            capture = can
        elif capture and not can:
            raise ValueError(f"SpatialSimulation: a step of {mesh.size} "
                             f"rank(s) over {mesh.backend} on {mesh.device} "
                             f"cannot be captured (collectives.capturable); "
                             f"pass capture=False or None")
        params = scene.params
        self.mesh = mesh
        step = spatial_step_fn(params, mesh)
        state = shard_state(simlib.prepare(state.to(mesh.device), params),
                            mesh, params)
        self._start(scene, mesh.device, step, state, capture)

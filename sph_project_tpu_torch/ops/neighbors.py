"""Cell binning, the per-step sort, and the cell table over sorted particles.

The JAX package's ``ops/neighbors.py`` binning and sort, minus the
plane-padded and incremental layouts, which exist for the TPU pair engine's
DMA windows. The flat id is x-major and z-fastest, ``(x*gy + y)*gz + z``, so
the 3x3x3 stencil of a cell is 9 contiguous runs of sorted particles, one per
(x, y) neighbour row; :func:`cell_table` gives the run bounds.

Cell ids are computed once per sort and carried: particles that sit exactly
on a cell edge can bin differently under another rounding of
``(pos - start) / h``, so nothing downstream recomputes them.
"""
from __future__ import annotations

import torch

from ..core.params import SimParams


def cell_coords(pos: torch.Tensor, params: SimParams) -> torch.Tensor:
    """Integer cell coordinates (int32), clamped into the grid."""
    start = torch.tensor(params.domain_start, dtype=torch.float32,
                         device=pos.device)
    q = (pos - start) / torch.tensor(params.support_radius,
                                     dtype=torch.float32, device=pos.device)
    coords = torch.floor(q).to(torch.int32)
    hi = torch.tensor(params.grid_num, dtype=torch.int32, device=pos.device) - 1
    return torch.minimum(torch.clamp_min(coords, 0), hi)


def flat_cell_ids(pos: torch.Tensor, active: torch.Tensor,
                  params: SimParams) -> torch.Tensor:
    """Flat cell id per particle (int32); inactive particles get the sentinel
    ``num_cells``, so the sort moves them to the tail and no cell run ever
    includes them."""
    c = cell_coords(pos, params)
    g = params.grid_num
    if params.dim == 3:
        flat = (c[:, 0] * g[1] + c[:, 1]) * g[2] + c[:, 2]
    else:
        flat = c[:, 0] * g[1] + c[:, 1]
    return torch.where(active, flat, torch.full_like(flat, params.num_cells))


def sort_permutation(cells: torch.Tensor) -> torch.Tensor:
    """Stable permutation ordering particles by cell id (int64 indices)."""
    return torch.sort(cells, stable=True).indices


def cell_table(cells_sorted: torch.Tensor, num_cells: int) -> torch.Tensor:
    """``start[c]`` = first sorted index whose cell id is >= c, for
    c in [0, num_cells]; cell c holds sorted rows [start[c], start[c+1]) and
    a z-run of cells [c0, c1] holds rows [start[c0], start[c1 + 1])."""
    q = torch.arange(num_cells + 1, dtype=cells_sorted.dtype,
                     device=cells_sorted.device)
    return torch.searchsorted(cells_sorted, q).to(torch.int32)

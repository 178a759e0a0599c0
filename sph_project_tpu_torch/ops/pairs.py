"""The two pair environments and their plain PyTorch pair executors.

A :class:`PairEnv` holds what every pair pass over one sorted layout shares:
the carried cell ids of the sorted particles, the cell table
(``neighbors.cell_table``) and the rows whose sums are read (``produce``:
the fluid rows on the DFSPH main path, as ``sim.produces_output`` on the JAX
side). It is the environment of the cell-list engine. A :class:`SlabEnv` adds
the window table of the slab-window engine (the JAX package's
``ops/pairs.make_pair_env``): particles go in blocks of ``pair_block``
consecutive sorted rows, and segment ``s = (dx, dy)`` of a block is one index
range, the union over the block's rows of the 3 z-cells around each row's
cell in the (x+dx, y+dy) row of cells. A block that spans several (x, y) rows
has overlapping windows, so a candidate ``j`` of segment ``s`` counts for row
``i`` only if it lies in the row's piece of the window: ``rows[j] == rows[i]
+ dx*gy + dy`` and its cell one of the three z-cells around the row's (the
plain executor's test; the CUDA kernel finds the piece by binary search over
the window's cell ids). Both engines thus take a row's candidates from the
3^dim cells around its cell at the last sort, also when the pair passes run
on positions moved since (PBF's iterations, a dynamic body's volumes): the
step-start grid. The JAX package's slab executor keeps any row-matched
candidate of the window instead, a superset on moved positions.

Not carried over from the JAX slab engine: the pre-gathered slabs
(``pos_slab``, ``jidx``, ``valid``, ``row_slab``, ``slab_pack``,
``SlabField``), the static window cap ``pair_slab``, and the second pass over
outlier blocks with ``pair_slab_big``. They exist because XLA shapes are
static and TPU gathers are slow. Here a window is read straight from the
sorted fields and walked to its true length, so nothing is cut, the overflow
count is 0 by construction and one pass covers the outlier blocks too.

In 2D the flat id is ``x*gy + y``: a row of cells is one x, its cells run
along y, and the stencil is 3 segments ``dx`` in place of 9. Both engines
treat a 2D grid ``(gx, gy)`` as the 3D grid ``(gx, 1, gy)``
(:func:`grid3`), whose flat ids are the same, with the segments of
:func:`segments`.

:func:`run_plain` (cell-list) and :func:`run_plain_slab` (slab-window)
evaluate a pair body written against :class:`Cx` (the component API of the
JAX package's ``ops/pair_exec.Cx``: ``blk`` is a row's own field, ``slab`` a
candidate's, ``sum`` the masked reduction over candidates) densely, in chunks,
so memory stays bounded at any size. They are the plain versions of the CUDA
pair kernels (``ops/pair_kernels.py``): the CPU runs them, and on the card
they are the reference a kernel is checked against, never the main path.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from ..core.params import SimParams
from ..core.state import constant

# rows x candidates per chunk of the plain executor
PLAIN_CHUNK_ELEMS = 1 << 22


@dataclasses.dataclass
class PairEnv:
    cells: torch.Tensor        # (N,) i32 sorted flat cell ids (sentinel tail)
    cell_start: torch.Tensor   # (num_cells + 1,) i32
    produce: torch.Tensor      # (N,) bool rows whose pair sums are read
    grid: tuple                # (gx, gy, gz), or (gx, gy) in 2D
    dh2: float                 # support radius squared (float32 on use)

    @property
    def n(self) -> int:
        return self.cells.shape[0]

    @property
    def dim(self) -> int:
        return len(self.grid)


@dataclasses.dataclass
class SlabEnv(PairEnv):
    starts: torch.Tensor       # (NB, 9) i32 window start per block and
    #                            segment ((NB, 3) in 2D)
    lens: torch.Tensor         # (NB, 9) i32 true window length
    rows: torch.Tensor         # (N,) i32 flat (x, y) row id, cells // gz
    #                            (x in 2D: cells // gy)
    block: int                 # rows per block (params.pair_block)

    @property
    def nb(self) -> int:
        return self.starts.shape[0]


# (dx, dy) of segment s = 3 * (dx + 1) + (dy + 1), the order both engines walk
SEGMENTS = tuple((dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1))
# in 2D, under grid3: segment s = dx + 1
SEGMENTS_2D = tuple((dx, 0) for dx in (-1, 0, 1))


def segments(dim: int) -> tuple:
    return SEGMENTS if dim == 3 else SEGMENTS_2D


def grid3(grid: tuple) -> tuple:
    """The 3D grid whose flat cell ids are ``grid``'s: itself, or
    ``(gx, 1, gy)`` for a 2D ``(gx, gy)``."""
    return tuple(grid) if len(grid) == 3 else (grid[0], 1, grid[1])


def make_pair_env(cells_sorted: torch.Tensor, produce: torch.Tensor,
                  params: SimParams) -> PairEnv:
    """The cell-list environment over one sorted layout."""
    from .neighbors import cell_table
    return PairEnv(cells=cells_sorted.contiguous(),
                   cell_start=cell_table(cells_sorted, params.num_cells),
                   produce=produce.contiguous(), grid=tuple(params.grid_num),
                   dh2=params.support_radius ** 2)


def split(fields: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Expand (N, d) vectors into scalar components name0..name{d-1}."""
    out = {}
    for k, v in fields.items():
        if v.dim() == 2:
            for i in range(v.shape[1]):
                out[f"{k}{i}"] = v[:, i]
        else:
            out[k] = v
    return out


def collect(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Merge component outputs name0..name{d-1} back into (N, d) vectors."""
    merged: Dict[str, torch.Tensor] = {}
    comps: Dict[str, list] = {}
    for k in sorted(out):
        if k[-1].isdigit() and k[:-1] != "":
            comps.setdefault(k[:-1], []).append(out[k])
        else:
            merged[k] = out[k]
    for k, vs in comps.items():
        merged[k] = torch.stack(vs, dim=-1)
    return merged


class Cx:
    """One chunk of rows x candidates. ``rows`` indexes the chunk's rows with
    a trailing axis of 1, ``cand`` its candidates along the last axis: (R, 1)
    and (R, M) under the cell-list engine, (C, B, 1) and (C, 1, M) under the
    slab-window engine, where a block's rows share its candidates. ``blk`` and
    ``slab`` have those shapes; ``geometry()`` gives the R components, the
    squared distance and the pair mask (a real candidate, not the row itself,
    strictly inside the support radius and, under the slab-window engine, of
    the row of cells its segment stands for: ``row_match``); ``sum`` reduces
    over candidates."""

    def __init__(self, fields, rows, cand, valid, dh2: float, dim: int,
                 row_match: torch.Tensor | None = None):
        self._f = fields
        self._rows = rows
        self._cand = cand
        self._valid = valid
        self._row_match = row_match
        self._dh2 = dh2
        self.dim = dim
        self._bc: dict = {}
        self._sc: dict = {}
        self._geometry = None

    def blk(self, name: str) -> torch.Tensor:
        v = self._bc.get(name)
        if v is None:
            v = self._bc[name] = self._f[name][self._rows]
        return v

    def slab(self, name: str) -> torch.Tensor:
        v = self._sc.get(name)
        if v is None:
            v = self._sc[name] = self._f[name][self._cand]
        return v

    def vec_blk(self, name: str):
        return tuple(self.blk(f"{name}{d}") for d in range(self.dim))

    def vec_slab(self, name: str):
        return tuple(self.slab(f"{name}{d}") for d in range(self.dim))

    def geometry(self):
        if self._geometry is None:
            R = tuple(self.blk(f"pos{d}") - self.slab(f"pos{d}")
                      for d in range(self.dim))
            d2 = sum(r * r for r in R)
            dh2 = constant(self._dh2, d2.dtype, d2.device)
            mask = self._valid & (self._cand != self._rows) & (d2 < dh2)
            if self._row_match is not None:
                mask = mask & self._row_match
            self._geometry = (R, d2, mask)
        return self._geometry

    @staticmethod
    def sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return torch.where(mask, x, torch.zeros_like(x)).sum(dim=-1)

    @staticmethod
    def where(c, a, b):
        return torch.where(c, a, b)


def _cell_xy(cells: torch.Tensor, grid: tuple):
    gx, gy, gz = grid3(grid)
    rest = cells // gz
    return rest // gy, rest % gy, cells % gz


def _ranges(env: PairEnv, rows: torch.Tensor):
    """(lo, hi, ok), each (R, 9) ((R, 3) in 2D): the index range [lo, hi) of
    the 3 z-cells around each row's cell in each of the 9 (x+dx, y+dy) rows
    of cells, and whether that row of cells exists (never for a row with a
    sentinel id: ``num_cells`` at the tail, or -1 at the front, a halo slot
    no rank sent under the spatial decomposition; the JAX package's
    ``pairs.py`` :311-313)."""
    gx, gy, gz = grid3(env.grid)
    c = env.cells[rows].long()
    x, y, z = _cell_xy(c, env.grid)
    live = (c >= 0) & (c < gx * gy * gz)
    zlo = torch.clamp_min(z - 1, 0)
    zhi = torch.clamp_max(z + 1, gz - 1)
    start = env.cell_start.long()
    los, his, oks = [], [], []
    for dx, dy in segments(env.dim):
        xx, yy = x + dx, y + dy
        oks.append(live & (xx >= 0) & (xx < gx) & (yy >= 0) & (yy < gy))
        row = (xx.clamp(0, gx - 1) * gy + yy.clamp(0, gy - 1)) * gz
        los.append(start[row + zlo])
        his.append(start[row + zhi + 1])
    return torch.stack(los, 1), torch.stack(his, 1), torch.stack(oks, 1)


def candidate_ranges(env: PairEnv, rows: torch.Tensor):
    """(lo, length) of the 9 (2D: 3) contiguous candidate runs of each
    row, (R, 9) ((R, 3))."""
    lo, hi, ok = _ranges(env, rows)
    return lo, torch.where(ok, hi - lo, torch.zeros_like(lo))


def make_slab_env(cells_sorted: torch.Tensor, produce: torch.Tensor,
                  params: SimParams) -> SlabEnv:
    """The slab-window environment over one sorted layout: per block of
    ``params.pair_block`` rows and per segment, the window [min start, max
    end) over the block's rows (tensor ops only, no host loop)."""
    base = make_pair_env(cells_sorted, produce, params)
    n, B = base.n, params.pair_block
    if n % B:
        raise ValueError(f"{n} rows do not divide into blocks of {B}")
    lo, hi, ok = _ranges(base, torch.arange(n, device=base.cells.device))
    start = torch.where(ok, lo, torch.full_like(lo, n)).view(n // B, B, -1)
    end = torch.where(ok, hi, torch.zeros_like(hi)).view(n // B, B, -1)
    starts = start.amin(1)
    lens = torch.clamp_min(end.amax(1) - starts, 0)
    return SlabEnv(
        **{f.name: getattr(base, f.name) for f in dataclasses.fields(base)},
        starts=starts.to(torch.int32).contiguous(),
        lens=lens.to(torch.int32).contiguous(),
        rows=(base.cells // params.grid_num[-1]).contiguous(), block=B)


def window_pieces(env: SlabEnv, rows: torch.Tensor):
    """(lo, length), each (R, 9) ((R, 3) in 2D): the piece of its block's
    window that each
    row tests under the slab-window kernel (``csrc/pair_slab.cu``), found as
    the kernel finds it, from the window table and the sorted cell ids: the
    candidates of the window whose cell id lies in the three z-cells around
    the row's in the segment's row of cells. Empty where that row of cells
    does not exist, and for a row with a sentinel id."""
    gx, gy, gz = grid3(env.grid)
    cells = env.cells.long()
    c = cells[rows]
    x, y, z = _cell_xy(c, env.grid)
    live = (c >= 0) & (c < gx * gy * gz)
    zlo = torch.clamp_min(z - 1, 0)
    zhi = torch.clamp_max(z + 1, gz - 1)
    ws = env.starts.long()[rows // env.block]
    we = ws + env.lens.long()[rows // env.block]
    segs = segments(env.dim)
    want = torch.stack([((x + dx) * gy + (y + dy)) * gz
                        for dx, dy in segs], 1)
    ok = torch.stack([live & (x + dx >= 0) & (x + dx < gx) & (y + dy >= 0)
                      & (y + dy < gy) for dx, dy in segs], 1)
    # the ids are sorted over all rows, so a search inside [ws, we) is the
    # search over all of them, clamped to the window
    lo = torch.searchsorted(cells, (want + zlo[:, None]).contiguous())
    hi = torch.searchsorted(cells, (want + zhi[:, None] + 1).contiguous())
    lo = torch.minimum(torch.maximum(lo, ws), we)
    hi = torch.minimum(torch.maximum(hi, lo), we)
    return lo, torch.where(ok, hi - lo, torch.zeros_like(lo))


def _expand_runs(lo: torch.Tensor, ln: torch.Tensor, m: int):
    """The indices of each row's 9 (2D: 3) runs laid side by side, padded to
    ``m`` columns: (index, segment, is a real candidate), each (R, m)."""
    cum = torch.cumsum(ln, 1)
    k = torch.arange(max(m, 1), device=lo.device).expand(lo.shape[0], -1)
    seg = torch.searchsorted(cum, k.contiguous(),
                             right=True).clamp_max(ln.shape[1] - 1)
    first = (cum - ln).gather(1, seg)
    cand = lo.gather(1, seg) + (k - first)
    return cand, seg, k < cum[:, -1:]


def _zeros_out(env: PairEnv, out_names) -> Dict[str, torch.Tensor]:
    return {k: torch.zeros(env.n, dtype=torch.float32, device=env.cells.device)
            for k in out_names}


def run_plain(body: Callable, env: PairEnv, fields: Dict[str, torch.Tensor],
              out_names, produce: torch.Tensor | None = None
              ) -> Dict[str, torch.Tensor]:
    """Evaluate ``body(cx) -> {name: (R,) sums}`` for every produce row over
    the candidates of its 9 (2D: 3) cell-row runs; the other rows get
    zeros. Returns
    one (N,) tensor per name in ``out_names``."""
    produce = env.produce if produce is None else produce
    comps = split(fields)
    out = _zeros_out(env, out_names)
    rows_all = torch.nonzero(produce).flatten()
    if rows_all.numel() == 0:
        return out
    lo_all, len_all = candidate_ranges(env, rows_all)
    tot_all = len_all.sum(1)
    # rows per chunk so that rows x widest candidate list stays bounded
    step = max(1, PLAIN_CHUNK_ELEMS // max(1, int(tot_all.max())))
    for start in range(0, rows_all.numel(), step):
        stop = start + step
        m = int(tot_all[start:stop].max())
        rows = rows_all[start:stop]
        cand, _, valid = _expand_runs(lo_all[start:stop], len_all[start:stop], m)
        cand = torch.where(valid, cand, rows[:, None])
        cx = Cx(comps, rows[:, None], cand, valid, env.dh2, env.dim)
        res = body(cx)
        for name in out_names:
            out[name][rows] = res[name].to(torch.float32)
    return out


def run_plain_slab(body: Callable, env: SlabEnv,
                   fields: Dict[str, torch.Tensor], out_names,
                   produce: torch.Tensor | None = None
                   ) -> Dict[str, torch.Tensor]:
    """:func:`run_plain` for the slab-window engine: every produce row takes,
    of the candidates of its block's 9 (2D: 3) windows, those in the three
    z-cells around its own in the row of cells the segment stands for: its
    piece of the window, as the kernel finds it. Blocks go in chunks of
    ``PLAIN_CHUNK_ELEMS`` rows x candidates; one block wider than that goes
    alone, in groups of rows."""
    produce = env.produce if produce is None else produce
    comps = split(fields)
    out = _zeros_out(env, out_names)
    B, dev = env.block, env.cells.device
    gx, gy, gz = grid3(env.grid)
    blocks_all = torch.nonzero(produce.view(-1, B).any(1)).flatten()
    widths = env.lens.sum(1)[blocks_all].tolist()
    k = 0
    while k < len(widths):
        m, stop = max(widths[k], 1), k + 1
        while stop < len(widths) and (stop - k + 1) * B * max(
                m, widths[stop]) <= PLAIN_CHUNK_ELEMS:
            m = max(m, widths[stop])
            stop += 1
        blocks = blocks_all[k:stop]
        k = stop
        cand, seg, valid = _expand_runs(env.starts[blocks].long(),
                                        env.lens[blocks].long(), m)
        cand = torch.where(valid, cand, torch.zeros_like(cand))
        cand_cell = env.cells[cand][:, None, :]
        group = B if len(blocks) > 1 else max(1, min(B, PLAIN_CHUNK_ELEMS // m))
        for r0 in range(0, B, group):
            rows = blocks[:, None] * B + torch.arange(
                r0, min(r0 + group, B), device=dev)              # (C, G)
            row_id = env.rows[rows].long()
            x, y = row_id // gy, row_id % gy
            z = env.cells[rows].long() % gz
            want = torch.stack(
                [torch.where((x + dx >= 0) & (x + dx < gx) & (y + dy >= 0)
                             & (y + dy < gy), row_id + (dx * gy + dy),
                             torch.full_like(row_id, -1))
                 for dx, dy in segments(env.dim)], -1)
            want = want.gather(2, seg[:, None, :].expand(-1, rows.shape[1], -1))
            lo = want * gz + torch.clamp_min(z - 1, 0)[..., None]
            hi = want * gz + torch.clamp_max(z + 1, gz - 1)[..., None]
            piece = (want >= 0) & (cand_cell >= lo) & (cand_cell <= hi)
            cx = Cx(comps, rows[:, :, None], cand[:, None, :],
                    valid[:, None, :], env.dh2, env.dim, row_match=piece)
            res = body(cx)
            for name in out_names:
                out[name][rows] = torch.where(
                    produce[rows], res[name].to(torch.float32),
                    torch.zeros((), device=dev))
    return out

"""The cell-list pair environment and the plain PyTorch pair executor.

A :class:`PairEnv` holds what every pair pass over one sorted layout shares:
the carried cell ids of the sorted particles, the cell table
(``neighbors.cell_table``) and the rows whose sums are read (``produce``:
the fluid rows on the DFSPH main path, as ``sim.produces_output`` on the JAX
side).

:func:`run_plain` evaluates a pair body written against :class:`Cx` (the
component API of the JAX package's ``ops/pair_exec.Cx``: ``blk`` is a row's
own field, ``slab`` a candidate's, ``sum`` the masked reduction over
candidates) densely over each row's candidates: the 9 (x+-1, y+-1) cell rows,
each one contiguous z-run of up to 3 cells. Rows go in chunks, so memory
stays bounded at any size. It is the plain version of the CUDA pair kernel
(``ops/pair_kernels.py``): the CPU runs it, and on the card it is the
reference the kernel is checked against, never the main path.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict

import torch

from ..core.params import SimParams

# rows x candidates per chunk of the plain executor
PLAIN_CHUNK_ELEMS = 1 << 22


@dataclasses.dataclass
class PairEnv:
    cells: torch.Tensor        # (N,) i32 sorted flat cell ids (sentinel tail)
    cell_start: torch.Tensor   # (num_cells + 1,) i32
    produce: torch.Tensor      # (N,) bool rows whose pair sums are read
    grid: tuple                # (gx, gy, gz)
    dh2: float                 # support radius squared (float32 on use)

    @property
    def n(self) -> int:
        return self.cells.shape[0]


def make_pair_env(cells_sorted: torch.Tensor, produce: torch.Tensor,
                  params: SimParams) -> PairEnv:
    from .neighbors import cell_table
    if params.dim != 3:
        raise NotImplementedError("2D scenes are not ported yet "
                                  "(ROADMAP Queue A.9, PBF 2D)")
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
    """One chunk of rows x candidates. ``blk(name)`` is (R, 1), ``slab(name)``
    is (R, M); ``geometry()`` gives the R components, the squared distance and
    the pair mask (a real candidate, not the row itself, strictly inside the
    support radius); ``sum`` reduces over candidates."""

    def __init__(self, fields, rows, cand, valid, dh2: float, dim: int):
        self._f = fields
        self._rows = rows
        self._cand = cand
        self._valid = valid
        self._dh2 = dh2
        self.dim = dim
        self._bc: dict = {}
        self._sc: dict = {}

    def blk(self, name: str) -> torch.Tensor:
        v = self._bc.get(name)
        if v is None:
            v = self._bc[name] = self._f[name][self._rows][:, None]
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
        R = tuple(self.blk(f"pos{d}") - self.slab(f"pos{d}")
                  for d in range(self.dim))
        d2 = sum(r * r for r in R)
        dh2 = torch.tensor(self._dh2, dtype=d2.dtype, device=d2.device)
        mask = self._valid & (self._cand != self._rows[:, None]) & (d2 < dh2)
        return R, d2, mask

    @staticmethod
    def sum(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        return torch.where(mask, x, torch.zeros_like(x)).sum(dim=-1)

    @staticmethod
    def where(c, a, b):
        return torch.where(c, a, b)


def candidate_ranges(env: PairEnv, rows: torch.Tensor):
    """(lo, length) of the 9 contiguous candidate runs of each row, (R, 9)."""
    gx, gy, gz = env.grid
    c = env.cells[rows].long()
    z = c % gz
    rest = c // gz
    y = rest % gy
    x = rest // gy
    zlo = torch.clamp_min(z - 1, 0)
    zhi = torch.clamp_max(z + 1, gz - 1)
    start = env.cell_start.long()
    los, lens = [], []
    for dx in (-1, 0, 1):
        for dy in (-1, 0, 1):
            xx, yy = x + dx, y + dy
            ok = (xx >= 0) & (xx < gx) & (yy >= 0) & (yy < gy)
            row = (xx.clamp(0, gx - 1) * gy + yy.clamp(0, gy - 1)) * gz
            lo = start[row + zlo]
            hi = start[row + zhi + 1]
            los.append(lo)
            lens.append(torch.where(ok, hi - lo, torch.zeros_like(lo)))
    return torch.stack(los, 1), torch.stack(lens, 1)


def run_plain(body: Callable, env: PairEnv, fields: Dict[str, torch.Tensor],
              out_names, produce: torch.Tensor | None = None
              ) -> Dict[str, torch.Tensor]:
    """Evaluate ``body(cx) -> {name: (R,) sums}`` for every produce row; the
    other rows get zeros. Returns one (N,) tensor per name in ``out_names``."""
    n = env.n
    produce = env.produce if produce is None else produce
    comps = split(fields)
    dev = env.cells.device
    out = {k: torch.zeros(n, dtype=torch.float32, device=dev) for k in out_names}
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
        lo, ln = lo_all[start:stop], len_all[start:stop]
        cum = torch.cumsum(ln, 1)
        k = torch.arange(max(m, 1), device=dev).expand(rows.numel(), -1)
        seg = torch.searchsorted(cum, k.contiguous(), right=True).clamp_max(8)
        first = (cum - ln).gather(1, seg)
        cand = lo.gather(1, seg) + (k - first)
        valid = k < cum[:, -1:]
        cand = torch.where(valid, cand, rows[:, None])
        cx = Cx(comps, rows, cand, valid, env.dh2, 3)
        res = body(cx)
        for name in out_names:
            out[name][rows] = res[name].to(torch.float32)
    return out

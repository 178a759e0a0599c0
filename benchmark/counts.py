"""The least time the H100 could take for the kernels a step launches.

Bytes: each per-row field a pass reads, once, on the rows it needs (the rows
that produce and every row within the radius of one), the cell-list
engine's tables, the produce mask, and each output once. Operations: per
pair inside the radius, 8 for the geometry (R and d^2) and the body's own,
counted from the bodies' source (``csrc/pair_bodies.cuh``: a square root or
a division counts as one). Candidates an engine tests and rejects are the
design's cost, not the function's, so the bound leaves them out. A body
whose outputs depend on a runtime flag (the divergence pass's neighbour
count) is counted with the fewer outputs: the bound can only come out
lower, never above the kernel's time.
"""
from __future__ import annotations

# published H100 SXM peaks at the 700 W limit: HBM bytes/s and float32
# FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12

GEOMETRY_OPS = 8
# body -> (words read per row, outputs per row, operations per pair; a pair
# of a fluid row with a wall neighbour may take other operations: the
# second number of VISC_OPS)
BODIES = {
    "density": (4, 1, 15),
    "alpha": (5, 4, 24),
    "nonpressure": (10, 6, 55),
    "divergence": (7, 1, 24),
    "correction": (7, 3, 28),
    "density_alpha_divergence": (8, 7, 60),
    "nonpressure_warm": (12, 9, 71),
    "visc_prep": (11, 9, None),
    "visc_matvec": (9, 3, None),
}
# the viscous passes' operations per pair by the neighbour's material:
# (fluid j, wall j)
VISC_OPS = {"visc_prep": (42, 55), "visc_matvec": (36, 1)}


def pair_work(body: str, work: dict) -> tuple[float, float]:
    """(bytes, operations) of one launch of ``body`` over the fluid rows of
    a state whose ``work`` is ``pairs`` (fluid row, any neighbour),
    ``wall_pairs`` (of those, with a wall neighbour), ``rows_read``, ``n``
    (rows of the state) and ``cells`` (cells of the grid)."""
    words, outs, ops = BODIES[body]
    n = work["n"]
    n_bytes = (words * 4 * work["rows_read"] + 4 * n
               + 4 * (work["cells"] + 1) + n + 4 * outs * n)
    npairs = work["pairs"]
    if body in VISC_OPS:
        f_ops, w_ops = VISC_OPS[body]
        n_rj = work["wall_pairs"]
        n_ops = npairs * GEOMETRY_OPS + (npairs - n_rj) * f_ops + n_rj * w_ops
    else:
        n_ops = npairs * (GEOMETRY_OPS + ops)
    return float(n_bytes), float(n_ops)


def bound_s(n_bytes: float, n_ops: float) -> float:
    """The least seconds: bytes over the memory rate or operations over the
    float32 rate, whichever is longer."""
    return max(n_bytes / HBM_BYTES_PER_S, n_ops / FP32_OPS_PER_S)


def gather_bytes(words_per_row: int, n: int) -> float:
    """The sort's gather: every word of every row read once and written
    once, and the permutation (int64) read once."""
    return float(2 * 4 * words_per_row * n + 8 * n)

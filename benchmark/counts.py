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

The bodies that produce on the rows of dynamic bodies alone
(``rigid_volume`` on moved positions, ``rigid_contact``, ``rigid_dem``;
:data:`DYNAMIC`) are counted on those rows: their pairs, the rows they read,
and the body's own operations on every pair (the compare that turns most
neighbours away) and on the pairs it takes (one object's pairs, or pairs
touching another object), :data:`TAKEN`. ``rigid_contact``'s outputs are
(1 + dim) per contact channel, a launch argument: it is counted with one
channel. A pass of the fluid bodies launched with the dynamic-rigid outputs
(the ``+rigid`` instances, whose kernel names say so) adds the words and
outputs of :data:`RIGID_EXTRA`; the wrench's operations on the pairs of a
dynamic row with a fluid neighbour are left out. Both leave the bound lower.
The counts are the 3D instances'.
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
    # the object compare on every pair (its taken pairs: TAKEN)
    "rigid_volume": (4, 1, 1),
    "rigid_contact": (5, 4, 1),
    "rigid_dem": (8, 3, 1),
}
# body -> (the pairs of ``pair_work``'s counts it takes, operations on each
# of them): rigid_volume W (13) and the sum on a pair of one object;
# rigid_contact on a touching pair two object compares, sqrt, the distance
# and channel compares, the penetration, max and 1/dist, then the weight and
# the normal's three sums (1 + 3 x 3); rigid_dem one object compare, sqrt,
# the penetration and its compare, max and 1/dist, the normal speed (3 sub,
# 3 mul, 2 add, a mul), the force's two products, difference, clamp and
# scale, the three sums (3 x 2)
TAKEN = {"rigid_volume": ("same_pairs", 14),
         "rigid_contact": ("touch_pairs", 18),
         "rigid_dem": ("touch_pairs", 26)}
# the bodies produced on the dynamic rows alone
DYNAMIC = frozenset(TAKEN)
# body -> (words a row more, outputs more) of its ``+rigid`` instance
# (ops/pair_kernels.py RIGID_OUTPUTS: is_dynamic or object_id, and the
# wrenches or the same-object sum)
RIGID_EXTRA = {"nonpressure": (1, 3), "correction": (1, 3),
               "density_alpha_divergence": (1, 1),
               "nonpressure_warm": (1, 6)}
BODIES.update({f"{b}+rigid": (BODIES[b][0] + dw, BODIES[b][1] + do,
                              BODIES[b][2])
               for b, (dw, do) in RIGID_EXTRA.items()})
# the viscous passes' operations per pair by the neighbour's material:
# (fluid j, wall j)
VISC_OPS = {"visc_prep": (42, 55), "visc_matvec": (36, 1)}


def pair_work(body: str, work: dict) -> tuple[float, float]:
    """(bytes, operations) of one launch of ``body`` over the rows that
    produce in a state whose ``work`` is ``pairs`` (producing row, any
    neighbour), ``wall_pairs`` (of those, with a rigid neighbour),
    ``rows_read``, ``n`` (rows of the state) and ``cells`` (cells of the
    grid); for a body of :data:`DYNAMIC`, ``dyn_pairs``, ``dyn_rows_read``
    and its taken pairs (:data:`TAKEN`) in their place."""
    words, outs, ops = BODIES[body]
    n = work["n"]
    dyn = body in DYNAMIC
    read = work["dyn_rows_read" if dyn else "rows_read"]
    n_bytes = (words * 4 * read + 4 * n
               + 4 * (work["cells"] + 1) + n + 4 * outs * n)
    npairs = work["dyn_pairs" if dyn else "pairs"]
    if dyn:
        key, taken_ops = TAKEN[body]
        n_ops = npairs * (GEOMETRY_OPS + ops) + work[key] * taken_ops
    elif body in VISC_OPS:
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

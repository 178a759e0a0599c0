"""Iterations of both DFSPH correctors (density and divergence) per step,
averaged over the traced segment, from the step's diagnostics."""


def read(rec):
    rows = rec["diags"]
    if not rows or "solver_iters" not in rows[0]:
        return None
    return sum(r["solver_iters"] + r.get("div_iters", 0.0)
               for r in rows) / len(rows)

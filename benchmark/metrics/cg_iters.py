"""CG iterations of the implicit viscosity solve per step, averaged over
the traced segment (``viscosity_cg.last_solve["cg_iters"]`` of each
replay)."""


def read(rec):
    cg = rec.get("cg_iters")
    return sum(cg) / len(cg) if cg else None

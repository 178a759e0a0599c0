"""Device time of the sort (the radix sort of the cell ids) and of the cell
table (``searchsorted``) per step of the traced segment, in ms."""


def read(rec):
    fam = rec["families"]
    ns = sum(e - s for name, s, e in rec["kernels"]
             if fam(name) in ("sort", "cell_table"))
    return ns / 1e6 / rec["steps"] if ns else None

"""Device time of the pair kernels (``csrc/pair_pass.cu``,
``csrc/pair_slab.cu``) per step of the traced segment, in ms."""


def read(rec):
    fam = rec["families"]
    ns = sum(e - s for name, s, e in rec["kernels"]
             if fam(name).startswith("pair:"))
    return ns / 1e6 / rec["steps"] if ns else None

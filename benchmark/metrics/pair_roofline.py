"""The pair kernels' share of their roofline over the traced segment: the
sum over pair launches of the least time (``counts.pair_work`` and
``counts.bound_s``, with the pairs counted on the segment's start state)
over the sum of their kernel times, in percent."""
import counts


def read(rec):
    fam = rec["families"]
    bound = spent = 0.0
    for name, s, e in rec["kernels"]:
        if not fam(name).startswith("pair:"):
            continue
        body = fam.body(name)
        if body not in counts.BODIES:
            return None
        bound += counts.bound_s(*counts.pair_work(body, rec["work"]))
        spent += (e - s) / 1e9
    return 100.0 * bound / spent if spent > 0 else None

"""Pairs kept over candidates tested by the program's counting walk (the
pair kernels' walk with a counting body, once a step, over the rows the
passes produce), over the segment replayed with the program's spans on,
in percent."""


def read(rec):
    prog = rec.get("program")
    if not prog:
        return None
    c = prog["counters"]
    tested = c.get("pair_candidates", 0)
    return 100.0 * c.get("pair_kept", 0) / tested if tested else None

"""Device time inside the program's ``neighbor_prep`` span (the sort, the
gather and the cell or window table) per step of the segment replayed with
the program's spans on, in ms."""
import program_trace


def read(rec):
    prog = rec.get("program")
    if not prog:
        return None
    ns = program_trace.per_replay(prog, names=("neighbor_prep",))
    return sum(ns.values()) / 1e6 / prog["steps"] if ns else None

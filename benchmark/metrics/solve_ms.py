"""Device time inside the pressure solver's loop spans (DFSPH: the
``dfsph.density`` and ``dfsph.divergence`` WHILE nodes) per step of the
segment replayed with the program's spans on, in ms."""
import program_trace


def read(rec):
    prog = rec.get("program")
    if not prog:
        return None
    ns = program_trace.per_replay(prog, names=program_trace.SOLVER_LOOPS)
    return sum(ns.values()) / 1e6 / prog["steps"] if ns else None

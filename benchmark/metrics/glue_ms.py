"""Device time inside the ``step`` span outside every pair launch
(``pair.*``), ``neighbor_prep`` and ``pair_count``, per step of the segment
replayed with the program's spans on, in ms: the tensor glue between the
passes, by stage in ``program_trace``'s record."""
import program_trace


def read(rec):
    prog = rec.get("program")
    if not prog:
        return None
    step = program_trace.step_ns(prog)
    if not step:
        return None
    inner = program_trace.per_replay(prog, names=program_trace.NOT_GLUE,
                                     prefix="pair.")
    glue = sum(ns - inner.get(r, 0.0) for r, ns in step.items())
    return glue / 1e6 / len(step)

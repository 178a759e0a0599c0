"""Device time between one replay's closing ``step`` stamp and the next
replay's opening one, on the device's timer, averaged over the segment
replayed with the program's spans on (``program_trace.program_pass``), in
ms: the time the card waits for the host between two steps (a gap
across one of the pass's own reads left out)."""


def read(rec):
    prog = rec.get("program")
    if not prog:
        return None
    skip = set(prog.get("read_after", ()))
    steps = sorted((r, s, e) for name, r, s, e in prog["spans"]
                   if name == "step")
    gaps = [b[1] - a[2] for a, b in zip(steps, steps[1:])
            if b[0] == a[0] + 1 and a[0] not in skip]
    return sum(gaps) / len(gaps) / 1e6 if gaps else None

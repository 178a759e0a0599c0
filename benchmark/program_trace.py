"""The program's own spans and counters over one replayed segment.

A pass of a ``--trace 1`` run, after ``Cell.traced_pass`` (which stays
first, on the step captured without tracing, so the per-layer metrics of
the device trace read what they read before) and before ``Cell.free``:
:func:`program_pass` captures the step again with tracing on
(``Simulation.trace``), replays one segment from the snapshot as the window
replays it (``Simulation.step`` and one host read a step, unprofiled) and
reads the program's spans and counters; on the card it then replays
:data:`PROFILED_STEPS` steps in ``torch.profiler`` sessions, holds each
device stamp, mapped onto the profiler's timeline, to its own stamp
kernel's interval, and names the program's host span that was open when
each idle gap began. The record it returns is what the readers
``metrics/replay_gap_ms.py``, ``prep_ms.py``, ``solve_ms.py``,
``glue_ms.py`` and ``pair_hit_rate.py`` read, under ``rec["program"]``.

A program without spans (``Simulation`` with no ``trace`` method) gives
None, and every reader then reads nothing.
"""
from __future__ import annotations

import bisect
import time

import torch

import bench_trace

# steps replayed under the profiler, and steps a session
PROFILED_STEPS = 20
SESSION_STEPS = 5
# idle gaps at least this long are named in the log (ns)
GAP_NS = 20_000
# the loops of the pressure solvers, whose spans solve_ms sums
SOLVER_LOOPS = ("dfsph.density", "dfsph.divergence", "pcisph.pressure",
                "iisph.pressure")
# spans whose time glue_ms leaves out besides the pair launches
NOT_GLUE = ("neighbor_prep", "pair_count")


def _step_spans(read: dict) -> list:
    """``(name, replay, start, end)`` of the step's spans of one read, on
    the device's own timer where they are stamps, else on the host's
    clock; host spans (``sph.*``) left out."""
    own = read.get("device_ns", {})
    out = []
    for s in read["spans"]:
        if s.name.startswith("sph."):
            continue
        start, end = own.get(s.seq, (s.start, s.end))
        out.append((s.name, s.replay, start, end))
    return out


def program_pass(cell, log=print) -> dict | None:
    """The program-traced pass over ``cell`` (a ``harness.Cell`` after its
    set-up): the record the five readers read, or None for a program
    without spans."""
    from sph_project_tpu_torch.utils.telemetry import host_values
    sim = cell.sim
    if not hasattr(sim, "trace"):
        return None
    seg = cell.spec["traffic"]["segment_steps"]
    t0 = time.perf_counter()
    sim.trace(True)
    capture_s = time.perf_counter() - t0
    trace = sim.recording
    sim.state = cell.snapshot
    cell._sync()
    if trace.on_card:
        trace.calibrate()
    sim.spans()
    rows = []
    t0 = time.perf_counter()
    rows.append(host_values(sim.step(), trace))
    # the first step's counts alone: the walk ran on the positions the
    # step's resort sorted, which the window's held state keeps
    first = sim.spans()
    for _ in range(seg - 1):
        rows.append(host_values(sim.step(), trace))
    wall_s = time.perf_counter() - t0
    rest = sim.spans()
    reads = [first, rest]
    counters = {k: first["counters"].get(k, 0) + rest["counters"].get(k, 0)
                for k in set(first["counters"]) | set(rest["counters"])}
    ticks: dict = {}
    for r in reads:
        for key, n in r["ticks"].items():
            ticks[key] = ticks.get(key, 0) + n
    spans = _step_spans(first) + _step_spans(rest)
    replays = sorted({r for name, r, _, _ in spans if name == "step"})
    gap_of = replay_gaps(rest)
    log_replay_gaps(gap_of, log)
    out = dict(steps=seg, wall_s=wall_s, capture_s=capture_s,
               spans=spans, replays=replays, diags=rows,
               # a read (a synchronisation) lies between these replays and
               # the next
               read_after=[max((r for n, r, _, _ in _step_spans(first)
                                if n == "step"), default=None)],
               replay_gaps=gap_of,
               ticks=[[name, r, n] for (name, r), n in sorted(ticks.items())],
               counters=counters, first_counters=first["counters"],
               dropped=sum(r["dropped"] for r in reads),
               stamps_per_step=sum(len(r["stamps"]) for r in reads) / seg,
               offset_ns=rest["offset_ns"],
               offset_uncertainty_ns=rest["offset_uncertainty_ns"],
               drift_ppm=rest["drift_ppm"],
               timer_step_ns=rest["timer_step_ns"],
               on_card=bool(trace.on_card))
    if trace.on_card:
        out.update(profiled(cell, sim, trace, log))
    return out


def replay_gaps(read: dict) -> dict:
    """``{host span: (gaps, us)}``: the intervals from one replay's closing
    ``step`` stamp to the next replay's opening one, on the host's clock,
    each named by the innermost of the program's host spans (``sph.*``)
    open when it began, or "none"; and under ``"during"`` the us of all of
    them that each host span covered ("none": no span)."""
    steps = sorted((s for s in read["spans"] if s.name == "step"
                    and s.where == "device"), key=lambda s: s.replay)
    host = [(s.name, s.start, s.end) for s in read["spans"]
            if s.where == "host" and s.name.startswith("sph.")]
    out: dict = {}
    during: dict = {}
    for a, b in zip(steps, steps[1:]):
        if b.replay != a.replay + 1:
            continue
        label = _open_at(host, a.end)
        n, us = out.get(label, (0, 0.0))
        out[label] = (n + 1, us + (b.start - a.end) / 1e3)
        covered = 0.0
        for name, s, e in host:
            o = min(e, b.start) - max(s, a.end)
            if o > 0:
                during[name] = during.get(name, 0.0) + o / 1e3
                covered += o
        during["none"] = during.get("none", 0.0) + \
            (b.start - a.end - covered) / 1e3
    if during:
        out["during"] = during
    return out


def log_replay_gaps(gap_of: dict, log) -> None:
    """One log line of :func:`replay_gaps`: gaps and us by the host span
    open at their start, then the us a gap under each host span."""
    named = sorted(((k, v) for k, v in gap_of.items() if k != "during"),
                   key=lambda x: -x[1][1])
    gaps = max(sum(n for _, (n, _) in named), 1)
    log("program pass, the device idle between replays by the program's "
        "host span open when it began: " + ", ".join(
            f"{k} {n} gaps, {us / n:.1f} us each" for k, (n, us) in named)
        + "; us a gap under each host span: " + ", ".join(
            f"{k} {us / gaps:.1f}"
            for k, us in gap_of.get("during", {}).items()))


def _open_at(spans: list, t: float) -> str:
    """The innermost of ``spans`` ((name, start, end)) open at ``t``: the
    latest to open of those open, or "none"."""
    label, opened = "none", None
    for name, s, e in spans:
        if s <= t < e and (opened is None or s >= opened):
            label, opened = name, s
    return label


def profiled(cell, sim, trace, log) -> dict:
    """:data:`PROFILED_STEPS` steps in profiler sessions of
    :data:`SESSION_STEPS`: each device stamp, mapped onto the host's clock
    by the program (``Trace.to_host``) and from there onto the profiler's
    (the profiler keeps Unix time: ``time.time_ns`` against
    ``time.perf_counter_ns``, read together), against its own stamp
    kernel's interval; beside it the offset that the stamps alone allow in
    each session. The idle gaps are named by the program's host span that
    was open when they began."""
    from torch.profiler import ProfilerActivity, profile

    from sph_project_tpu_torch.utils.telemetry import host_values
    sim.state = cell.snapshot
    cell._sync()
    trace.calibrate()
    sim.spans()
    cuda = torch.autograd.DeviceType.CUDA
    stamps_in = stamps_all = lost = 0
    sessions, gap_log = [], []
    gaps: dict = {}
    done = 0
    while done < PROFILED_STEPS:
        n = min(SESSION_STEPS, PROFILED_STEPS - done)
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(n):
                host_values(sim.step(), trace)
            torch.cuda.synchronize(cell.device)
        done += n
        trace.calibrate()
        unix = unix_offset_ns()
        read = sim.spans()
        dev, host = [], []
        for e in prof.profiler.kineto_results.events():
            s, d = e.start_ns(), e.duration_ns()
            if e.name().startswith("sph."):
                if e.device_type() != cuda:
                    host.append((e.name(), s, s + d))
            elif e.device_type() == cuda:
                dev.append((e.name(), s, s + d))
        kernels = sorted((s, e) for name, s, e in dev
                         if "stamp_kernel" in name)
        # (on the profiler's clock, on the device's timer, span, kind)
        stamps = [(trace.to_host(t) + unix, t, name, kind)
                  for _, name, kind, t in read["stamps"]]
        stamps_all += len(stamps)
        lost += abs(len(kernels) - len(stamps))
        if len(kernels) == len(stamps):
            pairs = list(zip(stamps, kernels))
        else:
            # the profiler lost some: each stamp takes the kernel nearest
            mids = [(a + b) / 2 for a, b in kernels]
            pairs = []
            for st in stamps:
                i = bisect.bisect_left(mids, st[0])
                near = min((j for j in (i - 1, i) if 0 <= j < len(mids)),
                           key=lambda j: abs(mids[j] - st[0]))
                pairs.append((st, kernels[near]))
        inside = sum(ks <= st[0] <= ke for st, (ks, ke) in pairs)
        stamps_in += inside
        # the device's timer to the profiler's clock from the stamps alone
        f_lo = max(ks - st[1] for st, (ks, _) in pairs)
        f_hi = min(ke - st[1] for st, (_, ke) in pairs)
        mid = sorted((ks + ke) / 2 - st[1] for st, (ks, ke) in pairs)
        mid = mid[len(mid) // 2]
        sessions.append(dict(
            stamps=len(stamps), kernels=len(kernels), inside=inside,
            fit_ns=[f_lo, f_hi],
            inside_fit=sum(ks <= st[1] + mid <= ke for st, (ks, ke) in pairs),
            program_minus_fit_ns=stamps[0][0] - stamps[0][1] - mid,
            anchor_uncertainty_ns=read["offset_uncertainty_ns"],
            drift_ppm=read["drift_ppm"],
            stamp_kernel_us=sorted((ke - ks) / 1e3 for _, (ks, ke)
                                   in pairs)[len(pairs) // 2],
            residual_us=[round((ks + ke) / 2 - st[1] - mid) / 1e3
                         for st, (ks, ke) in pairs[:: max(1, len(pairs)
                                                          // 40)]]))
        busy = [(s, e) for name, s, e in dev]
        # the device's work and idle between one replay's closing stamp
        # kernel and the next one's opening
        ends = [ke for st, (_, ke) in pairs if st[2] == "step"
                and st[3] == 1]
        begins = [ks for st, (ks, _) in pairs if st[2] == "step"
                  and st[3] == 0]
        for a, b in zip(ends, begins[1:]):
            inner = [(max(x, a), min(y, b)) for x, y in busy
                     if y > a and x < b]
            sessions[-1].setdefault("replay_gaps_us", []).append(
                [(b - a) / 1e3, union_ns(inner) / 1e3])
        for label, a, b in _gaps(busy, host, min(s for s, _ in busy),
                                 max(e for _, e in busy)):
            if b - a >= GAP_NS:
                gaps[label] = gaps.get(label, 0) + 1
                gap_log.append((label, (b - a) / 1e3))
    out = dict(profiled_steps=done, stamps_profiled=stamps_all,
               stamps_inside=stamps_in, stamp_kernels_unmatched=lost,
               inside_share=stamps_in / stamps_all if stamps_all else None,
               sessions=sessions, gaps_20us=gaps)
    log(f"program pass, clock: {stamps_in} of {stamps_all} stamps inside "
        f"their own stamp kernel's interval through the program's offset; "
        f"{lost} stamp kernels unmatched; by session: " + "; ".join(
            f"{x['inside']}/{x['stamps']} inside (under the stamps' own "
            f"median offset {x['inside_fit']}), stamps alone fit "
            f"[{x['fit_ns'][0]}, {x['fit_ns'][1]}] ns, the program's offset "
            f"{x['program_minus_fit_ns']:.0f} ns from their median, anchor "
            f"+-{x['anchor_uncertainty_ns']:.0f} ns, drift "
            f"{x['drift_ppm']} ppm, stamp kernel {x['stamp_kernel_us']:.2f} "
            f"us" for x in sessions))
    pairs_us = [g for x in sessions for g in x.get("replay_gaps_us", ())]
    if pairs_us:
        log(f"program pass, profiled replay gaps: {len(pairs_us)}, mean "
            f"{sum(g for g, _ in pairs_us) / len(pairs_us):.1f} us, of "
            f"which device work "
            f"{sum(b for _, b in pairs_us) / len(pairs_us):.1f} us")
    log("program pass, idle gaps of 20 us or more by the program's host "
        "span open when they began: " + ", ".join(
            f"{k} {v}" for k, v in sorted(gaps.items(), key=lambda x: -x[1])))
    log("program pass, the longest: " + ", ".join(
        f"{k} {us:.1f} us" for k, us in sorted(gap_log,
                                               key=lambda x: -x[1])[:12]))
    return out


def unix_offset_ns() -> float:
    """Unix time (the profiler's clock) less the host's monotonic clock:
    the closest of a few back-to-back readings."""
    best = None
    for _ in range(16):
        a = time.perf_counter_ns()
        u = time.time_ns()
        b = time.perf_counter_ns()
        if best is None or b - a < best[0]:
            best = (b - a, u - (a + b) / 2)
    return best[1]


def _gaps(busy: list, spans: list, lo: int, hi: int) -> list:
    """(innermost host span open at the gap's start, or "none", start,
    end) of every interval in [lo, hi] with no device operation."""
    out, end = [], lo
    for s, e in sorted(busy):
        if s > end:
            out.append((end, s))
        end = max(end, e)
    return [(_open_at(spans, a), a, b) for a, b in out]


def union_ns(intervals) -> float:
    return bench_trace.union_ns(intervals)


def per_replay(rec: dict, names=None, prefix=None) -> dict:
    """``{replay: ns}`` inside the spans named in ``names`` or starting with
    ``prefix`` (their union within each replay)."""
    by: dict = {}
    for name, replay, s, e in rec["spans"]:
        if (names and name in names) or (prefix and name.startswith(prefix)):
            by.setdefault(replay, []).append((s, e))
    return {r: union_ns(v) for r, v in by.items()}


def step_ns(rec: dict) -> dict:
    return per_replay(rec, names=("step",))

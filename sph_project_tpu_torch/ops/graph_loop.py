"""Loops that stay on the device: ``while_loop`` and the captured step.

The JAX package keeps a step on the device: ``jax.jit`` compiles it into one
program and every solver loop is a ``jax.lax.while_loop`` in it
(``solvers/dfsph.py`` :427 and :494, ``pcisph.py`` :126, ``iisph.py`` :163,
``viscosity_cg.py`` :147). Here :func:`capture` records a step into a CUDA
graph (``torch.cuda.graph``) and :func:`while_loop` has the meaning of
``jax.lax.while_loop`` (``carry`` a tuple of tensors, ``cond(carry)`` a
0-dim bool or int32 tensor, ``body(carry)`` the next carry) in two modes:

- on a stream that is not capturing (the CPU, the card's eager step, the
  spatial decomposition) it loops on the host and reads the flag once an
  iteration;
- on a stream that :func:`capture` is capturing it places a conditional
  WHILE node (``csrc/graph_loop.cu``): the condition kernel sets the node's
  condition from the flag once before the node and once at the end of each
  iteration, so a replay runs every iteration with no host read. The body
  graph replays with fixed addresses, so the carry lives in buffers of the
  loop's own, which each iteration overwrites in place (``copy_``); the
  body's temporaries come from a memory pool of the capture's, which lives
  as long as its graph.

A capture that fails raises; nothing falls back to the host loop on the card.

Spans. A :class:`Trace` records the spans of a step: :func:`span` marks one
stage of the step code, :func:`while_loop` makes each loop a span with one
tick at the end of every iteration, :func:`count` adds to a named counter,
and :func:`host_span` marks host work around the step (``sph.*``). Step code
records only inside :func:`tracing`, which a simulation enters around the
capture of a step made with tracing on (and around an eager step): under a
capture a span places two stamp kernels (``csrc/graph_loop.cu``), which
write the device's timer into the trace's device table on every replay;
on the CPU it reads ``time.perf_counter_ns``. Outside :func:`tracing` a span
does nothing and costs one test of :data:`_active`, paid while Python runs
the step code: on the card at the capture, never at a replay.
:meth:`Trace.read` returns what was recorded, the device's times mapped
onto the host's clock by anchors (:meth:`Trace.calibrate`).

Launch accounting. The kernel wrappers count their launches in Python
(``pair_kernels.launches``, ``permute.launches`` and :data:`launches`, the
condition kernel's), so a replay adds nothing by itself. :func:`capture`
counts each region's launches while it is captured and puts the counts back:
the launches outside the loops are added once per replay
(:meth:`Captured.replayed`), and each loop's condition kernel counts the
iterations it lets through on the device, which :func:`flush_launches`
multiplies by the launches of one iteration (one synchronisation, made only
where a caller reads the counts).
"""
from __future__ import annotations

import collections
import contextlib
import ctypes
import functools
import time
from typing import Callable, List, Sequence, Tuple

import torch

from . import _build

# the condition kernel's launches: one before each loop node per replay, one
# per iteration
launches = {"graph_while": 0}
# the launch counts of every kernel wrapper (register_counts)
_counted: List[dict] = [launches]
# captures with loops whose device iteration counts are not yet added in
_pending: list = []
# captures under way, the innermost last
_stack: list = []
_warming = False
# WHILE nodes a capture may hold: its loops' device iteration counts live in
# one buffer made before the capture (a count is read and written across
# replays, so it must not lie in the graph's pool, whose blocks the graph
# reuses within a replay)
MAX_LOOPS = 16


def register_counts(counts: dict) -> None:
    """Account the launches ``counts`` records per replay (a wrapper's
    ``launches``)."""
    _counted.append(counts)


def _snapshot() -> List[dict]:
    return [dict(d) for d in _counted]


def _restore(snap: List[dict]) -> None:
    for d, s in zip(_counted, snap):
        d.clear()
        d.update(s)


def _delta(snap: List[dict]) -> List[dict]:
    return [{k: v - s.get(k, 0) for k, v in d.items() if v != s.get(k, 0)}
            for d, s in zip(_counted, snap)]


def _add(delta: List[dict], times: int) -> None:
    for d, dd in zip(_counted, delta):
        for k, v in dd.items():
            d[k] = d.get(k, 0) + v * times


class Captured:
    """The launch accounting of one captured graph: the launches of a replay
    outside its loops, and per loop a device count of the iterations its
    replays ran with the launches of one iteration, and the loop's name."""

    def __init__(self):
        self.outer: List[dict] = []
        self.loops: List[Tuple[torch.Tensor, List[dict]]] = []
        self.names: List[str] = []
        # iterations per loop index, added at each flush
        self.totals: dict = {}
        self.counters = None
        self.body_pool = None
        self.in_body = False

    def replayed(self) -> None:
        """Count one replay (no host read)."""
        _add(self.outer, 1)
        if self.loops and not any(r is self for r in _pending):
            _pending.append(self)

    def iterations(self) -> dict:
        """``{loop name: iterations}`` over every replay so far, from the
        device counts (:func:`flush_launches`: one synchronisation)."""
        flush_launches()
        out: dict = {}
        for i, name in enumerate(self.names):
            out[name] = out.get(name, 0) + self.totals.get(i, 0)
        return out


def flush_launches() -> None:
    """Add the loop iterations of every replay so far to the launch counts
    (reads the device counts: one synchronisation), and zero the device
    counts."""
    for rec in _pending:
        counts = rec.counters[:len(rec.loops)].tolist()
        for i, ((_, delta), n) in enumerate(zip(rec.loops, counts)):
            _add(delta, n)
            rec.totals[i] = rec.totals.get(i, 0) + n
        rec.counters.zero_()
    _pending.clear()


@contextlib.contextmanager
def uncounted():
    """Launches made inside are not counted (the warm-up before a capture)."""
    snap = _snapshot()
    try:
        yield
    finally:
        _restore(snap)


@contextlib.contextmanager
def warming():
    """The warm-up step before a capture: a loop that runs no iteration runs
    its body once all the same, result dropped, so that every kernel, library
    and cached constant of the body is loaded before the capture reaches it
    (a host-to-device copy cannot be captured)."""
    global _warming
    _warming, before = True, _warming
    try:
        yield
    finally:
        _warming = before


@functools.cache
def _lib():
    lib = _build.load("graph_loop")
    lib.sph_while_begin.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.POINTER(ctypes.c_ulonglong)]
    lib.sph_while_cond.argtypes = [ctypes.c_ulonglong, ctypes.c_void_p,
                                   ctypes.c_void_p, ctypes.c_void_p]
    lib.sph_while_end.argtypes = [ctypes.c_void_p]
    lib.sph_stamp.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                              ctypes.c_void_p, ctypes.c_ulonglong,
                              ctypes.c_ulonglong, ctypes.c_int]
    lib.sph_stamp_runs.argtypes = [ctypes.POINTER(ctypes.c_ulonglong)]
    lib.sph_clock_anchor.argtypes = [ctypes.c_void_p,
                                     ctypes.POINTER(ctypes.c_longlong)]
    for fn in (lib.sph_while_begin, lib.sph_while_cond, lib.sph_while_end,
               lib.sph_stamp, lib.sph_stamp_runs, lib.sph_clock_anchor):
        fn.restype = ctypes.c_int
    return lib


@functools.cache
def _side_stream(index: int) -> torch.cuda.Stream:
    """The stream a loop body is captured on, one per device."""
    return torch.cuda.Stream(device=index)


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"graph_loop: {what} failed, CUDA error {err}")


def capturing(t: torch.Tensor) -> bool:
    """Whether ``t``'s device is a card whose current stream is capturing."""
    return t.device.type == "cuda" and torch.cuda.is_current_stream_capturing()


def capture(fn: Callable, device=None, trace=None):
    """Capture ``fn()`` into a CUDA graph on ``device`` (a card; raises
    without one), inside :func:`tracing` of ``trace`` when one is given (a
    :class:`Trace` of that device, its buffers allocated first). Returns
    (graph, :class:`Captured`, what ``fn`` returned). Nothing runs:
    ``graph.replay()`` then ``Captured.replayed()`` run it."""
    if not torch.cuda.is_available():
        raise RuntimeError("graph_loop.capture: CUDA is not available")
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"graph_loop.capture: {device} is not a card")
    if trace is not None:
        trace.allocate()
    rec = Captured()
    rec.counters = torch.zeros(MAX_LOOPS, dtype=torch.int64, device=device)
    rec.body_pool = torch.cuda.MemPool()
    graph = torch.cuda.CUDAGraph()
    snap = _snapshot()
    _stack.append(rec)
    try:
        with torch.cuda.device(device), torch.cuda.graph(graph), \
                tracing(trace):
            out = fn()
    finally:
        _stack.pop()
        rec.outer = _delta(snap)
        _restore(snap)
    return graph, rec, out


def _flag(x: torch.Tensor) -> torch.Tensor:
    if x.dim() != 0 or x.dtype not in (torch.bool, torch.int32):
        raise ValueError(f"while_loop: cond gave a {x.dtype} tensor of shape "
                         f"{tuple(x.shape)}, not a 0-dim bool or int32")
    return x.to(torch.int32)


def _assign(buf: Sequence[torch.Tensor], new: Sequence[torch.Tensor]) -> None:
    """``buf[i].copy_(new[i])`` for every i, as if all at once: a new value
    that shares memory with a buffer is copied aside first."""
    if len(new) != len(buf):
        raise ValueError(f"while_loop: body gave {len(new)} values for a "
                         f"carry of {len(buf)}")
    held = {b.untyped_storage().data_ptr() for b in buf}
    for b, n in zip(buf, new):
        if n.shape != b.shape or n.dtype != b.dtype:
            raise ValueError(f"while_loop: body changed a carry from "
                             f"{b.dtype} {tuple(b.shape)} to {n.dtype} "
                             f"{tuple(n.shape)}")
    new = [n if n is b or n.untyped_storage().data_ptr() not in held
           else n.clone() for b, n in zip(buf, new)]
    for b, n in zip(buf, new):
        if n is not b:
            b.copy_(n)


def while_loop(cond: Callable, body: Callable, carry: Sequence[torch.Tensor],
               name: str = "while_loop"):
    """``jax.lax.while_loop(cond, body, carry)`` over a tuple of tensors (see
    the module docstring): a host loop, or a WHILE node under a capture. The
    loop is the span ``name``, with a tick at the end of every iteration,
    and a captured loop's iterations are counted under that name
    (:meth:`Captured.iterations`)."""
    carry = tuple(carry)
    if capturing(carry[0]):
        with span(name):
            return _graph_while(cond, body, carry, name)
    ran = False
    with span(name):
        while bool(_flag(cond(carry))):
            carry = tuple(body(carry))
            tick(name)
            ran = True
    if _warming and not ran:
        body(carry)
    return carry


def _graph_while(cond: Callable, body: Callable, carry: tuple,
                 name: str) -> tuple:
    """A WHILE node in the capture under way: the loop's carry buffers,
    the entry test, the node, and the body captured into the node's graph
    on a side stream, its allocations from the capture's body pool."""
    if not _stack:
        raise RuntimeError("while_loop: a capture that graph_loop.capture "
                           "did not start")
    rec = _stack[-1]
    if rec.in_body:
        raise NotImplementedError("while_loop: a loop inside a captured "
                                  "loop's body")
    if len(rec.loops) == MAX_LOOPS:
        raise NotImplementedError(f"while_loop: more than {MAX_LOOPS} loops "
                                  f"in one capture")
    dev = carry[0].device
    lib = _lib()
    buf = tuple(c.clone() for c in carry)
    count = rec.counters[len(rec.loops)]
    flag = _flag(cond(buf))
    handle = ctypes.c_ulonglong()
    side = _side_stream(dev.index)
    _check(lib.sph_while_begin(torch.cuda.current_stream(dev).cuda_stream,
                               side.cuda_stream, flag.data_ptr(),
                               count.data_ptr(), ctypes.byref(handle)),
           "placing the WHILE node")
    launches["graph_while"] += 1
    snap = _snapshot()
    rec.in_body = True
    try:
        with torch.cuda.use_mem_pool(rec.body_pool, dev), \
                torch.cuda.stream(side):
            _assign(buf, tuple(body(buf)))
            flag = _flag(cond(buf))
            _check(lib.sph_while_cond(handle.value, flag.data_ptr(),
                                      count.data_ptr(), side.cuda_stream),
                   "the condition kernel")
            launches["graph_while"] += 1
            tick(name)
    finally:
        rec.in_body = False
        _check(lib.sph_while_end(side.cuda_stream), "ending the body capture")
    rec.loops.append((count, _delta(snap)))
    rec.names.append(name)
    _restore(snap)
    return buf


# ---- spans ------------------------------------------------------------------

# an event's kind
OPEN, CLOSE, TICK = 0, 1, 2
# events a trace's device table holds; a stamp past them is counted dropped
TABLE_CAP = 1 << 18
# named counters a trace keeps
MAX_COUNTERS = 8
# anchors of one clock calibration, and the age in seconds past which a
# read calibrates again
ANCHORS = 16
CALIBRATE_EVERY_S = 1.0
_NULL = contextlib.nullcontext()
# the trace that span, tick and count record into (tracing)
_active = None

# a closed span: its name, "device" or "host", the replay index, start and
# end (ns, host clock), its sequence number and its parent's (-1: none)
Span = collections.namedtuple(
    "Span", "name where replay start end seq parent")


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


class Trace:
    """The spans and counters of one simulation's steps on ``device``.

    Events are ``(replay index, span id, kind)`` at a time: on the card
    (``device`` a CUDA device) the step's spans are stamps in a device table
    of :data:`TABLE_CAP` events, written by every replay of a step captured in
    :func:`tracing`; on the CPU they, and every host span, are host events on
    ``time.perf_counter_ns``. The replay index is the number of steps begun,
    so the events of one step share it. Counters (:func:`count`) are int64
    on the device. Nothing is allocated on the device until a capture
    (:meth:`allocate`)."""

    def __init__(self, device="cpu"):
        self.device = torch.device(device)
        self.names: List[str] = []
        self._ids: dict = {}
        self.replay = 0
        self.host: list = []
        self.counter_names: List[str] = []
        self.meta = self.table = self.counters = None
        # per track, the spans open at the last read: (name, replay, start
        # on the host's clock, start on the track's own, sequence number)
        self._open = {"host": [], "device": []}
        self._seq = 0
        # the last two calibrations: (host ns when taken, the device's ns,
        # offset ns, uncertainty ns, timer step ns)
        self.anchors: list = []

    @property
    def on_card(self) -> bool:
        return self.device.type == "cuda"

    def _id(self, name: str) -> int:
        i = self._ids.get(name)
        if i is None:
            i = self._ids[name] = len(self.names)
            self.names.append(name)
        return i

    def allocate(self) -> None:
        """The device table, its cursor and the counters (once)."""
        if self.counters is not None:
            return
        self.counters = torch.zeros(MAX_COUNTERS, dtype=torch.int64,
                                    device=self.device)
        if self.on_card:
            self.meta = torch.zeros(3, dtype=torch.int64, device=self.device)
            self.table = torch.zeros((TABLE_CAP, 2), dtype=torch.int64,
                                     device=self.device)

    def stamp(self, name: str, kind: int, begin: bool = False) -> None:
        """One event of span ``name``: a stamp kernel on the current stream
        on the card, the host's clock elsewhere. ``begin``: the step's
        opening event, which advances the replay index."""
        code = self._id(name) << 2 | kind
        if self.on_card:
            self.allocate()
            stream = torch.cuda.current_stream(self.device).cuda_stream
            _check(_lib().sph_stamp(stream, self.meta.data_ptr(),
                                    self.table.data_ptr(), TABLE_CAP,
                                    code, int(begin)), "the stamp kernel")
            return
        if begin:
            self.replay += 1
        self.host.append((self.replay, code, time.perf_counter_ns()))

    def host_event(self, name: str, kind: int) -> None:
        """An event of a host span, on the host's clock."""
        self.host.append((self.replay, self._id(name) << 2 | kind,
                          time.perf_counter_ns()))

    def count(self, name: str, value: torch.Tensor) -> None:
        """Add ``value`` (a 0-dim integer tensor) to counter ``name``."""
        if name not in self.counter_names:
            if len(self.counter_names) == MAX_COUNTERS:
                raise NotImplementedError(f"Trace: more than {MAX_COUNTERS} "
                                          f"counters")
            self.counter_names.append(name)
        self.allocate()
        k = self.counter_names.index(name)
        self.counters[k:k + 1].add_(value.reshape(1).to(torch.int64))

    def reset_device(self) -> None:
        """Empty the device table and set its replay index to the host's
        (after a warm-up step whose stamps are not a replay's)."""
        if self.meta is not None:
            self.meta.copy_(torch.tensor([0, 0, self.replay],
                                         dtype=torch.int64))
            self.counters.zero_()

    def calibrate(self) -> tuple:
        """Map the device's timer onto the host's clock: :data:`ANCHORS`
        anchors
        (``csrc/graph_loop.cu`` ``sph_clock_anchor``), each a device reading
        between two host readings, so host - device lies in [t_w - g, t_r -
        g]; the tightest interval of them gives the offset (its midpoint)
        and its uncertainty (half its width). Between two calibrations the
        offset is taken linear in the device's time (:meth:`to_host`): the
        two clocks drift apart by some µs a second. Returns (offset ns,
        uncertainty ns, the timer's step ns)."""
        torch.cuda.synchronize(self.device)
        out = (ctypes.c_longlong * 4)()
        best = None
        with torch.cuda.device(self.device):
            stream = torch.cuda.current_stream(self.device).cuda_stream
            for _ in range(ANCHORS):
                _check(_lib().sph_clock_anchor(stream, out), "a clock anchor")
                t_w, g, t_r, step = out
                if best is None or t_r - t_w < best[2] - best[1]:
                    best = (g, t_w - g, t_r - g, step)
        g, lo, hi, step = best
        self.anchors = self.anchors[-1:] + [
            (time.perf_counter_ns(), g, (lo + hi) / 2, (hi - lo) / 2, step)]
        return self.anchors[-1][2:]

    def to_host(self, t: float) -> float:
        """Device time ``t`` (ns) on the host's clock: the offset of the
        last calibration, moved by the drift between the last two."""
        _, g1, off1, _, _ = self.anchors[-1]
        if len(self.anchors) < 2 or self.anchors[0][1] == g1:
            return t + off1
        _, g0, off0, _, _ = self.anchors[0]
        return t + off1 + (off1 - off0) * (t - g1) / (g1 - g0)

    def drift_ppm(self) -> float | None:
        """The device timer's drift against the host's clock between the
        last two calibrations, in parts per million."""
        if len(self.anchors) < 2 or self.anchors[0][1] == self.anchors[1][1]:
            return None
        (_, g0, off0, _, _), (_, g1, off1, _, _) = self.anchors
        return (off1 - off0) / (g1 - g0) * 1e6

    def read(self) -> dict:
        """What was recorded since the last read (on the card after one
        synchronisation, calibrating the clock when the last anchor is
        older than :data:`CALIBRATE_EVERY_S`); empties the table and zeroes
        the counters. Returns ``spans`` (closed :class:`Span` s, on the
        host's clock), ``ticks`` (``{(loop, replay): iterations}``),
        ``stamps`` (the device's events in the order written: replay, span,
        kind, the device's ns),
        ``counters``, ``dropped`` (events the full table did not take),
        ``offset_ns`` and ``offset_uncertainty_ns`` (device timer to host
        clock, at the last calibration; 0 off the card), ``drift_ppm``,
        ``timer_step_ns`` and ``device_ns`` (``{sequence number: (start,
        end)}`` of the device spans on the device's own timer)."""
        host, self.host = self.host, []
        out = dict(spans=[], ticks={}, counters={}, dropped=0, offset_ns=0.0,
                   offset_uncertainty_ns=0.0, drift_ppm=None, timer_step_ns=0,
                   device_ns={}, stamps=[])
        self._pair("host", [(r, c, t, t) for r, c, t in host], out)
        if self.meta is not None:
            torch.cuda.synchronize(self.device)
            n, dropped, _ = self.meta.tolist()
            rows = self.table[:n].tolist()
            self.meta[:2].zero_()
            if not self.anchors or time.perf_counter_ns() - \
                    self.anchors[-1][0] > CALIBRATE_EVERY_S * 1e9:
                self.calibrate()
            _, _, offset, unc, step = self.anchors[-1]
            out.update(dropped=dropped, offset_ns=offset,
                       offset_uncertainty_ns=unc, timer_step_ns=step,
                       drift_ppm=self.drift_ppm())
            events = [(w >> 20, w & 0xFFFFF, self.to_host(t), t)
                      for w, t in rows]
            out["stamps"] = [(r, self.names[c >> 2], c & 3, t)
                             for r, c, _, t in events]
            self._pair("device", events, out)
        if self.counters is not None:
            out["counters"] = dict(zip(self.counter_names,
                                       self.counters.tolist()))
            self.counters.zero_()
        return out

    def _pair(self, where: str, events: list, out: dict) -> None:
        """Open and close events of one track, in the order recorded, into
        closed spans (a close ends the innermost open span); ticks counted
        per loop and replay."""
        stack = self._open[where]
        for replay, code, t, t_own in events:
            name, kind = self.names[code >> 2], code & 3
            if kind == OPEN:
                stack.append((name, replay, t, t_own, self._seq))
                self._seq += 1
            elif kind == CLOSE:
                # a close ends the innermost open span of its name; spans
                # opened inside it and never closed (their close events
                # dropped by a full table) end with it unrecorded
                at = next((k for k in range(len(stack) - 1, -1, -1)
                           if stack[k][0] == name), None)
                if at is None:
                    continue
                del stack[at + 1:]
                o_name, o_replay, t0, t0_own, seq = stack.pop()
                parent = stack[-1][4] if stack else -1
                out["spans"].append(Span(name, where, o_replay, t0, t, seq,
                                         parent))
                if where == "device":
                    out["device_ns"][seq] = (t0_own, t_own)
            else:
                key = (name, replay)
                out["ticks"][key] = out["ticks"].get(key, 0) + 1



def stamp_runs(device) -> int:
    """Stamp kernels run on the card ``device`` so far, of every trace (one
    synchronisation)."""
    n = ctypes.c_ulonglong()
    with torch.cuda.device(device):
        _check(_lib().sph_stamp_runs(ctypes.byref(n)), "reading the stamp "
               "count")
    return n.value


@contextlib.contextmanager
def tracing(trace):
    """Record the spans of step code run inside into ``trace`` (a
    :class:`Trace`, or None: nothing is recorded)."""
    global _active
    _active, before = trace, _active
    try:
        yield
    finally:
        _active = before


class _Span:
    __slots__ = ("trace", "name", "begin")

    def __init__(self, trace, name, begin):
        self.trace, self.name, self.begin = trace, name, begin

    def __enter__(self):
        self.trace.stamp(self.name, OPEN, self.begin)

    def __exit__(self, *exc):
        self.trace.stamp(self.name, CLOSE)
        return False


def span(name: str, begin: bool = False):
    """A context manager marking stage ``name`` of the step: under
    :func:`tracing`, an open and a close event (stamps under a capture);
    otherwise nothing. ``begin`` marks the step itself (the replay index
    advances)."""
    if _active is None:
        return _NULL
    return _Span(_active, name, begin)


def tick(name: str) -> None:
    """The end of one iteration of loop ``name`` (under :func:`tracing`)."""
    if _active is not None:
        _active.stamp(name, TICK)


def count(name: str, value: torch.Tensor) -> None:
    """Add ``value`` to the active trace's counter ``name``."""
    if _active is not None:
        _active.count(name, value)


def tracing_on() -> bool:
    """Whether step code runs inside :func:`tracing` of a trace."""
    return _active is not None


@contextlib.contextmanager
def _host_span(trace, name: str):
    trace.host_event(name, OPEN)
    try:
        if _profiling():
            with torch.profiler.record_function(name):
                yield
        else:
            yield
    finally:
        trace.host_event(name, CLOSE)


def host_span(name: str, trace):
    """A context manager marking host work ``name`` (``sph.*``) of a traced
    simulation: with a :class:`Trace`, an open and a close event on the
    host's clock, and while a ``torch.profiler`` session is on, also a
    ``record_function`` range of that name on the profiler's timeline;
    with ``trace`` None, nothing."""
    if trace is None:
        return _NULL
    return _host_span(trace, name)

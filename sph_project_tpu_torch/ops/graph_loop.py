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

import contextlib
import ctypes
import functools
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
    replays ran with the launches of one iteration."""

    def __init__(self):
        self.outer: List[dict] = []
        self.loops: List[Tuple[torch.Tensor, List[dict]]] = []
        self.counters = None
        self.body_pool = None
        self.in_body = False

    def replayed(self) -> None:
        """Count one replay (no host read)."""
        _add(self.outer, 1)
        if self.loops and not any(r is self for r in _pending):
            _pending.append(self)


def flush_launches() -> None:
    """Add the loop iterations of every replay so far to the launch counts
    (reads the device counts: one synchronisation), and zero the device
    counts."""
    for rec in _pending:
        counts = rec.counters[:len(rec.loops)].tolist()
        for (_, delta), n in zip(rec.loops, counts):
            _add(delta, n)
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
    for fn in (lib.sph_while_begin, lib.sph_while_cond, lib.sph_while_end):
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


def capture(fn: Callable, device=None):
    """Capture ``fn()`` into a CUDA graph on ``device`` (a card; raises
    without one). Returns (graph, :class:`Captured`, what ``fn`` returned).
    Nothing runs: ``graph.replay()`` then ``Captured.replayed()`` run it."""
    if not torch.cuda.is_available():
        raise RuntimeError("graph_loop.capture: CUDA is not available")
    device = torch.device("cuda" if device is None else device)
    if device.type != "cuda":
        raise ValueError(f"graph_loop.capture: {device} is not a card")
    rec = Captured()
    rec.counters = torch.zeros(MAX_LOOPS, dtype=torch.int64, device=device)
    rec.body_pool = torch.cuda.MemPool()
    graph = torch.cuda.CUDAGraph()
    snap = _snapshot()
    _stack.append(rec)
    try:
        with torch.cuda.device(device), torch.cuda.graph(graph):
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


def while_loop(cond: Callable, body: Callable, carry: Sequence[torch.Tensor]):
    """``jax.lax.while_loop(cond, body, carry)`` over a tuple of tensors (see
    the module docstring): a host loop, or a WHILE node under a capture."""
    carry = tuple(carry)
    if capturing(carry[0]):
        return _graph_while(cond, body, carry)
    ran = False
    while bool(_flag(cond(carry))):
        carry = tuple(body(carry))
        ran = True
    if _warming and not ran:
        body(carry)
    return carry


def _graph_while(cond: Callable, body: Callable, carry: tuple) -> tuple:
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
    finally:
        rec.in_body = False
        _check(lib.sph_while_end(side.cuda_stream), "ending the body capture")
    rec.loops.append((count, _delta(snap)))
    _restore(snap)
    return buf

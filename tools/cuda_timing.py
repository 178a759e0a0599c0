"""How the port's chip measurements time a call and bound it.

``chip_smoke.py`` and ``tools/bench_gather.py`` both use these, so a time
means the same thing in both:

- :func:`cuda_ms`: the mean time per call of back-to-back calls between two
  CUDA events. The host enqueues each call while the card runs the one
  before, so a call that takes longer on the host than on the card is timed
  at its host time.
- :func:`led_ms`: the same calls behind a sleep on the stream, long enough
  that the host has enqueued every call before the first one runs: the
  device time alone, and beside it the host's microseconds per call.
- :func:`bound_ms`: the least time the card could take for some bytes and
  operations: the bytes over the memory rate or the operations over the
  float32 rate (float64's for float64 work), whichever is longer.

Import it with the ``tools`` directory on ``sys.path``.
"""
from __future__ import annotations

import time

import torch

# published H100 SXM peaks: HBM bytes/s, and float32 and float64 FLOP/s
# outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
FP64_OPS_PER_S = 34e12
# the head start of led_ms' calls: ~100 ms at the H100's clock, four times
# the longest enqueue seen (50 calls of 0.46 ms on a loaded host)
LEAD_CYCLES = 200_000_000
# led_ms refuses a run whose calls took this long to enqueue: the sleep may
# have ended before the host was done
LEAD_HOST_MS = 80.0


def cuda_ms(fn, reps: int, warm_up: bool = True) -> float:
    """Mean time of ``fn`` over ``reps`` back-to-back calls (after one
    warm-up unless the caller has made it), from CUDA events."""
    if warm_up:
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


def led_ms(fn, reps: int) -> tuple[float, float]:
    """(mean device ms, host µs per call) of ``fn`` over ``reps`` calls
    after one warm-up: a sleep on the stream ahead of the first event holds
    the card while the host enqueues every call."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(LEAD_CYCLES)
    a.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host_s = time.perf_counter() - t0
    b.record()
    b.synchronize()
    if host_s * 1e3 > LEAD_HOST_MS:
        raise RuntimeError(f"led_ms: {reps} calls took {host_s * 1e3:.1f} ms "
                           f"to enqueue, past the sleep's head start")
    return a.elapsed_time(b) / reps, host_s / reps * 1e6


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound_ms(n_bytes: float, n_ops: float,
             ops_per_s: float = FP32_OPS_PER_S):
    """(least ms, "bytes" or "operations"): what bounds the work, its
    operations at ``ops_per_s``."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

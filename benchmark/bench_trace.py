"""Device time from ``torch.profiler``: kernel intervals, families, gaps.

The method of ``tools/profile_torch_step.py``: busy time is the union of the
intervals in which an operation ran on the device; the idle share is 1 -
busy / wall of the same steps replayed without the profiler. A short
profiler session before the step is captured (:func:`attach_profiler`)
lets the trace of a replay hold every iteration of a WHILE node. The
benchmark's own spans (``bench.*``, around its calls into the program) name
what the host was doing in each idle gap.
"""
from __future__ import annotations

import json
import re

import torch


def attach_profiler() -> None:
    """One short profiler session, before any step is captured."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


def union_ns(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


class Families:
    """Kernel name to family, from ``families.json``: the first pattern
    that matches; a pair kernel's family names its body, and ``+rigid``
    where the name is of the instance with the dynamic-rigid outputs
    (``rigid_pattern``: its flag, the first template argument, is
    ``true``)."""

    def __init__(self, path: str):
        with open(path) as f:
            spec = json.load(f)
        self.rules = [(re.compile(r["match"], re.I), r["family"])
                      for r in spec["families"]]
        self.body_re = re.compile(spec["body_pattern"])
        self.rigid_re = re.compile(spec["rigid_pattern"])
        self.bodies = spec["bodies"]
        self._memo: dict = {}

    def body(self, name: str):
        """The pair body a kernel runs, or None."""
        m = self.body_re.search(name)
        body = self.bodies.get(m.group(1)) if m else None
        if body and self.rigid_re.search(name):
            body += "+rigid"
        return body

    def __call__(self, name: str) -> str:
        fam = self._memo.get(name)
        if fam is None:
            fam = "other"
            for rx, f in self.rules:
                if rx.search(name):
                    fam = f
                    break
            if fam == "pair":
                fam = f"pair:{self.body(name) or '?'}"
            self._memo[name] = fam
        return fam


def device_events(prof) -> tuple[list, list]:
    """(device operations, the benchmark's host spans) of a profiler
    session, each as (name, start ns, end ns)."""
    dev, spans = [], []
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        end = start + e.duration_ns()
        if e.name().startswith("bench."):
            # the profiler mirrors a span on the device's timeline too
            if e.device_type() != cuda:
                spans.append((e.name(), start, end))
        elif e.device_type() == cuda:
            dev.append((e.name(), start, end))
    return dev, spans


def idle_gaps(dev: list, spans: list, lo: int, hi: int) -> list:
    """The intervals in [lo, hi] in which no device operation ran, each as
    (host span it began in, seconds), longest first."""
    gaps, end = [], lo
    for _, s, e in sorted(dev, key=lambda x: x[1]):
        if s > end:
            gaps.append((end, s))
        end = max(end, e)
    if hi > end:
        gaps.append((end, hi))
    starts = sorted(spans, key=lambda x: x[1])
    out = []
    for a, b in gaps:
        label = "host"
        for name, s, e in starts:
            if s <= a < e:
                label = name
            elif s > a:
                break
        out.append((label, (b - a) / 1e9))
    out.sort(key=lambda x: -x[1])
    return out

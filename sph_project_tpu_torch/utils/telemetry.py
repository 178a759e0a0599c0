"""Run telemetry: step timing, JSONL logging, and the export of spans.

The JAX package's ``utils/telemetry.py`` ``StepTelemetry`` with the same
entry keys, JSONL lines and printed line. The port's diagnostics are 0-dim
tensors on the simulation's device, so :meth:`StepTelemetry.record` reads
them with one device-to-host copy per step (one stack, one ``tolist``), not
one synchronising ``float()`` per key. Keys are written in sorted order, the
order of the dict the JAX package's jitted step returns. A traced run's
lines also carry the device time of each stage of their step
(:func:`stage_ms`), and :func:`write_chrome_trace` writes its spans, host
and device on the host's clock, as a Chrome trace.
"""
from __future__ import annotations

import json
import time
from typing import IO, Optional

import torch

from ..ops import graph_loop


def host_values(diag: dict, trace=None) -> dict:
    """``{key: float}`` of a step's diagnostics, keys sorted, in one copy
    from the device (the host span ``sph.read`` of ``trace``, a
    ``graph_loop.Trace``). Every value is exact: float32 and int32 widen to
    float64 without rounding."""
    with graph_loop.host_span("sph.read", trace):
        keys = sorted(diag)
        tensors = [v for v in diag.values() if isinstance(v, torch.Tensor)]
        device = tensors[0].device if tensors else None
        vals = torch.stack([torch.as_tensor(diag[k], device=device)
                            .to(torch.float64).reshape(()) for k in keys])
        return dict(zip(keys, vals.tolist()))


def stage_ms(spans: dict) -> dict:
    """``{replay: {stage: ms}}`` of a ``Trace.read``: per step, the time
    inside each span of the step (the device's where it has one, else the
    host's), summed over the span's occurrences; host spans (``sph.*``)
    are left out."""
    out: dict = {}
    for s in spans.get("spans", ()):
        if s.name.startswith("sph."):
            continue
        row = out.setdefault(s.replay, {})
        row[s.name] = row.get(s.name, 0.0) + (s.end - s.start) / 1e6
    return out


def write_chrome_trace(path: str, reads: list) -> None:
    """The spans of ``reads`` (``Trace.read`` dicts) as a Chrome trace
    (``chrome://tracing``, Perfetto): one track for the host, one for the
    device, times in µs on the host's clock; loop ticks as instant events;
    each read's counters and clock offset as metadata."""
    events = [{"ph": "M", "name": "thread_name", "pid": 0, "tid": tid,
               "args": {"name": where}}
              for tid, where in enumerate(("host", "device"))]
    other = []
    for r in reads:
        for s in r.get("spans", ()):
            events.append({"ph": "X", "name": s.name, "pid": 0,
                           "tid": int(s.where == "device"),
                           "ts": s.start / 1e3, "dur": (s.end - s.start) / 1e3,
                           "args": {"replay": s.replay}})
        other.append({k: r.get(k) for k in ("counters", "dropped",
                                            "offset_ns",
                                            "offset_uncertainty_ns",
                                            "timer_step_ns")})
        for (name, replay), n in r.get("ticks", {}).items():
            other[-1].setdefault("ticks", []).append([name, replay, n])
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms",
                   "otherData": {"reads": other}}, f)


class StepTelemetry:
    def __init__(self, log_file: Optional[str] = None, print_every: int = 0,
                 trace=None):
        self._t_last = time.perf_counter()
        self._t0 = self._t_last
        self.steps = 0
        self.print_every = print_every
        self.trace = trace
        self._fh: Optional[IO] = open(log_file, "w") if log_file else None
        self.max_overflow = None

    def record(self, diag: dict, step_index: int, n_particles: int,
               stages: Optional[dict] = None) -> None:
        """Log one step; ``stages`` (``{stage: ms}``, of a traced step) is
        written with its line."""
        entry = host_values(diag, self.trace)
        now = time.perf_counter()
        entry["step"] = step_index
        entry["wall_ms"] = (now - self._t_last) * 1000.0
        if stages is not None:
            entry["stage_ms"] = stages
        self._t_last = now
        self.steps += 1
        ov = entry.get("neighbor_overflow", 0)
        self.max_overflow = ov if self.max_overflow is None else \
            max(self.max_overflow, ov)
        if self._fh:
            self._fh.write(json.dumps(entry) + "\n")
        if self.print_every and step_index % self.print_every == 0:
            it = entry.get("solver_iters")
            err = entry.get("solver_err")
            msg = (f"step {step_index}: {entry['wall_ms']:.0f} ms, "
                   f"rho_max {entry.get('density_max', 0):.0f}, "
                   f"overflow {entry.get('neighbor_overflow', 0):.0f}")
            if it is not None:
                msg += f", iters {int(it)} (err {err:.4f})"
            print(msg, flush=True)

    def summary(self, n_particles: int) -> dict:
        elapsed = time.perf_counter() - self._t0
        sps = self.steps / max(elapsed, 1e-9)
        out = dict(steps=self.steps, elapsed_s=round(elapsed, 2),
                   steps_per_s=round(sps, 2),
                   particle_steps_per_s=round(sps * n_particles, 1))
        if self.max_overflow is not None:
            out["max_neighbor_overflow"] = self.max_overflow
        return out

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

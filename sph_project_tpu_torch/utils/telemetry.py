"""Run telemetry: step timing, solver-convergence history, JSONL logging.

The JAX package's ``utils/telemetry.py`` ``StepTelemetry`` with the same
entry keys, JSONL lines and printed line. The port's diagnostics are 0-dim
tensors on the simulation's device, so :meth:`StepTelemetry.record` reads
them with one device-to-host copy per step (one stack, one ``tolist``), not
one synchronising ``float()`` per key. Keys are written in sorted order, the
order of the dict the JAX package's jitted step returns.
"""
from __future__ import annotations

import json
import time
from typing import IO, Optional

import torch


def host_values(diag: dict) -> dict:
    """``{key: float}`` of a step's diagnostics, keys sorted, in one copy
    from the device. Every value is exact: float32 and int32 widen to
    float64 without rounding."""
    keys = sorted(diag)
    tensors = [v for v in diag.values() if isinstance(v, torch.Tensor)]
    device = tensors[0].device if tensors else None
    vals = torch.stack([torch.as_tensor(diag[k], device=device)
                        .to(torch.float64).reshape(()) for k in keys])
    return dict(zip(keys, vals.tolist()))


class StepTelemetry:
    def __init__(self, log_file: Optional[str] = None, print_every: int = 0):
        self._t_last = time.perf_counter()
        self._t0 = self._t_last
        self.steps = 0
        self.print_every = print_every
        self._fh: Optional[IO] = open(log_file, "w") if log_file else None
        self.history: list[dict] = []

    def record(self, diag: dict, step_index: int, n_particles: int) -> None:
        entry = host_values(diag)
        now = time.perf_counter()
        entry["step"] = step_index
        entry["wall_ms"] = (now - self._t_last) * 1000.0
        self._t_last = now
        self.steps += 1
        self.history.append(entry)
        if len(self.history) > 10000:
            del self.history[: len(self.history) // 2]
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
        if self.history:
            ov = max(h.get("neighbor_overflow", 0) for h in self.history)
            out["max_neighbor_overflow"] = ov
        return out

    def close(self) -> None:
        if self._fh:
            self._fh.close()
            self._fh = None

#!/usr/bin/env python3
"""Where a step of the PyTorch port spends its time on the GPU.

Loads a scene (default: the flagship ``large_scale_dfsph.json`` at full size),
prepares it on the card (``Simulation``, which captures the step into a CUDA
graph) and runs ``WARMUP`` steps. Then, from that state, it runs ``STEPS``
steps eagerly (``get_step_fn`` called directly: every kernel launched from
Python, every solver loop reading its flag on the host) and ``STEPS``
replays of the captured step, each twice: first without the profiler, for
the wall time, then again under ``torch.profiler``, for the device busy time
(the union of kernel intervals) and the kernels a step. The idle share is 1
- busy / wall of the unprofiled run; the profiled run's own wall time is
printed beside it. Also prints the solver iterations (all four runs must
agree), the capture's and the warm-up step's host time, and device time
grouped by kernel family (the pair kernels by body) and by kernel name. On a scene with dynamic rigid bodies it then times the rigid
stage of a step alone (``Plumbing.rigid_mid``: the contact pass, the body
step, the particles placed at the new poses) from the same state, ``STEPS``
times, and lists its kernels. Ends with one JSON line of the same numbers.

    python3 tools/profile_torch_step.py [--scene FILE]
        [--method dfsph|wcsph|pcisph|iisph|pbf]
        [--pair-backend auto|pallas_dma|pallas] [--warm] [--resume CKPT]

``--method`` overrides the scene's simulation method, ``--pair-backend
pallas`` profiles the slab-window pair engine instead of the cell-list
engine, ``--warm`` turns both DFSPH warm starts on (``--scene
data/scenes/pbf_3d.json`` profiles a PBF step: the pair kernels by body, one
non-pressure pass and five of each PBF pass), ``--resume`` starts from
a checkpoint of the scene (``run_simulation_torch.py --checkpoint_interval``;
``chip_smoke.py`` leaves the settled flagship in
``build/smoke/flagship/ckpt`` and ``dragon_bath`` after the fluid's arrival
in ``build/smoke/dragon_bath/ckpt``) instead of its initial state. With
implicit viscosity the iteration counts end with the CG's.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

FAMILIES = (("pair_kernel", "pair pass (csrc/pair_pass.cu)"),
            ("slab_kernel", "pair pass, slab-window (csrc/pair_slab.cu)"),
            ("permute_kernel", "permute (csrc/permute.cu)"),
            ("sort", "torch.sort"), ("radix", "torch.sort"),
            ("searchsorted", "cell table (searchsorted)"))
WARMUP = 3
STEPS = 5


def family(name: str) -> str:
    low = name.lower()
    for key, fam in FAMILIES:
        if key in low:
            if key in ("pair_kernel", "slab_kernel"):
                # the body is the kernel's template argument
                body = name.split("<", 1)[1].split("<")[0].split(">")[0] \
                    if "<" in name else "?"
                return f"{fam}: {body}"
            return fam
    return "other PyTorch kernels"


def kernel_table(prof, steps: int):
    """(kernels, busy us, {name: (count, us)}, {family: [count, us]}) of the
    CUDA kernels a profiler saw."""
    kernels = [e for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    busy_us = union_us([(e.time_range.start, e.time_range.end)
                        for e in kernels])
    by_name: dict = {}
    for e in kernels:
        n, t = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, t + e.time_range.elapsed_us())
    by_family: dict = {}
    for name, (n, t) in by_name.items():
        f = by_family.setdefault(family(name), [0, 0.0])
        f[0] += n
        f[1] += t
    return kernels, busy_us, by_name, by_family


def print_table(title: str, table: dict, steps: int, top: int) -> None:
    print(title)
    for name, (n, t) in sorted(table.items(), key=lambda x: -x[1][1])[:top]:
        print(f"  {t / steps / 1e3:8.3f} ms  {n / steps:6.1f}x  {name[:100]}")


def union_us(intervals) -> float:
    total, end = 0.0, float("-inf")
    for s, e in sorted(intervals):
        if s > end:
            total += e - s
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def attach_profiler() -> None:
    """One short profiler session, to run before any step is captured. On
    the H100 (torch 2.11, CUDA 12.8 runtime), where this tool's first
    session came after the capture, the trace of a replay of the settled
    flagship held 361 kernels a step, each WHILE node's body once, against
    1,031 in ``chip_smoke.py`` phase 11, whose sessions began before its
    captures."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]):
        torch.ones(1, device="cuda").add_(1)
        torch.cuda.synchronize()


class Stepper:
    """A step to call, one a call, and the way back to its start."""

    def __init__(self, step, reset):
        self.step, self.reset = step, reset

    def __call__(self) -> dict:
        return self.step()


def eager_step(params, start) -> Stepper:
    """The eager step (``get_step_fn`` called directly), from a copy of
    ``start``."""
    from sph_project_tpu_torch import sim as simlib
    fn = simlib.get_step_fn(params)
    box = {}

    def reset():
        box["state"] = simlib._cloned(start)

    def step():
        box["state"], d = fn(box["state"])
        return d

    return Stepper(step, reset)


def graphed_step(sim, start) -> Stepper:
    """A replay of ``sim``'s captured step (``Simulation.step``), from
    ``start``."""
    def reset():
        sim.state = start

    return Stepper(sim.step, reset)


def measure(step, steps: int, implicit: bool) -> dict:
    """``steps`` calls of ``step`` from its start, timed by the host's clock
    each ending in a synchronise (wall), then again from the start under
    ``torch.profiler`` (device busy: the union of kernel intervals; the
    idle share is 1 - busy / wall). The iterations of each step (and the
    CG's) must agree between the two runs."""
    from torch.profiler import ProfilerActivity, profile

    from sph_project_tpu_torch.solvers import viscosity_cg

    def timed():
        step.reset()
        torch.cuda.synchronize()
        iters, ms = [], []
        for _ in range(steps):
            t0 = time.perf_counter()
            d = step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            iters.append(tuple(int(d[k]) for k in ("solver_iters",
                                                   "div_iters") if k in d)
                         + ((int(viscosity_cg.last_solve["cg_iters"]),)
                            if implicit else ()))
        return ms, iters

    wall_ms, iters = timed()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_ms, prof_iters = timed()
    if prof_iters != iters:
        raise RuntimeError(f"profile_torch_step: the profiled steps iterated "
                           f"differently ({prof_iters} vs {iters})")
    kernels, busy_us, by_name, by_family = kernel_table(prof, steps)
    wall_us = sum(wall_ms) * 1e3
    return dict(wall_ms=wall_ms, profiled_ms=prof_ms, iters=iters,
                wall_ms_per_step=wall_us / steps / 1e3,
                profiled_wall_ms_per_step=sum(prof_ms) / steps,
                busy_ms_per_step=busy_us / steps / 1e3,
                idle_share=1 - busy_us / wall_us,
                kernels_per_step=len(kernels) / steps,
                by_name=by_name, by_family=by_family)


def summary(r: dict, steps: int) -> dict:
    """The JSON numbers of a :func:`measure` result."""
    return {**{k: r[k] for k in ("iters", "wall_ms_per_step",
                                 "profiled_wall_ms_per_step",
                                 "busy_ms_per_step", "idle_share",
                                 "kernels_per_step")},
            "family_ms_per_step": {k: v[1] / steps / 1e3
                                   for k, v in r["by_family"].items()},
            "family_launches_per_step": {k: v[0] / steps
                                         for k, v in r["by_family"].items()}}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--scene", default=os.path.join(
        ROOT, "data", "scenes", "large_scale_dfsph.json"))
    ap.add_argument("--method", default=None,
                    choices=("dfsph", "wcsph", "pcisph", "iisph", "pbf"))
    ap.add_argument("--pair-backend", default="auto",
                    choices=("auto", "pallas_dma", "pallas"))
    ap.add_argument("--warm", action="store_true")
    ap.add_argument("--resume", default=None, metavar="CKPT")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_torch_step: no CUDA device", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from sph_project_tpu_torch import sim as simlib
    from sph_project_tpu_torch.io import checkpoint
    from sph_project_tpu_torch.scene import load_scene
    from sph_project_tpu_torch.sim import Plumbing, Simulation

    card = subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    overrides = {} if args.method is None else dict(
        simulation_method=args.method)
    scene, state = load_scene(args.scene, **overrides,
                              pair_backend=args.pair_backend,
                              dfsph_warm_start=args.warm,
                              dfsph_warm_start_div=args.warm)
    attach_profiler()
    sim = Simulation(scene, state)
    if args.resume:
        sim.state = checkpoint.restore(args.resume, sim.state, sim.params)
    for _ in range(WARMUP):
        sim.step()
    torch.cuda.synchronize()
    start = simlib._cloned(sim.state)
    implicit = scene.params.viscosity_method == "implicit"
    runs = {}
    for mode in ("eager", "graphed"):
        step = eager_step(sim.params, start) if mode == "eager" else \
            graphed_step(sim, start)
        runs[mode] = r = measure(step, STEPS, implicit)
        if r["iters"] != runs["eager"]["iters"]:
            print(f"profile_torch_step: the {mode} steps iterated "
                  f"differently ({r['iters']} vs {runs['eager']['iters']})",
                  file=sys.stderr)
            return 1
    steps = STEPS
    params = scene.params
    print(f"card: {card}; scene {os.path.basename(args.scene)}, method "
          f"{params.simulation_method}, {params.n_particles} particles, "
          f"pair_backend {args.pair_backend}, warm start {args.warm}; from "
          f"{args.resume or 'the initial state'} (step "
          f"{int(start.step_count)}); {steps} steps profiled, eager "
          f"(get_step_fn called directly) and graphed (Simulation.step, a "
          f"replay; capture {sim.capture_ms:.1f} ms, warm-up step "
          f"{sim.warmup_ms:.1f} ms)")
    for mode, r in runs.items():
        print(f"{mode} per step: wall {r['wall_ms_per_step']:.3f} ms (under "
              f"the profiler {r['profiled_wall_ms_per_step']:.3f} ms), device "
              f"busy {r['busy_ms_per_step']:.3f} ms, idle share "
              f"{r['idle_share']:.3f}; kernels per step "
              f"{r['kernels_per_step']:.1f}; solver iterations (pressure, "
              f"divergence{', CG' if implicit else ''}) {r['iters']}")
        print(f"{mode} per-step wall ms without the profiler {r['wall_ms']}, "
              f"under it {r['profiled_ms']}")
        print_table(f"{mode}: device time per step by family (x: launches):",
                    r["by_family"], steps, 40)
        print_table(f"{mode}: top kernels by device time per step:",
                    r["by_name"], steps, 15)
    rigid = {}
    if params.has_dynamic_rigid:
        # the rigid stage alone, from the state after the replays; its env
        # is the one that state's last sort built
        st, env = sim.state, sim.state.cached_neighbors
        for _ in range(2):
            Plumbing.rigid_mid(st, env, params)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(STEPS):
            Plumbing.rigid_mid(st, env, params)
        torch.cuda.synchronize()
        rigid_wall_us = (time.perf_counter() - t0) * 1e6
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof_r:
            for _ in range(STEPS):
                Plumbing.rigid_mid(st, env, params)
            torch.cuda.synchronize()
        kr, busy_r, by_name_r, _ = kernel_table(prof_r, STEPS)
        print(f"rigid stage (Plumbing.rigid_mid) per call: wall "
              f"{rigid_wall_us / STEPS / 1e3:.3f} ms, device busy "
              f"{busy_r / STEPS / 1e3:.3f} ms, {len(kr) / STEPS:.1f} kernels")
        print_table("rigid stage kernels per call:", by_name_r, STEPS, 25)
        rigid = {"rigid_mid_wall_ms": rigid_wall_us / STEPS / 1e3,
                 "rigid_mid_busy_ms": busy_r / STEPS / 1e3,
                 "rigid_mid_kernels": len(kr) / STEPS}
    print(json.dumps({
        "card": card, "scene": os.path.basename(args.scene),
        "method": params.simulation_method,
        "pair_backend": args.pair_backend, "warm": args.warm,
        "resume": args.resume, "start_step": int(start.step_count),
        "steps": steps, "capture_ms": sim.capture_ms,
        "warmup_ms": sim.warmup_ms,
        **{mode: summary(r, steps) for mode, r in runs.items()},
        **rigid}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Where a step of the PyTorch port spends its time on the GPU.

Loads a scene (default: the flagship ``large_scale_dfsph.json`` at full size),
prepares it on the card and runs ``WARMUP`` steps. Then it runs ``STEPS`` steps
twice from the same state: first without the profiler, for the wall time,
then again under ``torch.profiler``, for the device busy time (the union of
kernel intervals). The idle share is 1 - busy / wall of the unprofiled run;
the profiled run's own wall time is printed beside it. Also prints the
solver iterations (each one reads its error on the host; both runs must
agree) and device time grouped by kernel family (the pair kernels by body) and
by kernel name. On a scene with dynamic rigid bodies it then times the rigid
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

    from sph_project_tpu_torch.io import checkpoint
    from sph_project_tpu_torch.scene import load_scene
    from sph_project_tpu_torch.sim import Plumbing, Simulation
    from sph_project_tpu_torch.solvers import viscosity_cg

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
    sim = Simulation(scene, state)
    if args.resume:
        sim.state = checkpoint.restore(args.resume, sim.state, sim.params)
    for _ in range(WARMUP):
        sim.step()
    torch.cuda.synchronize()
    start = sim.state

    implicit = scene.params.viscosity_method == "implicit"

    def timed_steps():
        """Runs STEPS steps from ``start``; (per-step wall ms, iteration
        counts, with the implicit viscosity's CG iterations last)."""
        sim.state = start
        iters, ms = [], []
        for _ in range(STEPS):
            t0 = time.perf_counter()
            d = sim.step()
            iters.append(tuple(int(d[k]) for k in ("solver_iters",
                                                   "div_iters") if k in d)
                         + ((viscosity_cg.last_solve["cg_iters"],)
                            if implicit else ()))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms, iters

    wall_ms, iters = timed_steps()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_ms, prof_iters = timed_steps()
    wall_us, prof_wall_us = sum(wall_ms) * 1e3, sum(prof_ms) * 1e3
    if prof_iters != iters:
        print(f"profile_torch_step: the replay iterated differently "
              f"({prof_iters} vs {iters})", file=sys.stderr)
        return 1
    kernels, busy_us, by_name, by_family = kernel_table(prof, STEPS)
    steps = STEPS
    params = scene.params
    print(f"card: {card}; scene {os.path.basename(args.scene)}, method "
          f"{params.simulation_method}, {params.n_particles} particles, "
          f"pair_backend {args.pair_backend}, warm start {args.warm}; from "
          f"{args.resume or 'the initial state'} (step "
          f"{int(start.step_count)}); {steps} steps profiled")
    print(f"per step: wall {wall_us / steps / 1e3:.3f} ms (under the "
          f"profiler {prof_wall_us / steps / 1e3:.3f} ms), device busy "
          f"{busy_us / steps / 1e3:.3f} ms, idle share "
          f"{1 - busy_us / wall_us:.3f}; kernels per step "
          f"{len(kernels) / steps:.1f}; solver iterations "
          f"(pressure, divergence{', CG' if implicit else ''}) {iters}")
    print(f"per-step wall ms without the profiler {wall_ms}, under it "
          f"{prof_ms}")
    print_table("device time per step by family (x: launches):", by_family,
                steps, 40)
    print_table("top kernels by device time per step:", by_name, steps, 15)
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
        "steps": steps, "iters": iters,
        "wall_ms_per_step": wall_us / steps / 1e3,
        "profiled_wall_ms_per_step": prof_wall_us / steps / 1e3,
        "busy_ms_per_step": busy_us / steps / 1e3,
        "idle_share": 1 - busy_us / wall_us,
        "family_ms_per_step": {k: v[1] / steps / 1e3
                               for k, v in by_family.items()},
        "family_launches_per_step": {k: v[0] / steps
                                     for k, v in by_family.items()},
        **rigid}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

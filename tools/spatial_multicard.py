#!/usr/bin/env python3
"""The spatial decomposition on D cards, one rank a card, held to one device.

    python3 tools/spatial_multicard.py [--ranks 4] [--steps 3]
        [--scenes large_scale_dfsph.json ...] [--device cpu]

Starts D ranks over NCCL (``parallel/launch.py``, which turns NCCL's
graph-mixing support off so that ``spatial.SpatialSimulation`` captures the
step: ``collectives.capturable``). Each rank steps each scene ``--steps``
times through the captured ``SpatialSimulation`` and, from the same start,
through the eager ``spatial_step_fn``, each step held bit-equal to it
(every state tensor and diagnostic). This process then steps each scene on
one card through ``sim.Simulation`` and holds the ranks' rows to it: the
sorted fluid positions and the bodies' com bit-equal, their velocities and
angular velocities within 1e-6 (the wrenches are all-reduced in another
order, tests/test_spatial.py:145-153), iteration and CG counts equal, no
halo shortfall on any rank. Prints a line per scene (the step's wall ms on
the slowest rank against one device's) and the card's name and power
limit; exits 1 if any check fails. The slab-window engine runs the
flagship a second time (``pair_backend="pallas"``).

``--device cpu`` runs the same on the CPU over gloo (eager; for a small
scene such as ``smoke_test.json``), to rehearse it without cards.
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = ("large_scale_dfsph.json", "dragon_bath_dfsph.json",
          "high_viscosity_implicit.json")
# the flagship a second time, through the slab-window engine
SLAB_SCENE = "large_scale_dfsph.json"
BODY_TOL = 1e-6


def sorted_fluid(pos, material):
    from sph_project_tpu_torch.core.params import MATERIAL_FLUID
    r = np.asarray(pos)[np.asarray(material) == MATERIAL_FLUID]
    return r[np.lexsort(r.T)]


def one_device(scene_file, overrides, steps, device):
    """The scene on one device: sorted fluid, bodies, diagnostics, CG
    iterations and wall ms of each step."""
    from sph_project_tpu_torch import sim as simlib
    from sph_project_tpu_torch.scene import load_scene
    from sph_project_tpu_torch.solvers import viscosity_cg
    scene, state = load_scene(scene_file, **overrides)
    sim = simlib.Simulation(scene, state, device=device)
    diags, cg, ms = [], [], []
    for _ in range(steps):
        if device == "cuda":
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        d = sim.step()
        if device == "cuda":
            torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
        diags.append({k: v.item() for k, v in d.items()})
        if scene.params.viscosity_method == "implicit":
            cg.append(int(viscosity_cg.last_solve["cg_iters"]))
    p = sim.state.particles
    return dict(fluid=sorted_fluid(p.pos.cpu(), p.material.cpu()),
                rigid={k: getattr(sim.state.rigid, k).cpu().numpy()
                       for k in ("com", "vel", "omega")},
                diags=diags, cg=cg, ms=ms)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--scenes", nargs="+", default=list(SCENES))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    from sph_project_tpu_torch.parallel import launch

    if args.device == "cuda":
        if torch.cuda.device_count() < args.ranks:
            print(f"spatial_multicard: {args.ranks} ranks need {args.ranks} "
                  f"cards, this host has {torch.cuda.device_count()}",
                  file=sys.stderr)
            return 1
        from sph_project_tpu_torch.ops import _build
        _build.build_all()
        card = subprocess.run(["nvidia-smi", "-i", "0",
                               "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True,
                              text=True, timeout=60, check=True).stdout.strip()
    else:
        torch.set_num_threads(1)
        card = "CPU (gloo), no card"
    runs = [(name, {}) for name in args.scenes]
    if SLAB_SCENE in args.scenes:
        runs.append((SLAB_SCENE, dict(pair_backend="pallas")))
    cases = [dict(name=f"case{i}",
                  scene=os.path.join(ROOT, "data", "scenes", name),
                  overrides=overrides, steps=args.steps, eager_check=True)
             for i, (name, overrides) in enumerate(runs)]
    run_dir = os.path.join(ROOT, "build", "multicard")
    shutil.rmtree(run_dir, ignore_errors=True)
    t0 = time.perf_counter()
    launch.launch("sph_project_tpu_torch.parallel.launch:run_cases",
                  args.ranks, dict(cases=cases,
                                   out_dir=os.path.join(run_dir, "out")),
                  os.path.join(run_dir, "ranks"), device=args.device,
                  timeout=1200)
    print(f"{args.ranks} ranks: {time.perf_counter() - t0:.1f} s with "
          f"start-up; {card}", flush=True)
    ok = True
    for case, (name, overrides) in zip(cases, runs):
        res = launch.gather_results(os.path.join(run_dir, "out"),
                                    case["name"], args.ranks)
        rows, ranks = res["rows"], res["ranks"]
        ref = one_device(case["scene"], overrides, args.steps, args.device)
        fails = []
        for r, rr in enumerate(ranks):
            if rr["foreign"] or rr["shortfall"] or rr["diags"] != \
                    ranks[0]["diags"]:
                fails.append(f"rank {r}: foreign {rr['foreign']}, shortfall "
                             f"{rr['shortfall']}")
            if not all(rr["eager_equal"]):
                fails.append(f"rank {r}: captured and eager steps differ "
                             f"{rr['eager_equal']}")
            if args.device == "cuda" and not rr["captured"]:
                fails.append(f"rank {r}: the step was not captured")
        fluid = sorted_fluid(rows["particles.pos"],
                             rows["particles.material"])
        if fluid.shape != ref["fluid"].shape or \
                not np.array_equal(fluid, ref["fluid"]):
            fails.append("fluid positions differ from one device's")
        for s, (a, b) in enumerate(zip(ref["diags"], ranks[0]["diags"])):
            its = [k for k in ("solver_iters", "div_iters")
                   if a.get(k) != b.get(k)]
            if its or b["neighbor_overflow"]:
                fails.append(f"step {s}: {its} differ, overflow "
                             f"{b['neighbor_overflow']}")
        if ranks[0]["cg_iters"] != ref["cg"]:
            fails.append(f"CG {ranks[0]['cg_iters']}, one device {ref['cg']}")
        if not np.array_equal(rows["rigid.com"], ref["rigid"]["com"]):
            fails.append("body com differs")
        dv = max(float(np.abs(rows[f"rigid.{k}"] - ref["rigid"][k]).max())
                 for k in ("vel", "omega"))
        if dv > BODY_TOL:
            fails.append(f"body vel / omega off by {dv}")
        ms = [max(rr["ms"][s] for rr in ranks) for s in range(args.steps)]
        print(f"{name} {json.dumps(overrides)}: {args.ranks} ranks over "
              f"{ranks[0]['backend']}, captured "
              f"{[rr['captured'] for rr in ranks]}, "
              f"{'held' if not fails else 'FAILED: ' + '; '.join(fails)} "
              f"(iterations "
              f"{[(d.get('solver_iters'), d.get('div_iters')) for d in ranks[0]['diags']]}"
              f", CG {ranks[0]['cg_iters']}, body vel / omega within "
              f"{dv:.1e}, H per rank {[rr['H'] for rr in ranks]}); wall ms "
              f"(slowest rank) {[round(x, 3) for x in ms]}, one device "
              f"{[round(x, 3) for x in ref['ms']]}", flush=True)
        ok = ok and not fails
    print(card, flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

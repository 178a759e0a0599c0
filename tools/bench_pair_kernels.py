#!/usr/bin/env python3
"""Time the pair bodies of both CUDA pair kernels on the flagship's shapes.

Loads the flagship ``large_scale_dfsph.json`` at full size, prepares it on the
card through the slab-window engine (whose environment also serves the
cell-list kernel), runs ``STEPS`` warm-started steps, and then times each
body of each engine on that state with CUDA events, back to back (the fields
stay partly in L2, as they do between the passes of a step): every body
without its dynamic-rigid outputs (the flagship has no dynamic body), but
the contact pass, which needs one. The stiffness, the pressure, the predicted
positions, d_ii, sum d_ij p_j and the CG vector of the implicit viscosity's
matvec come from a numpy seed. One JSON line per
engine, and a check that the two engines are bit-equal.

Then the bodies of a PBF step (``nonpressure`` and the three PBF bodies,
under poly6), where the package has them: on ``pbf_3d.json`` at full size
and on ``pbf_2d.json`` (the 2D walk), each after ``STEPS`` steps, at the
moved positions of the first iteration of the next step over its sort's
environment, as the step runs them; one JSON line per scene and engine.

    python3 tools/bench_pair_kernels.py [--label TEXT] [--root DIR]

``--root`` times the package of another checkout (for example the parent
commit unpacked under ``build/``) on the same scene file, so two designs can
be timed one after the other on one card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2
REPS = 20


def cuda_ms(fn, reps: int = REPS) -> float:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_pair_kernels: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from sph_project_tpu_torch.core.params import MATERIAL_FLUID, MATERIAL_RIGID
    from sph_project_tpu_torch.ops import pair_kernels as pk
    from sph_project_tpu_torch.ops import pairs
    from sph_project_tpu_torch.scene import load_scene
    from sph_project_tpu_torch.sim import Simulation
    from sph_project_tpu_torch.solvers import common

    card = subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    scene, state = load_scene(
        os.path.join(ROOT, "data", "scenes", "large_scale_dfsph.json"),
        pair_backend="pallas", dfsph_warm_start=True,
        dfsph_warm_start_div=True)
    sim = Simulation(scene, state)
    for _ in range(STEPS):
        sim.step()
    torch.cuda.synchronize()
    params, p = sim.params, sim.state.particles
    slab_env = sim.state.cached_neighbors
    cell_env = pairs.make_pair_env(slab_env.cells, slab_env.produce, params)
    n = params.n_pad
    rng = np.random.default_rng(0)

    def seeded(x):
        return torch.from_numpy(x.astype(np.float32)).cuda()

    kappa = seeded(rng.uniform(-50.0, 200.0, n))
    pressure = seeded(rng.uniform(0.0, 5000.0, n))
    rho2 = torch.clamp_min(p.density * p.density, 1e-12)
    fluid = (p.material == MATERIAL_FLUID)[:, None]
    fields = {"pos": p.pos, "vel": p.vel, "material": p.material,
              "mass": p.mass, "rest_volume": p.rest_volume,
              "inv_rho": common._inv_rho(p), "object_id": p.object_id,
              "kappa": kappa,
              "k_rho": kappa / torch.clamp_min(p.density, 1e-12),
              "pressure": pressure, "density": p.density,
              "p_rho2": pressure / rho2,
              "dpi": params.density0 * p.rest_volume / rho2,
              "inv_star2": 1.0 / rho2,
              "pred": torch.where(fluid, p.pos + seeded(rng.normal(
                  0.0, 0.1 * params.particle_radius, (n, 3))), p.pos),
              "dii": seeded(rng.normal(0.0, 1e-2, (n, 3))),
              "dij_pj": seeded(rng.normal(0.0, 10.0, (n, 3))),
              "x": torch.where(fluid, p.vel + seeded(rng.normal(
                  0.0, 0.1, (n, 3))), torch.zeros_like(p.vel))}
    rigid_rows = p.material == MATERIAL_RIGID

    def run(name, env):
        return pk.run_cuda(
            name, env, {k: fields[k] for k in pk.BODIES[name][3]}, params,
            rigid_rows if name == "rigid_volume" else None,
            1 if name == "divergence" else 0)

    # every body but the contact pass (its channel table needs a dynamic body)
    # and PBF's, timed on PBF's scenes below
    bodies = [name for name in pk.BODIES
              if set(pk.BODIES[name][3]) <= set(fields)
              and not name.startswith("pbf_")]
    outs = {}
    for engine, env in (("pair_pass", cell_env), ("pair_slab", slab_env)):
        ms = {}
        for name in bodies:
            outs[engine, name] = run(name, env)
            ms[name] = round(cuda_ms(lambda: run(name, env)), 4)
        print(json.dumps({"card": card, "label": args.label, "engine": engine,
                          "ms": ms, "sum_ms": round(sum(ms.values()), 4)}),
              flush=True)
    diff = max(float((outs["pair_pass", name][c]
                      - outs["pair_slab", name][c]).abs().max())
               for name in bodies for c in outs["pair_pass", name])
    print(json.dumps({"label": args.label,
                      "engines_largest_difference": diff}), flush=True)
    del sim, fields, outs, slab_env, cell_env
    torch.cuda.empty_cache()
    if "pbf_density" in pk.BODIES:
        for scene_name in ("pbf_3d.json", "pbf_2d.json"):
            bench_pbf(scene_name, card, args.label)
    return 0


PBF_BODIES = ("nonpressure", "pbf_density", "pbf_lambda", "pbf_fix")


def bench_pbf(scene_name: str, card: str, label: str) -> None:
    """The bodies of a PBF step on one scene, both engines (one JSON line
    each), and a check that the engines are bit-equal."""
    from sph_project_tpu_torch.core.params import MATERIAL_FLUID
    from sph_project_tpu_torch.ops import pair_kernels as pk
    from sph_project_tpu_torch.ops import pairs
    from sph_project_tpu_torch.scene import load_scene
    from sph_project_tpu_torch.sim import Plumbing, Simulation
    from sph_project_tpu_torch.solvers import common, pbf

    scene, state = load_scene(os.path.join(ROOT, "data", "scenes",
                                            scene_name))
    sim = Simulation(scene, state)
    for _ in range(STEPS):
        sim.step()
    params = sim.params
    st, env = Plumbing.neighbor_prep(sim.state, params)
    p, rigid = Plumbing.non_pressure_acceleration(st.particles, st.rigid,
                                                  env, st, params)
    p = common.update_fluid_velocity(p, params)
    p = common.update_fluid_position(p, rigid, params)
    p = common.enforce_domain_boundary(p, params, MATERIAL_FLUID)
    fluid = p.material == MATERIAL_FLUID
    dens = pbf.compute_density_moving(p, env, params, fluid)
    lam = pbf.compute_lambda(p, dens, env, params, fluid)
    fields = {"pos": p.pos, "vel": p.vel, "material": p.material,
              "mass": p.mass, "rest_volume": p.rest_volume,
              "inv_rho": common._inv_rho(p), "density": dens, "lam": lam}
    outs = {}
    for engine, make in (("pair_pass", pairs.make_pair_env),
                         ("pair_slab", pairs.make_slab_env)):
        e = make(env.cells, env.produce, params)
        ms = {}
        for name in PBF_BODIES:
            fk = {k: fields[k] for k in pk.fields_of(name)}

            def run(name=name, fk=fk):
                return pk.run_cuda(name, e, fk, params, fluid)

            outs[engine, name] = run()
            ms[name] = round(cuda_ms(run), 4)
        # one non-pressure pass and pbf_iters of each PBF pass per step
        step_ms = ms["nonpressure"] + params.pbf_iters * sum(
            ms[name] for name in PBF_BODIES[1:])
        print(json.dumps({"card": card, "label": label, "scene": scene_name,
                          "engine": engine, "kind": params.kernel_type,
                          "dim": params.dim, "ms": ms,
                          "pair_ms_per_step": round(step_ms, 4)}),
              flush=True)
    diff = max(float((outs["pair_pass", name][c]
                      - outs["pair_slab", name][c]).abs().max())
               for name in PBF_BODIES for c in outs["pair_pass", name])
    print(json.dumps({"label": label, "scene": scene_name,
                      "engines_largest_difference": diff}), flush=True)



if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""The flagship's settling, both packages, on the CPU at a small size.

``large_scale_dfsph.json``'s constants (DFSPH cold, dt 0.6 ms, viscosity 10,
the domain box, a block falling at 0.5 m/s) on a 0.16 x 0.6 x 0.12 m column
in a 0.5 x 1.0 x 0.3 m box (1,440 fluid particles), through the JAX
package and the port's plain versions: density_avg, density_max, the
iteration counts and vel_max every ``--every`` steps, side by side. The
column hits the floor and compacts from the entry lattice's 0.8 rho0
toward the kernel's packing; the two packages should track each other
through it. The JAX package's first steps include its compile.

    JAX_PLATFORMS=cpu python3 tools/compaction_parity.py [--steps 1000] [--every 25]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
KEYS = ("density_avg", "density_max", "solver_iters", "div_iters", "vel_max")


def config() -> dict:
    with open(os.path.join(ROOT, "data", "scenes", "large_scale_dfsph.json")) as f:
        cfg = json.load(f)
    cfg["Configuration"]["domainEnd"] = [0.5, 1.0, 0.3]
    cfg["FluidBlocks"][0].update(start=[0.09, 0.1, 0.09], end=[0.25, 0.7, 0.21])
    return cfg


def run(step, steps: int, every: int) -> dict:
    """{step: row} of the diagnostics every ``every`` steps, and the
    seconds the run took."""
    rows, t0 = {}, time.perf_counter()
    for i in range(steps):
        d = step()
        if i % every == 0 or i == steps - 1:
            rows[i] = [float(d[k]) for k in KEYS]
    return rows, time.perf_counter() - t0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=1000)
    ap.add_argument("--every", type=int, default=25)
    args = ap.parse_args()
    import torch
    from sph_project_tpu import sim as jsim
    from sph_project_tpu.scene import load_scene as jax_load_scene
    from sph_project_tpu.utils.config import SimConfig as JaxSimConfig
    from sph_project_tpu_torch import sim as tsim
    from sph_project_tpu_torch.scene import load_scene as torch_load_scene
    from sph_project_tpu_torch.utils.config import SimConfig

    torch.set_num_threads(4)
    cfg = config()
    ts, tst = torch_load_scene(config=SimConfig(config=cfg))
    port, t_port = run(tsim.Simulation(ts, tst, device="cpu").step,
                       args.steps, args.every)
    js, jst = jax_load_scene(config=JaxSimConfig(config=cfg))
    jax, t_jax = run(jsim.Simulation(js, jst).step, args.steps, args.every)
    p = ts.params
    print(f"{int((tst.particles.material == 1).sum())} fluid of "
          f"{p.n_particles} particles, dt {p.dt}; port {t_port:.1f} s, "
          f"JAX {t_jax:.1f} s on the CPU")
    print("step  " + "  ".join(f"{k} (port / JAX)" for k in KEYS))
    for i in port:
        print(f"{i:5d}  " + "  ".join(
            f"{a:.3f} / {b:.3f}" for a, b in zip(port[i], jax[i])))
    return 0


if __name__ == "__main__":
    sys.exit(main())

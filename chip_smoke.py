#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``sph_project_tpu_torch``) on one GPU.

Run from the root of a checkout, on a host with one CUDA device:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``csrc/`` (one ``nvcc`` per
   source, all at once) and print the build time;
3. the main path: load the flagship scene ``large_scale_dfsph.json`` at full
   size (1,958,454 particles), ``Simulation(scene, state)`` (prepare) and
   ``STEPS`` steps on the card. Launch counts are zeroed just before and read
   just after; every kernel must have launched. Per step: wall ms, iteration
   counts, density range, overflow counters;
4. each kernel against its plain PyTorch version on the card, at the
   flagship's shapes: every pair body on the sorted state the main path left,
   the fused gather on the permutation of the next step's sort. Prints the
   error, the kernel's, the plain version's and (for the gather)
   ``index_select``'s time, and the least time the card could take;
5. the small domain-box scene for ``SMALL_STEPS`` steps on the CPU (plain
   versions) and on the card (kernels): equal iteration counts every step and
   every fluid particle within 1e-5 of its counterpart;
6. one JSON line per kernel record, the card line again, then the result.

Without a CUDA device, or outside a checkout of the repository, it fails
before printing any result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
FLAGSHIP = os.path.join(ROOT, "data", "scenes", "large_scale_dfsph.json")
STEPS = 8
SMALL_STEPS = 20
# kernel vs plain on the same inputs: float32 sums of ~30-60 terms taken in
# another order (max|a-b| <= TOL * max(1, max|b|)); counts and the gather exact
TOL = 2e-5
NN_TOL = 1e-5

# published H100 SXM peaks: HBM bytes/s and
# float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations per pair inside the radius: the geometry, R (3 sub) and d2
# (3 mul, 2 add), plus the body's own, counted from csrc/pair_pass.cu (a sqrt
# or a division counts as one). Candidates the cell walk tests and rejects are
# this design's cost, not the function's, so the bound does not count them.
GEOMETRY_OPS = 8
OPS_PER_PAIR = {"density": 15, "alpha": 24, "nonpressure": 55,
                "divergence": 24, "correction": 28,
                "density_alpha_divergence": 60, "rigid_volume": 15}
PAIR_REPLACES = "sph_project_tpu/ops/pair_dma.py:574"
PERMUTE_REPLACES = "sph_project_tpu/ops/permute.py:48"


def check(ok: bool, what: str) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke: {what}")


def say(*args) -> None:
    print(*args, flush=True)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "-i", "0",
                          "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def cuda_ms(fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (after one
    warm-up), from CUDA events."""
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


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def small_box_config() -> dict:
    """The small domain-box DFSPH scene of the CPU tests
    (tests/test_torch_scene.py box_config)."""
    return {
        "Configuration": {
            "domainStart": [0, 0, 0], "domainEnd": [0.3, 0.3, 0.3],
            "addDomainBox": True, "particleRadius": 0.01, "density0": 1000,
            "gravitation": [0, -9.81, 0], "simulationMethod": "dfsph",
            "viscosityMethod": "standard", "timeStepSize": 1e-3,
            "viscosity": 0.05, "viscosity_b": 0.03},
        "FluidBlocks": [{"objectId": 0, "start": [0.1, 0.08, 0.1],
                         "end": [0.2, 0.18, 0.2], "translation": [0, 0, 0],
                         "scale": [1, 1, 1], "velocity": [0.0, -2.5, 0.0],
                         "density": 1000.0, "color": [50, 100, 200],
                         "entryTime": -1.0}]}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke run needs one",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from sph_project_tpu_torch import sim as simlib
    from sph_project_tpu_torch.core.params import (MATERIAL_FLUID,
                                                   MATERIAL_NONE,
                                                   MATERIAL_RIGID)
    from sph_project_tpu_torch.ops import _build
    from sph_project_tpu_torch.ops import neighbors as nblib
    from sph_project_tpu_torch.ops import pair_kernels as pk
    from sph_project_tpu_torch.ops import pairs
    from sph_project_tpu_torch.ops import permute as permlib
    from sph_project_tpu_torch.scene import load_scene
    from sph_project_tpu_torch.solvers import common
    from sph_project_tpu_torch.utils.config import SimConfig

    # ---- 1. the card ------------------------------------------------------
    card = card_line()
    say(f"[1] card: {card}; torch {torch.__version__}, CUDA "
        f"{torch.version.cuda}, devices {torch.cuda.device_count()}")

    # ---- 2. build ---------------------------------------------------------
    t0 = time.perf_counter()
    _build.build_all(verbose=True)
    say(f"[2] built {', '.join(_build.SOURCES)} in "
        f"{time.perf_counter() - t0:.1f} s "
        f"(per source: {json.dumps({k: round(v, 1) for k, v in _build.build_seconds.items()})})")

    # ---- 3. the main path at full size -------------------------------------
    t0 = time.perf_counter()
    scene, state = load_scene(FLAGSHIP)
    params = scene.params
    mat = state.particles.material
    n_fluid = int((mat == MATERIAL_FLUID).sum())
    n_wall = int((mat == MATERIAL_RIGID).sum())
    say(f"[3] flagship loaded in {time.perf_counter() - t0:.1f} s: "
        f"{n_fluid} fluid + {n_wall} wall particles, n_pad {params.n_pad}, "
        f"grid {params.grid_num}")
    check(n_fluid + n_wall == 1958454, "flagship particle count")
    rho0 = params.density0
    for k in pk.launches:
        pk.launches[k] = 0
    permlib.launches["permute"] = 0
    t0 = time.perf_counter()
    sim = simlib.Simulation(scene, state)
    torch.cuda.synchronize()
    say(f"[3] prepare (sort, rigid volumes, density, alpha) on "
        f"{sim.device}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
    step_ms = []
    for s in range(STEPS):
        t0 = time.perf_counter()
        d = sim.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        row = {k: (float(v) if v.is_floating_point() else int(v))
               for k, v in d.items()}
        say(f"[3] step {s}: {step_ms[-1]:.2f} ms "
            f"solver_iters {row['solver_iters']} div_iters {row['div_iters']} "
            f"density_avg {row['density_avg']:.3f} "
            f"density_max {row['density_max']:.3f} vel_max {row['vel_max']:.4f} "
            f"neighbor_overflow {row['neighbor_overflow']} "
            f"sort_overflow {row['sort_overflow']}")
        for k in ("density_avg", "density_max"):
            check(0.72 * rho0 <= row[k] <= 1.01 * rho0,
                  f"step {s}: {k} {row[k]} outside [0.72, 1.01] rho0")
        check(row["neighbor_overflow"] == 0 and row["sort_overflow"] == 0,
              f"step {s}: overflow")
        check(row["fluid_num"] == n_fluid, f"step {s}: fluid count")
    torch.cuda.synchronize()
    launches = dict(pk.launches)
    launches["permute"] = permlib.launches["permute"]
    say(f"[3] launches on the main path: {json.dumps(launches)}")
    for k, v in launches.items():
        check(v > 0, f"kernel {k} never launched on the main path")
    p = sim.state.particles
    check(bool(torch.isfinite(p.pos).all()), "non-finite positions")
    say(f"[3] steps: mean {np.mean(step_ms):.2f} ms, after the first "
        f"{np.mean(step_ms[1:]):.2f} ms")

    # ---- 4. kernels vs plain versions at the flagship's shapes -------------
    env = sim.state.cached_neighbors
    n = params.n_pad
    rng = np.random.default_rng(0)
    kappa = torch.from_numpy(
        rng.uniform(-50.0, 200.0, n).astype(np.float32)).cuda()
    fields = {"pos": p.pos, "vel": p.vel, "material": p.material,
              "mass": p.mass, "rest_volume": p.rest_volume,
              "inv_rho": common._inv_rho(p), "object_id": p.object_id,
              "kappa": kappa,
              "k_rho": kappa / torch.clamp_min(p.density, 1e-12)}
    rigid_rows = p.material == MATERIAL_RIGID

    def work(produce):
        """(candidates tested, pairs inside the radius) over these rows."""
        rows = torch.nonzero(produce).flatten()
        _, ln = pairs.candidate_ranges(env, rows)
        cnt = pk.run_cuda("divergence", env, fields, params, produce,
                          flags=1)["cnt"]
        return int(ln.sum()), int(cnt.sum().item())

    work_of = {"fluid": work(env.produce), "rigid": work(rigid_rows)}
    for k, (cand, npairs) in work_of.items():
        say(f"[4] {k} rows: {cand} candidates tested, {npairs} pairs inside "
            f"the radius ({cand / max(npairs, 1):.2f} candidates per pair)")
    records = []
    for name, (_, _, _, needs) in pk.BODIES.items():
        flags = 1 if name == "divergence" else 0
        produce = rigid_rows if name == "rigid_volume" else None
        fk = {k: fields[k] for k in needs}
        out_k = pk.run_cuda(name, env, fk, params, produce, flags)
        out_p = pk.run_plain_body(name, env, fk, params, produce, flags)
        torch.cuda.synchronize()
        err = 0.0
        for c in out_k:
            e = float((out_k[c] - out_p[c]).abs().max())
            err = max(err, e)
            if c == "cnt":
                check(e == 0.0, f"{name}: neighbour counts differ")
            lim = TOL * max(1.0, float(out_p[c].abs().max()))
            check(e <= lim, f"{name}.{c}: max error {e} > {lim}")
        ms = cuda_ms(lambda: pk.run_cuda(name, env, fk, params, produce,
                                         flags), 20)
        plain_ms = cuda_ms(lambda: pk.run_plain_body(name, env, fk, params,
                                                     produce, flags), 2)
        _, npairs = work_of["rigid" if produce is not None else "fluid"]
        n_bytes = (sum(t.numel() * t.element_size() for t in fk.values())
                   + env.cells.numel() * 4 + env.cell_start.numel() * 4
                   + n * 1 + len(out_k) * n * 4)
        n_ops = npairs * (GEOMETRY_OPS + OPS_PER_PAIR[name])
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        say(f"[4] pair_pass/{name}: max_abs_err {err:.3e}, kernel {ms:.3f} ms, "
            f"plain {plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}: "
            f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.3f} Gop)")
        records.append(dict(
            name=f"pair_pass/{name}", route="cuda",
            source="sph_project_tpu_torch/csrc/pair_pass.cu",
            replaces=PAIR_REPLACES, launches=launches[name],
            max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, library_ms=None))

    # the next step's sort: advance positions as the step does, then bin
    p2 = common.update_fluid_position(p, params)
    p2 = common.enforce_domain_boundary(p2, params)
    cells = nblib.flat_cell_ids(p2.pos, p2.material != MATERIAL_NONE, params)
    perm = nblib.sort_permutation(cells)
    arrays = {k: getattr(p2, k) for k in simlib.permuted_keys(params)}
    arrays["cells"] = cells
    moved = int((perm != torch.arange(n, device=perm.device)).sum())
    out_k = permlib.permute_fields_cuda(perm, arrays)
    out_p = permlib.permute_fields_plain(perm, arrays)
    torch.cuda.synchronize()
    for k in arrays:
        check(out_k[k].dtype == arrays[k].dtype, f"permute {k}: dtype")
        check(torch.equal(out_k[k].view(torch.int32),
                          out_p[k].view(torch.int32)),
              f"permute {k}: not bit-equal")
    ms = cuda_ms(lambda: permlib.permute_fields_cuda(perm, arrays), 20)
    plain_ms = cuda_ms(lambda: permlib.permute_fields_plain(perm, arrays), 20)
    lib_ms = cuda_ms(lambda: [torch.index_select(v, 0, perm)
                              for v in arrays.values()], 20)
    n_bytes = (2 * sum(v.numel() * v.element_size() for v in arrays.values())
               + perm.numel() * perm.element_size())
    b_ms, b_by = bound_ms(n_bytes, 0)
    say(f"[4] permute: {len(arrays)} fields, {moved} of {n} rows move, "
        f"bit-equal; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
        f"index_select per field {lib_ms:.3f} ms, bound {b_ms:.4f} ms "
        f"({b_by}: {n_bytes / 1e6:.1f} MB)")
    records.append(dict(
        name="permute", route="cuda",
        source="sph_project_tpu_torch/csrc/permute.cu",
        replaces=PERMUTE_REPLACES, launches=launches["permute"],
        max_abs_err=0.0, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
        bound_by=b_by, library_ms=lib_ms))
    del sim, env, fields, arrays, out_k, out_p
    torch.cuda.empty_cache()

    # ---- 5. small wall scene: CPU plain versions vs card kernels -----------
    runs = {}
    for dev in ("cpu", "cuda"):
        sc, st = load_scene(config=SimConfig(config=small_box_config()))
        small = simlib.Simulation(sc, st, device=dev)
        iters = [(int(d["solver_iters"]), int(d["div_iters"]))
                 for d in (small.step() for _ in range(SMALL_STEPS))]
        sp = small.state.particles
        runs[dev] = (iters, sp.pos[sp.material == MATERIAL_FLUID].cpu())
    check(runs["cpu"][0] == runs["cuda"][0],
          f"small scene iteration counts differ: {runs['cpu'][0]} vs "
          f"{runs['cuda'][0]}")
    a, b = runs["cuda"][1].double(), runs["cpu"][1].double()
    check(a.shape == b.shape, "small scene fluid counts differ")
    nn = float(torch.cdist(a, b).min(dim=1).values.max())
    say(f"[5] small domain-box scene, {SMALL_STEPS} steps: iterations "
        f"(density, divergence) {runs['cuda'][0]} equal on CPU and card; "
        f"max nearest-neighbour distance {nn:.3e}")
    check(nn < NN_TOL, f"small scene trajectories differ by {nn}")

    # ---- 6. records --------------------------------------------------------
    say(json.dumps({"kernels": records}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

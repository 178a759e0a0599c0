#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``sph_project_tpu_torch``) on one GPU.

Run from the root of a checkout, on a host with one CUDA device:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped):

1. print the card's name and power limit (``nvidia-smi``);
2. build every CUDA kernel of the port from ``csrc/`` (one ``nvcc`` per
   source, all at once) and print the build time;
3. the paths, each on the flagship scene ``large_scale_dfsph.json`` at full
   size (1,958,454 particles) through ``load_scene`` and
   ``Simulation(scene, state)`` (prepare) and some steps on the card:
   DFSPH cold through the cell-list kernel; DFSPH warm-started through the
   slab-window kernel (``pair_backend="pallas"``, both warm starts); two
   short DFSPH runs, warm through the cell-list kernel and cold through the
   slab-window kernel; then WCSPH, PCISPH and IISPH (``simulation_method``
   overridden) through the cell-list kernel and, in short runs, through the
   slab-window kernel, so that every body launches under both engines.
   Launch counts are zeroed just before each path and read just after; every
   kernel the path should run must have launched, and no other. Per step:
   wall ms, iteration counts, density range, overflow counters;
4. each kernel against its plain PyTorch version on the card, at the
   flagship's shapes: the DFSPH bodies of the cell-list kernel on the sorted
   state the cold DFSPH path left and those of the slab-window kernel on the
   state the warm slab path left; the WCSPH, PCISPH and IISPH bodies of each
   kernel on the state its IISPH path left, sorted again as its next step
   would sort it, since the step moves the fluid after its sort (all
   producing rows, neighbour counts exact; pressures, predicted positions,
   d_ii and sum d_ij p_j made from a numpy seed); the two kernels against
   each other on both slab states; and the fused gather on the permutation
   of the next step's sort with the cold path's fields and with the warm
   path's. Prints the error, the kernel's, the plain version's
   and (for the gather) ``index_select``'s time, the least time the card could
   take (``bound_ms``) and the least this method could take
   (``issue_floor_ms``), the candidates each engine tests per pair it keeps
   (counted from that engine's own table), and the window statistics of the
   slab-window engine. Then the pile-up check: a synthetic state whose rows
   have about 250 neighbours, far more than a list of the kernels' walk
   holds, in runs that cross several staged tiles, through both kernels
   against their plain versions;
5. the small domain-box scene for ``SMALL_STEPS`` steps on the CPU (plain
   versions) and on the card (kernels): DFSPH cold through the cell-list
   engine, warm through it and warm through the slab-window engine, then
   WCSPH, PCISPH and IISPH through the cell-list engine: equal iteration
   counts every step and every fluid particle within 1e-5 of its counterpart;
6. one JSON line with every kernel record, the card line again, then the
   result.

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
WARM = dict(dfsph_warm_start=True, dfsph_warm_start_div=True)
SLAB = dict(pair_backend="pallas")
# the bodies each method's path runs; prepare adds rigid_volume (the walls)
DFSPH_BODIES = ("density", "alpha", "nonpressure", "divergence", "correction",
                "density_alpha_divergence", "rigid_volume", "nonpressure_warm")
NEW_METHOD_BODIES = {
    "wcsph": ("pressure",),
    "pcisph": ("pcisph_density_pred", "pressure"),
    "iisph": ("iisph_dii", "iisph_aii", "iisph_density_star", "iisph_dij_pj",
              "iisph_sum_i", "pressure")}
NEW_BODIES = tuple(dict.fromkeys(b for bodies in NEW_METHOD_BODIES.values()
                                 for b in bodies))
# (label, parameter overrides, steps); phase 4 measures on the states the
# paths in MEASURED leave
PATHS = (("DFSPH cold, cell-list kernel", {}, 4),
         ("DFSPH warm start, slab-window kernel", dict(WARM, **SLAB), 4),
         ("DFSPH warm start, cell-list kernel", WARM, 2),
         ("DFSPH cold, slab-window kernel", SLAB, 2),
         ("WCSPH, cell-list kernel", dict(simulation_method="wcsph"), 3),
         ("PCISPH, cell-list kernel", dict(simulation_method="pcisph"), 3),
         ("IISPH, cell-list kernel", dict(simulation_method="iisph"), 4),
         ("WCSPH, slab-window kernel", dict(simulation_method="wcsph", **SLAB), 2),
         ("PCISPH, slab-window kernel", dict(simulation_method="pcisph", **SLAB), 2),
         ("IISPH, slab-window kernel", dict(simulation_method="iisph", **SLAB), 2))
MEASURED = ("DFSPH cold, cell-list kernel", "DFSPH warm start, slab-window kernel",
            "IISPH, cell-list kernel", "IISPH, slab-window kernel")
SMALL_STEPS = 20
SMALL_RUNS = (("DFSPH cold, cell-list", {}), ("DFSPH warm start, cell-list", WARM),
              ("DFSPH warm start, slab-window", dict(WARM, **SLAB)),
              ("WCSPH, cell-list", dict(simulation_method="wcsph")),
              ("PCISPH, cell-list", dict(simulation_method="pcisph")),
              ("IISPH, cell-list", dict(simulation_method="iisph")))
# kernel vs plain on the same inputs: float32 sums of ~30-60 terms taken in
# another order (max|a-b| <= TOL * max(1, max|b|)); counts and the gather exact
TOL = 2e-5
NN_TOL = 1e-5

# published H100 SXM peaks: HBM bytes/s and
# float32 FLOP/s outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_OPS_PER_S = 67e12
# operations per pair inside the radius: the geometry, R (3 sub) and d2
# (3 mul, 2 add), plus the body's own, counted from csrc/pair_bodies.cuh (a
# sqrt or a division counts as one). Candidates an engine tests and rejects
# are that design's cost, not the function's, so the bound does not count
# them, and a body's bound differs between the engines only by the table.
GEOMETRY_OPS = 8
OPS_PER_PAIR = {"density": 15, "alpha": 24, "nonpressure": 55,
                "divergence": 24, "correction": 28,
                "density_alpha_divergence": 60, "rigid_volume": 15,
                "nonpressure_warm": 71, "pressure": 25,
                "pcisph_density_pred": 21, "iisph_dii": 25, "iisph_aii": 33,
                "iisph_density_star": 24, "iisph_dij_pj": 26,
                "iisph_sum_i": 47}
# what the method needs at the least, beside the card's bound: every candidate
# a row tests costs 12 instructions (3 loads, 3 subtractions, 3
# multiplications, 2 additions, 1 compare; the loop, the j != i compare and
# the append are not counted), every pair inside the radius the geometry and
# the body's operations again, one instruction each at the least. The card
# starts one instruction per cycle from each of its 4 schedulers per
# multiprocessor to a warp of 32 rows, at the highest clock ``nvidia-smi``
# reports.
TEST_INSTR = 12
SCHEDULERS_PER_SM = 4
PILE_UP_BODIES = ("density_alpha_divergence", "nonpressure_warm", "pressure",
                  "iisph_sum_i")
ENGINES = {
    "pair_pass": ("sph_project_tpu_torch/csrc/pair_pass.cu",
                  "sph_project_tpu/ops/pair_dma.py:574"),
    "pair_slab": ("sph_project_tpu_torch/csrc/pair_slab.cu",
                  "sph_project_tpu/ops/pair_exec.py:204")}
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


def cuda_ms(fn, reps: int, warm_up: bool = True) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (after one
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


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / FP32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def instruction_rate() -> float:
    """Instructions per second the card can start, counted per row (thread):
    multiprocessors x schedulers x 32 lanes x the highest SM clock."""
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    hz = float(out.stdout.strip()) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * SCHEDULERS_PER_SM * 32 * hz


def nbytes(tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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


def expected_bodies(params) -> set:
    """The pair bodies a path of ``params``' method launches, prepare's
    rigid volumes included."""
    method = params.simulation_method
    if method == "dfsph":
        unused = "nonpressure" if params.dfsph_warm_start else "nonpressure_warm"
        return {b for b in DFSPH_BODIES if b != unused}
    return {"rigid_volume", "density", "nonpressure",
            *NEW_METHOD_BODIES[method]}


def path_kind(params) -> str:
    method = params.simulation_method
    if method == "dfsph":
        return "dfsph warm" if params.dfsph_warm_start else "dfsph cold"
    return method


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

    # ---- 3. the paths at full size ------------------------------------------
    def drive(label: str, overrides: dict, steps: int):
        """One path on the flagship: load, prepare, ``steps`` gated steps.
        Returns (simulation, launches of that run)."""
        t0 = time.perf_counter()
        scene, state = load_scene(FLAGSHIP, **overrides)
        params = scene.params
        mat = state.particles.material
        n_fluid = int((mat == MATERIAL_FLUID).sum())
        n_wall = int((mat == MATERIAL_RIGID).sum())
        say(f"[3] {label}: flagship loaded in {time.perf_counter() - t0:.1f} s"
            f": {n_fluid} fluid + {n_wall} wall particles, n_pad "
            f"{params.n_pad}, grid {params.grid_num}, pair_block "
            f"{params.pair_block}, overrides {json.dumps(overrides)}")
        check(n_fluid + n_wall == 1958454, "flagship particle count")
        rho0 = params.density0
        for k in pk.launches:
            pk.launches[k] = 0
        permlib.launches["permute"] = 0
        t0 = time.perf_counter()
        sim = simlib.Simulation(scene, state)
        torch.cuda.synchronize()
        say(f"[3] {label}: prepare (sort, rigid volumes"
            f"{', density, alpha' if params.simulation_method == 'dfsph' else ''}"
            f") on {sim.device}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
        step_ms = []
        for s in range(steps):
            before = dict(pk.launches)
            t0 = time.perf_counter()
            d = sim.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            row = {k: (float(v) if v.is_floating_point() else int(v))
                   for k, v in d.items()}
            iters = "".join(f"{k} {row[k]} " for k in ("solver_iters",
                                                         "div_iters")
                            if k in row)
            say(f"[3] step {s}: {step_ms[-1]:.2f} ms {iters}"
                f"density_avg {row['density_avg']:.3f} "
                f"density_max {row['density_max']:.3f} "
                f"vel_max {row['vel_max']:.4f} "
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
        last_step = {k: v - before[k] for k, v in launches.items()}
        launches["permute"] = permlib.launches["permute"]
        say(f"[3] {label}: launches {json.dumps({k: v for k, v in launches.items() if v})}"
            f"; in the last step {json.dumps({k: v for k, v in last_step.items() if v})}")
        engine = pk.engine_of(sim.state.cached_neighbors)
        check(engine == ("pair_slab" if overrides.get("pair_backend")
                         == "pallas" else "pair_pass"), f"{label}: engine")
        expected = {f"{engine}/{b}" for b in expected_bodies(params)}
        expected.add("permute")
        for k, v in launches.items():
            check((v > 0) == (k in expected),
                  f"{label}: kernel {k} launched {v} times")
        check(bool(torch.isfinite(sim.state.particles.pos).all()),
              "non-finite positions")
        say(f"[3] {label}: steps mean {np.mean(step_ms):.2f} ms, after the "
            f"first {np.mean(step_ms[1:]):.2f} ms")
        if params.dfsph_warm_start:
            k_max = float(sim.state.dfsph_kappa.abs().max())
            kv_max = float(sim.state.dfsph_kappa_v.abs().max())
            say(f"[3] {label}: the block is in free fall in these steps, so "
                f"the carried stiffness stays near zero (max |kappa| "
                f"{k_max:.3e}, max |kappa_v| {kv_max:.3e}): the warm path's "
                f"kernels and carries run, its saving of iterations does not "
                f"show here")
        return sim, launches, last_step

    sims, path_launches, step_launches = {}, [], {}
    for label, overrides, steps in PATHS:
        sim, launches, last_step = drive(label, overrides, steps)
        path_launches.append(launches)
        # pair launches of one free-fall step, by engine and method
        step_launches[(pk.engine_of(sim.state.cached_neighbors),
                       path_kind(sim.params))] = last_step
        # the other runs only count launches
        if label in MEASURED:
            sims[label] = sim
        del sim
        torch.cuda.empty_cache()
    total_launches = {k: sum(p[k] for p in path_launches)
                      for k in path_launches[0]}
    for k, v in total_launches.items():
        check(v > 0, f"kernel {k} launched on no path")

    # ---- 4. kernels vs plain versions at the flagship's shapes -------------
    records = []

    def pair_fields(sim):
        """The fields of every body on ``sim``'s state; the stiffness, the
        pressure, the predicted positions, d_ii and sum d_ij p_j from a
        numpy seed."""
        st, params = sim.state, sim.params
        p, n = st.particles, params.n_pad
        rng = np.random.default_rng(0)

        def seeded(x):
            return torch.from_numpy(x.astype(np.float32)).cuda()

        kappa = seeded(rng.uniform(-50.0, 200.0, n))
        pressure = seeded(rng.uniform(0.0, 5000.0, n))
        fluid = (p.material == MATERIAL_FLUID)[:, None]
        shift = seeded(rng.normal(0.0, 0.1 * params.particle_radius, (n, 3)))
        rho2 = torch.clamp_min(p.density * p.density, 1e-12)
        return {"pos": p.pos, "vel": p.vel, "material": p.material,
                "mass": p.mass, "rest_volume": p.rest_volume,
                "inv_rho": common._inv_rho(p), "object_id": p.object_id,
                "kappa": kappa,
                "k_rho": kappa / torch.clamp_min(p.density, 1e-12),
                "pressure": pressure, "density": p.density,
                "p_rho2": pressure / rho2,
                "dpi": params.density0 * p.rest_volume / rho2,
                "inv_star2": 1.0 / torch.clamp_min(
                    torch.square(st.iisph_density_star), 1e-12),
                "pred": torch.where(fluid, p.pos + shift, p.pos),
                "dii": seeded(rng.normal(0.0, 1e-2, (n, 3))),
                "dij_pj": seeded(rng.normal(0.0, 10.0, (n, 3)))}

    def check_engine(sim, bodies):
        """``bodies`` of the engine of ``sim``'s environment against their
        plain versions on ``sim``'s state; appends the records."""
        env = sim.state.cached_neighbors
        params, p = sim.params, sim.state.particles
        engine = pk.engine_of(env)
        slab = engine == "pair_slab"
        n = params.n_pad
        fields = pair_fields(sim)
        rigid_rows = p.material == MATERIAL_RIGID

        def work(produce):
            """(candidates tested, pairs inside the radius) over these rows,
            the candidates counted from the engine's own table: a row's 9
            runs of the cell table, or its 9 pieces of its block's windows."""
            rows = torch.nonzero(produce).flatten()
            ranges = pairs.window_pieces if slab else pairs.candidate_ranges
            cand = int(ranges(env, rows)[1].sum())
            cnt = pk.run_cuda("divergence", env, fields, params, produce,
                              flags=1)["cnt"]
            return cand, int(cnt.sum().item())

        work_of = {"fluid": work(env.produce), "rigid": work(rigid_rows)}
        for k, (cand, npairs) in work_of.items():
            say(f"[4] {engine}, {k} rows: {cand} candidates tested, {npairs} "
                f"pairs inside the radius ({cand / max(npairs, 1):.2f} "
                f"candidates per pair)")
        table = ((env.starts, env.lens, env.cells) if slab
                 else (env.cells, env.cell_start))
        if slab:
            width = env.lens.sum(1)[env.produce.view(-1, env.block).any(1)]
            say(f"[4] {engine}: {env.nb} blocks of {env.block} rows, "
                f"{width.numel()} with fluid rows; candidates in a fluid "
                f"block's 9 windows: median {int(width.median())}, widest "
                f"{int(width.max())}; widest single window "
                f"{int(env.lens.max())} (what a block stages; a row tests "
                f"only its piece); the plain version runs over all blocks "
                f"for every body")
        for name in bodies:
            needs = pk.BODIES[name][3]
            flags = 1 if name == "divergence" else 0
            produce = rigid_rows if name == "rigid_volume" else None
            fk = {k: fields[k] for k in needs}

            def plain():
                return pk.run_plain_body(name, env, fk, params, produce, flags)

            out_k = pk.run_cuda(name, env, fk, params, produce, flags)
            out_p = plain()
            torch.cuda.synchronize()
            err = 0.0
            for c in out_k:
                e = float((out_k[c] - out_p[c]).abs().max())
                err = max(err, e)
                if c == "cnt":
                    check(e == 0.0, f"{engine}/{name}: neighbour counts differ")
                lim = TOL * max(1.0, float(out_p[c].abs().max()))
                check(e <= lim, f"{engine}/{name}.{c}: max error {e} > {lim}")
            ms = cuda_ms(lambda: pk.run_cuda(name, env, fk, params, produce,
                                             flags), 20)
            # the slab engine's plain version takes seconds: the comparison
            # above was its warm-up
            plain_ms = cuda_ms(plain, 1, warm_up=False) if slab \
                else cuda_ms(plain, 2)
            tests, npairs = work_of["rigid" if produce is not None
                                    else "fluid"]
            n_bytes = (nbytes(fk.values()) + nbytes(table) + n * 1
                       + len(out_k) * n * 4)
            n_ops = npairs * (GEOMETRY_OPS + OPS_PER_PAIR[name])
            b_ms, b_by = bound_ms(n_bytes, n_ops)
            floor_ms = (tests * TEST_INSTR + n_ops) / instr_per_s * 1e3
            say(f"[4] {engine}/{name}: max_abs_err {err:.3e}, kernel "
                f"{ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
                f"{b_ms:.4f} ms ({b_by}: {n_bytes / 1e6:.1f} MB, "
                f"{n_ops / 1e9:.3f} Gop), instruction floor {floor_ms:.4f} ms")
            records.append(dict(
                name=f"{engine}/{name}", route="cuda",
                source=ENGINES[engine][0], replaces=ENGINES[engine][1],
                launches=total_launches[f"{engine}/{name}"],
                max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                bound_by=b_by, library_ms=None,
                issue_floor_ms=floor_ms, tests_per_pair=tests / max(npairs, 1),
                launches_per_step={
                    kind: last[f"{engine}/{name}"]
                    for (e, kind), last in step_launches.items()
                    if e == engine and last[f"{engine}/{name}"]}))
        if slab:
            # the two kernels on one state: a row tests the same candidates
            # in the same order under both and adds what it keeps in that
            # order, so the sums are equal bit for bit
            cell_env = pairs.make_pair_env(env.cells, env.produce, params)
            for name in bodies:
                needs = pk.BODIES[name][3]
                flags = 1 if name == "divergence" else 0
                produce = rigid_rows if name == "rigid_volume" else None
                fk = {k: fields[k] for k in needs}
                a = pk.run_cuda(name, env, fk, params, produce, flags)
                b = pk.run_cuda(name, cell_env, fk, params, produce, flags)
                diff = max(float((a[c] - b[c]).abs().max()) for c in a)
                scale = max(float(b[c].abs().max()) for c in b)
                say(f"[4] pair_slab vs pair_pass, {name}: largest difference "
                    f"{diff:.3e} (largest sum {scale:.3e})"
                    f"{', bit-equal' if diff == 0.0 else ''}")
                check(diff == 0.0,
                      f"the two pair kernels are not bit-equal on {name}: "
                      f"{diff}")

    def check_pile_up():
        """Both kernels on the pile-up state against their plain versions,
        neighbour counts exact: lists that fill and flush many times per
        row, runs that cross several staged tiles, empty cells, edge and
        corner cells and a sentinel tail."""
        params, cells, produce, fields = pk.pile_up_case()
        cells, produce = cells.cuda(), produce.cuda()
        fields = {k: v.cuda() for k, v in fields.items()}
        for engine, make in (("pair_pass", pairs.make_pair_env),
                             ("pair_slab", pairs.make_slab_env)):
            env = make(cells, produce, params)
            longest = int(pairs.candidate_ranges(
                env, torch.nonzero(produce).flatten())[1].max())
            for name in PILE_UP_BODIES:
                fk = {k: fields[k] for k in pk.BODIES[name][3]}
                out_p = pk.run_plain_body(name, env, fk, params)
                if "cnt" in out_p:
                    most = int(out_p["cnt"].max())
                out_k = pk.run_cuda(name, env, fk, params)
                torch.cuda.synchronize()
                err = 0.0
                for c in out_k:
                    e = float((out_k[c] - out_p[c]).abs().max())
                    err = max(err, e)
                    if c == "cnt":
                        check(e == 0.0, f"pile-up, {engine}/{name}: "
                              f"neighbour counts differ")
                    lim = TOL * max(1.0, float(out_p[c].abs().max()))
                    check(e <= lim, f"pile-up, {engine}/{name}.{c}: max "
                          f"error {e} > {lim}")
                say(f"[4] pile-up, {engine}/{name}: {int(produce.sum())} "
                    f"rows, most neighbours of a row {most}, longest run of "
                    f"candidates {longest}, max_abs_err {err:.3e}, counts "
                    f"exact")

    def check_permute(sim):
        """The fused gather on the next step's sort of ``sim``'s state:
        advance positions as the step does, then bin. Returns its numbers."""
        params, st = sim.params, sim.state
        n = params.n_pad
        p2 = common.update_fluid_position(st.particles, params)
        p2 = common.enforce_domain_boundary(p2, params)
        cells = nblib.flat_cell_ids(p2.pos, p2.material != MATERIAL_NONE,
                                    params)
        perm = nblib.sort_permutation(cells)
        keys, extras = simlib.permuted_keys(params)
        arrays = {k: getattr(p2, k) for k in keys}
        arrays.update({k: getattr(st, k) for k in extras})
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
        plain_ms = cuda_ms(lambda: permlib.permute_fields_plain(perm, arrays),
                           20)
        lib_ms = cuda_ms(lambda: [torch.index_select(v, 0, perm)
                                  for v in arrays.values()], 20)
        n_bytes = 2 * nbytes(arrays.values()) + nbytes([perm])
        b_ms, b_by = bound_ms(n_bytes, 0)
        say(f"[4] permute: {len(arrays)} fields, {moved} of {n} rows move, "
            f"bit-equal; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, "
            f"index_select per field {lib_ms:.3f} ms, bound {b_ms:.4f} ms "
            f"({b_by}: {n_bytes / 1e6:.1f} MB)")
        return dict(fields=len(arrays), max_abs_err=0.0, ms=ms,
                    plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=lib_ms)

    instr_per_s = instruction_rate()
    say(f"[4] instruction rate {instr_per_s:.4e} per second and row "
        f"({torch.cuda.get_device_properties(0).multi_processor_count} "
        f"multiprocessors x {SCHEDULERS_PER_SM} schedulers x 32 lanes x the "
        f"highest SM clock); a candidate tested counts {TEST_INSTR}, a pair "
        f"kept the operations of the bound")
    check_pile_up()
    cold_sim, slab_sim = sims[MEASURED[0]], sims[MEASURED[1]]
    check_engine(cold_sim, DFSPH_BODIES)
    check_engine(slab_sim, DFSPH_BODIES)
    for label in MEASURED[2:]:
        # a feed-forward step moves the fluid after its sort: sort again, as
        # the next step would, so that cells and positions agree
        sim = sims[label]
        state, env = simlib.Plumbing.neighbor_prep(sim.state, sim.params)
        sim.state = state.replace(cached_neighbors=env)
        check_engine(sim, NEW_BODIES)
    del sim
    records.append(dict(
        name="permute", route="cuda",
        source="sph_project_tpu_torch/csrc/permute.cu",
        replaces=PERMUTE_REPLACES, launches=total_launches["permute"],
        **check_permute(cold_sim), warm_path=check_permute(slab_sim)))
    del sims, cold_sim, slab_sim
    torch.cuda.empty_cache()

    # ---- 5. small wall scene: CPU plain versions vs card kernels -----------
    for label, overrides in SMALL_RUNS:
        runs = {}
        for dev in ("cpu", "cuda"):
            sc, st = load_scene(config=SimConfig(config=small_box_config()),
                                **overrides)
            small = simlib.Simulation(sc, st, device=dev)
            iters = [tuple(int(d[k]) for k in ("solver_iters", "div_iters")
                           if k in d)
                     for d in (small.step() for _ in range(SMALL_STEPS))]
            sp = small.state.particles
            runs[dev] = (iters, sp.pos[sp.material == MATERIAL_FLUID].cpu())
        check(runs["cpu"][0] == runs["cuda"][0],
              f"small scene ({label}) iteration counts differ: "
              f"{runs['cpu'][0]} vs {runs['cuda'][0]}")
        a, b = runs["cuda"][1].double(), runs["cpu"][1].double()
        check(a.shape == b.shape, "small scene fluid counts differ")
        nn = float(torch.cdist(a, b).min(dim=1).values.max())
        say(f"[5] small domain-box scene, {label}, {SMALL_STEPS} steps: "
            f"iterations (pressure solver, divergence solver) "
            f"{runs['cuda'][0]} equal on CPU and card; max nearest-neighbour "
            f"distance {nn:.3e}")
        check(nn < NN_TOL, f"small scene ({label}) trajectories differ by {nn}")

    # ---- 6. records --------------------------------------------------------
    check(len(records) == 2 * len(pk.BODIES) + 1, "a kernel has no record")
    say(json.dumps({"kernels": records}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

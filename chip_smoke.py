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
   Then the coupled paths, on the reference's own rigid-body scenes at full
   size: ``dragon_bath_{dfsph,wcsph,pcisph,iisph}.json`` (589,824 slots, two
   dynamic dragons) under each method through both kernels (DFSPH cold and
   warm), and ``coupling_nine_rigid.json`` (1,094,656 slots, nine dynamic
   bodies, ten contact channels) under DFSPH through the cell-list kernel.
   Then the viscous paths, DFSPH cold with implicit viscosity:
   ``high_viscosity_implicit.json`` (447,488 slots) and
   ``high_viscosity_bunny.json`` (1,010,688) through both kernels,
   ``buckling_emitter.json`` (2,288,640) and ``coiling_emitter.json``
   (1,948,672, whose streams reach the emitter height after 13 steps)
   through the cell-list kernel; each step also prints the CG iterations, its
   residual and the largest |visc_x|, and the matvec must launch once more
   than the CG iterates. On the emitter paths the fluid count never falls
   and ends above 0, and the density band, with a floor of
   ``EMITTER_DENSITY_LOW``, holds for the densest particle (a stream 3-4
   particles across is mostly surface).
   Launch counts are zeroed just before each path and read just after; every
   kernel the path should run must have launched, and no other (a body run
   with the outputs of dynamic rigid bodies counts as ``<body>+rigid``), and
   the rigid-volume pass on moved positions must launch once in every step
   of a coupled WCSPH, PCISPH or IISPH path and in no other step. Per
   step: wall ms, iteration counts, density range, overflow counters, and on
   the coupled paths each dynamic body's com, velocity and angular velocity,
   which must be finite;
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
   against their plain versions. Then the rigid-body variants (the five
   bodies with dynamic-rigid outputs, ``rigid_volume`` on positions moved
   after the sort, and ``rigid_contact``) under both kernels on the pile-up
   state, whose dynamic rows of two bodies and static rows of a third give
   hundreds of wrench and contact pairs, and on the ``dragon_bath`` states
   the DFSPH paths left: against their plain versions, the two kernels
   bit-equal, with each variant's times and bound. Then the implicit
   viscosity's two passes (``visc_prep``, ``visc_matvec``, also in the
   pile-up check, where rigid neighbours add to b) on the states the
   ``high_viscosity_implicit`` paths left, timed, the engines bit-equal;
5. the small domain-box scene for ``SMALL_STEPS`` steps on the CPU (plain
   versions) and on the card (kernels): DFSPH cold through the cell-list
   engine, warm through it and warm through the slab-window engine, then
   WCSPH, PCISPH and IISPH through the cell-list engine: equal iteration
   counts every step and every fluid particle within 1e-5 of its counterpart.
   Then two small coupled scenes the same way: a dynamic cube dropped into a
   fluid pool in the domain box (DFSPH for ``SMALL_STEPS`` steps, the other
   methods for ``COUPLED_STEPS``) and three cubes squeezed together in zero
   gravity (WCSPH, ``SQUEEZE_STEPS``), each body's state compared every step.
   Then two small implicit-viscosity scenes the same way: the domain box
   (viscosity 2000: 830 CG iterations at impact) and a column falling
   through an emitter height, with the iteration counts, the CG's and the
   fluid count equal every step;
6. one JSON line with every kernel record, the card line again, then the
   result.

Without a CUDA device, or outside a checkout of the repository, it fails
before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SCENES = os.path.join(ROOT, "data", "scenes")
FLAGSHIP = os.path.join(SCENES, "large_scale_dfsph.json")
WARM = dict(dfsph_warm_start=True, dfsph_warm_start_div=True)
SLAB = dict(pair_backend="pallas")
# particles per scene: fluid, rigid, of which in dynamic bodies
COUNTS = {"large_scale_dfsph.json": (None, None, 0),
          "dragon_bath_dfsph.json": (321750, 259197, 42918),
          "dragon_bath_wcsph.json": (321750, 259197, 42918),
          "dragon_bath_pcisph.json": (321750, 259197, 42918),
          "dragon_bath_iisph.json": (321750, 259197, 42918),
          "coupling_nine_rigid.json": (790020, 299780, 9926),
          "high_viscosity_implicit.json": (153125, 289854, 0),
          "high_viscosity_bunny.json": (172213, 829512, 0),
          # fluid at load: prepare makes the part above g_upper placeholders
          "buckling_emitter.json": (106400, 2175303, 0),
          "coiling_emitter.json": (99880, 1843674, 0)}
FLAGSHIP_PARTICLES = 1958454
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
# (label, scene, parameter overrides, steps); phase 4 measures on the states
# the paths in MEASURED and COUPLED_MEASURED leave
PATHS = (("DFSPH cold, cell-list kernel", "large_scale_dfsph.json", {}, 4),
         ("DFSPH warm start, slab-window kernel", "large_scale_dfsph.json",
          dict(WARM, **SLAB), 4),
         ("DFSPH warm start, cell-list kernel", "large_scale_dfsph.json", WARM, 2),
         ("DFSPH cold, slab-window kernel", "large_scale_dfsph.json", SLAB, 2),
         ("WCSPH, cell-list kernel", "large_scale_dfsph.json",
          dict(simulation_method="wcsph"), 3),
         ("PCISPH, cell-list kernel", "large_scale_dfsph.json",
          dict(simulation_method="pcisph"), 3),
         ("IISPH, cell-list kernel", "large_scale_dfsph.json",
          dict(simulation_method="iisph"), 4),
         ("WCSPH, slab-window kernel", "large_scale_dfsph.json",
          dict(simulation_method="wcsph", **SLAB), 2),
         ("PCISPH, slab-window kernel", "large_scale_dfsph.json",
          dict(simulation_method="pcisph", **SLAB), 2),
         ("IISPH, slab-window kernel", "large_scale_dfsph.json",
          dict(simulation_method="iisph", **SLAB), 2),
         ("dragon_bath DFSPH cold, cell-list kernel", "dragon_bath_dfsph.json", {}, 3),
         ("dragon_bath DFSPH cold, slab-window kernel", "dragon_bath_dfsph.json",
          SLAB, 2),
         ("dragon_bath DFSPH warm start, cell-list kernel",
          "dragon_bath_dfsph.json", WARM, 2),
         ("dragon_bath DFSPH warm start, slab-window kernel",
          "dragon_bath_dfsph.json", dict(WARM, **SLAB), 1),
         ("dragon_bath WCSPH, cell-list kernel", "dragon_bath_wcsph.json", {}, 2),
         ("dragon_bath WCSPH, slab-window kernel", "dragon_bath_wcsph.json", SLAB, 1),
         ("dragon_bath PCISPH, cell-list kernel", "dragon_bath_pcisph.json", {}, 2),
         ("dragon_bath PCISPH, slab-window kernel", "dragon_bath_pcisph.json",
          SLAB, 1),
         ("dragon_bath IISPH, cell-list kernel", "dragon_bath_iisph.json", {}, 2),
         ("dragon_bath IISPH, slab-window kernel", "dragon_bath_iisph.json", SLAB, 1),
         ("coupling_nine_rigid DFSPH cold, cell-list kernel",
          "coupling_nine_rigid.json", {}, 2),
         ("high_viscosity_implicit DFSPH cold, cell-list kernel",
          "high_viscosity_implicit.json", {}, 2),
         ("high_viscosity_implicit DFSPH cold, slab-window kernel",
          "high_viscosity_implicit.json", SLAB, 2),
         ("high_viscosity_bunny DFSPH cold, cell-list kernel",
          "high_viscosity_bunny.json", {}, 2),
         ("high_viscosity_bunny DFSPH cold, slab-window kernel",
          "high_viscosity_bunny.json", SLAB, 1),
         ("buckling_emitter DFSPH cold, cell-list kernel",
          "buckling_emitter.json", {}, 2),
         ("coiling_emitter DFSPH cold, cell-list kernel",
          "coiling_emitter.json", {}, 16))
MEASURED = ("DFSPH cold, cell-list kernel", "DFSPH warm start, slab-window kernel",
            "IISPH, cell-list kernel", "IISPH, slab-window kernel")
COUPLED_MEASURED = ("dragon_bath DFSPH cold, cell-list kernel",
                    "dragon_bath DFSPH cold, slab-window kernel")
VISCOUS_MEASURED = ("high_viscosity_implicit DFSPH cold, cell-list kernel",
                    "high_viscosity_implicit DFSPH cold, slab-window kernel")
# the two passes of the implicit viscosity solve
VISCOUS_BODIES = ("visc_prep", "visc_matvec")
# the floor of the density band for the densest fluid particle of an emitter
# path. Its stream is 3-4 particles across, so most of its particles lie on
# the surface and miss neighbours (mean density 0.57-0.71 rho0 in CPU runs of
# the small emitter scenes), and its first particles below the emitter
# height have none below them: 0.68 rho0 at the densest on
# coiling_emitter.json's first delivery on the H100
EMITTER_DENSITY_LOW = 0.5
SMALL_STEPS = 20
COUPLED_STEPS = 10
SQUEEZE_STEPS = 45
SMALL_RUNS = (("DFSPH cold, cell-list", {}), ("DFSPH warm start, cell-list", WARM),
              ("DFSPH warm start, slab-window", dict(WARM, **SLAB)),
              ("WCSPH, cell-list", dict(simulation_method="wcsph")),
              ("PCISPH, cell-list", dict(simulation_method="pcisph")),
              ("IISPH, cell-list", dict(simulation_method="iisph")))
# kernel vs plain on the same inputs: float32 sums of ~30-60 terms taken in
# another order (max|a-b| <= TOL * max(1, max|b|)); counts and the gather exact
TOL = 2e-5
NN_TOL = 1e-5
# body states of the small coupled scenes, CPU against card (the bars of the
# CPU tests against the JAX package): com and rotation within 1e-5, velocity
# and angular velocity within 1e-4 of the largest |value| of that quantity,
# taken as at least SPEED_FLOOR (m/s, rad/s): slower than that a body is at
# rest, and the squeeze's angular velocity, 1e-8 rad/s, is rounding noise
BODY_TOL = {"com": 1e-5, "rot": 1e-5, "vel": 1e-4, "omega": 1e-4}
SPEED_FLOOR = 1e-3

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
                "iisph_sum_i": 47, "rigid_contact": 5}
# the viscous passes' operations per pair by the neighbour's material,
# (fluid j, rigid j): the matvec leaves a rigid j out after one compare, the
# prep adds b's rigid term for it
VISC_OPS = {"visc_prep": (42, 55), "visc_matvec": (36, 1)}
# what a variant adds on each pair of a dynamic rigid row with a fluid
# neighbour (density_alpha_divergence: its same-object sum, on every pair)
RIGID_EXTRA_OPS = {"nonpressure": 12, "nonpressure_warm": 27,
                   "correction": 15, "pressure": 30,
                   "density_alpha_divergence": 2}
# what the contact body adds on each touching pair (penetration, 1/dist and
# the four sums of its channel)
CONTACT_TOUCH_OPS = 13
# the rigid-body variants of phase 4: (record name, body, flags); the moved
# rigid volume and the contact pass produce on the dynamic rigid rows only
RIGID_VARIANTS = (("nonpressure+rigid", "nonpressure", True),
                  ("nonpressure_warm+rigid", "nonpressure_warm", True),
                  ("correction+rigid", "correction", True),
                  ("pressure+rigid", "pressure", True),
                  ("density_alpha_divergence+rigid", "density_alpha_divergence", True),
                  ("rigid_volume@moved", "rigid_volume", False),
                  ("rigid_contact", "rigid_contact", False))
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
                  "iisph_sum_i", "visc_prep", "visc_matvec")
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


def implicit_box_config() -> dict:
    """The small domain-box scene with implicit viscosity 2000 (the CPU
    tests' tests/test_torch_viscosity.py implicit_config(2000.0))."""
    cfg = small_box_config()
    cfg["Configuration"].update(viscosityMethod="implicit", viscosity=2000.0,
                                viscosity_b=2000.0)
    return cfg


def emitter_column_config() -> dict:
    """A fluid column falling at 2 m/s through the emitter height 0.2 in a
    0.4^3 domain box, implicit viscosity 50 (the CPU tests'
    tests/test_torch_emitter.py column_config("implicit"))."""
    return {"Configuration": {
        "domainStart": [0, 0, 0], "domainEnd": [0.4, 0.4, 0.4],
        "addDomainBox": True, "particleRadius": 0.01, "density0": 1000,
        "gravitation": [0.0, -9.81, 0.0], "simulationMethod": "dfsph",
        "viscosityMethod": "implicit", "timeStepSize": 1e-3,
        "viscosity": 50.0, "gravitationUpper": 0.2},
        "FluidBlocks": [{"objectId": 0, "start": [0.14, 0.08, 0.14],
                         "end": [0.26, 0.34, 0.26], "translation": [0, 0, 0],
                         "scale": [1, 1, 1], "velocity": [0, -2.0, 0],
                         "density": 1000.0, "color": [0, 0, 0],
                         "entryTime": -1.0}]}


def cube_obj(size: float) -> str:
    """An axis-aligned cube mesh centred at the origin, written under
    ``build/`` of the checkout (the layout of tests/test_rigid.py)."""
    path = os.path.join(ROOT, "build", "smoke", f"cube_{size}.obj")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    h = size / 2.0
    verts = [(x, y, z) for x in (-h, h) for y in (-h, h) for z in (-h, h)]
    quads = [(1, 2, 4, 3), (5, 7, 8, 6), (1, 5, 6, 2),
             (3, 4, 8, 7), (1, 3, 7, 5), (2, 6, 8, 4)]
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for q in quads:
            f.write("f " + " ".join(str(i) for i in q) + "\n")
    return path


def cube_body(oid, geom, translation, density=500.0, vel=(0, 0, 0)) -> dict:
    return {"objectId": oid, "geometryFile": geom,
            "translation": list(translation), "rotationAxis": [0, 1, 0],
            "rotationAngle": 0.0, "scale": [1, 1, 1], "velocity": list(vel),
            "density": density, "color": [255, 255, 255], "isDynamic": True,
            "entryTime": -1.0}


def cube_pool_config(method: str) -> dict:
    """The coupled scene of the CPU tests (tests/test_torch_rigid_steps.py):
    a cube of 0.06 dropped at 1.5 m/s onto a fluid pool in the domain box."""
    cfg = small_box_config()
    cfg["Configuration"]["simulationMethod"] = method
    cfg["FluidBlocks"][0].update(start=[0.08, 0.08, 0.08],
                                 end=[0.22, 0.13, 0.22], velocity=[0, 0, 0])
    cfg["RigidBodies"] = [cube_body(1, cube_obj(0.06), (0.15, 0.175, 0.15),
                                    vel=(0.0, -1.5, 0.0))]
    return cfg


def squeeze_config() -> dict:
    """tests/test_rigid.py's three-box squeeze: two cubes of 0.1 close on a
    third at 0.8 m/s in zero gravity, no fluid, WCSPH."""
    cube = cube_obj(0.1)
    return {"Configuration": {
        "domainStart": [0, 0, 0], "domainEnd": [0.6, 0.6, 0.6],
        "addDomainBox": False, "particleRadius": 0.01, "density0": 1000,
        "gravitation": [0, 0, 0], "simulationMethod": "wcsph",
        "viscosityMethod": "standard", "timeStepSize": 1e-3,
        "viscosity": 0.05},
        "RigidBodies": [cube_body(0, cube, (0.17, 0.3, 0.3), vel=(0.8, 0, 0)),
                        cube_body(1, cube, (0.30, 0.3, 0.3)),
                        cube_body(2, cube, (0.43, 0.3, 0.3), vel=(-0.8, 0, 0))]}


def expected_bodies(params) -> set:
    """The launch keys (without the engine) a path of ``params``' method
    launches, prepare's included; ``+rigid`` where a body runs with the
    outputs of dynamic rigid bodies."""
    method = params.simulation_method
    rigid = params.has_dynamic_rigid

    def v(body):
        return f"{body}+rigid" if rigid else body

    implicit = params.viscosity_method == "implicit"
    if method == "dfsph":
        # the warm correction rides the non-pressure pass only with standard
        # viscosity
        np_body = "nonpressure_warm" if params.dfsph_warm_start and \
            not implicit else "nonpressure"
        out = {"density", "alpha", "rigid_volume", "divergence", v(np_body),
               v("correction"), v("density_alpha_divergence")}
    else:
        out = {"rigid_volume", "density", v("nonpressure"), v("pressure"),
               *(b for b in NEW_METHOD_BODIES[method] if b != "pressure")}
        if method == "pcisph":
            out.add("pressure")      # the prediction loop's, without wrench
    if rigid and params.contact_channels:
        out.add("rigid_contact")
    if implicit:
        out.update(VISCOUS_BODIES)
    return out


def path_kind(scene: str, params) -> str:
    method = params.simulation_method
    if method == "dfsph":
        method = "dfsph warm" if params.dfsph_warm_start else "dfsph cold"
    return f"{scene[:-5]}: {method}"


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
    from sph_project_tpu_torch.rigid import integrator
    from sph_project_tpu_torch.scene import load_scene
    from sph_project_tpu_torch.solvers import common
    from sph_project_tpu_torch.solvers import viscosity_cg
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
    def drive(label: str, scene_name: str, overrides: dict, steps: int):
        """One path on a scene at full size: load, prepare, ``steps`` gated
        steps. Returns (simulation, launches of that run, launches of its
        last step, the steps' launches of the rigid-volume pass)."""
        t0 = time.perf_counter()
        scene, state = load_scene(os.path.join(SCENES, scene_name),
                                  **overrides)
        params = scene.params
        p0 = state.particles
        n_fluid = int((p0.material == MATERIAL_FLUID).sum())
        n_rigid = int((p0.material == MATERIAL_RIGID).sum())
        n_dyn = int(((p0.material == MATERIAL_RIGID) & (p0.is_dynamic > 0)).sum())
        say(f"[3] {label}: {scene_name} loaded in "
            f"{time.perf_counter() - t0:.1f} s: {n_fluid} fluid + {n_rigid} "
            f"rigid particles ({n_dyn} in {len(params.contact_channels)} "
            f"dynamic bodies), n_pad {params.n_pad}, grid {params.grid_num}, "
            f"pair_block {params.pair_block}, contact channels "
            f"{len(params.contact_channels) + 1 if n_dyn else 0}, overrides "
            f"{json.dumps(overrides)}")
        want = COUNTS[scene_name]
        if want[0] is None:
            check(n_fluid + n_rigid == FLAGSHIP_PARTICLES,
                  "flagship particle count")
        else:
            check((n_fluid, n_rigid, n_dyn) == want,
                  f"{scene_name} particle counts")
        rho0 = params.density0
        engine = "pair_slab" if overrides.get("pair_backend") == "pallas" \
            else "pair_pass"
        # the feed-forward methods recompute the dynamic bodies' volumes
        # every step on moved positions (rigid_and_tail); DFSPH takes them
        # from its fused pass, and prepare's launch comes before the steps
        moved_key = f"{engine}/rigid_volume"
        moved_want = int(params.has_dynamic_rigid
                         and params.simulation_method != "dfsph")
        moved = 0
        for k in pk.launches:
            pk.launches[k] = 0
        permlib.launches["permute"] = 0
        t0 = time.perf_counter()
        sim = simlib.Simulation(scene, state)
        torch.cuda.synchronize()
        say(f"[3] {label}: prepare (sort, rigid volumes"
            f"{', density, alpha' if params.simulation_method == 'dfsph' else ''}"
            f") on {sim.device}: {(time.perf_counter() - t0) * 1e3:.1f} ms")
        implicit = params.viscosity_method == "implicit"
        step_ms = []
        fluid_num = 0
        for s in range(steps):
            before = dict(pk.launches)
            t0 = time.perf_counter()
            d = sim.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            n_moved = pk.launches[moved_key] - before[moved_key]
            check(n_moved == moved_want, f"{label}, step {s}: the rigid-volume "
                  f"pass launched {n_moved} times, not {moved_want}")
            moved += n_moved
            row = {k: (float(v) if v.is_floating_point() else int(v))
                   for k, v in d.items()}
            iters = "".join(f"{k} {row[k]} " for k in ("solver_iters",
                                                         "div_iters")
                            if k in row)
            if implicit:
                # one matvec for the initial residual and one per iteration
                cg = viscosity_cg.last_solve["cg_iters"]
                n_mv = pk.launches[f"{engine}/visc_matvec"] - \
                    before[f"{engine}/visc_matvec"]
                n_prep = pk.launches[f"{engine}/visc_prep"] - \
                    before[f"{engine}/visc_prep"]
                check(n_mv == cg + 1 and n_prep == 1,
                      f"{label}, step {s}: {n_prep} prep and {n_mv} matvec "
                      f"launches for {cg} CG iterations")
                iters += (f"cg_iters {cg} cg_err "
                          f"{viscosity_cg.last_solve['cg_err']:.3e} max|visc_x| "
                          f"{float(viscosity_cg.last_solve['visc_x_max']):.4e} ")
            say(f"[3] step {s}: {step_ms[-1]:.2f} ms {iters}"
                f"fluid_num {row['fluid_num']} "
                f"density_avg {row['density_avg']:.3f} "
                f"density_max {row['density_max']:.3f} "
                f"vel_max {row['vel_max']:.4f} "
                f"neighbor_overflow {row['neighbor_overflow']} "
                f"sort_overflow {row['sort_overflow']}")
            if params.has_entries:
                # emitter placeholders turn fluid: the count never falls.
                # The density band's floor holds for the densest particle
                # only, and lower (EMITTER_DENSITY_LOW); no fluid, no density
                check(fluid_num <= row["fluid_num"] <= n_fluid,
                      f"step {s}: fluid count {row['fluid_num']} after "
                      f"{fluid_num}, of {n_fluid}")
                check(row["density_avg"] <= 1.01 * rho0,
                      f"step {s}: density_avg {row['density_avg']}")
                check(row["fluid_num"] == 0 or EMITTER_DENSITY_LOW * rho0
                      <= row["density_max"] <= 1.01 * rho0,
                      f"step {s}: density_max {row['density_max']} outside "
                      f"[{EMITTER_DENSITY_LOW}, 1.01] rho0")
            else:
                check(row["fluid_num"] == n_fluid, f"step {s}: fluid count")
                for k in ("density_avg", "density_max"):
                    check(0.72 * rho0 <= row[k] <= 1.01 * rho0,
                          f"step {s}: {k} {row[k]} outside [0.72, 1.01] rho0")
            fluid_num = row["fluid_num"]
            check(row["neighbor_overflow"] == 0 and row["sort_overflow"] == 0,
                  f"step {s}: overflow")
            rigid = sim.state.rigid
            for oid in params.contact_channels:
                body = {k: getattr(rigid, k)[oid].tolist()
                        for k in ("com", "vel", "omega")}
                say(f"[3]   body {oid}: " + ", ".join(
                    f"{k} ({', '.join(f'{x:.6f}' for x in v)})"
                    for k, v in body.items()))
                check(all(np.isfinite(v).all() for v in body.values()),
                      f"step {s}: body {oid} state not finite")
        torch.cuda.synchronize()
        launches = dict(pk.launches)
        last_step = {k: v - before[k] for k, v in launches.items()}
        launches["permute"] = permlib.launches["permute"]
        say(f"[3] {label}: launches {json.dumps({k: v for k, v in launches.items() if v})}"
            f"; in the last step {json.dumps({k: v for k, v in last_step.items() if v})}")
        check(pk.engine_of(sim.state.cached_neighbors) == engine,
              f"{label}: engine")
        expected = {f"{engine}/{b}" for b in expected_bodies(params)}
        expected.add("permute")
        for k, v in launches.items():
            check((v > 0) == (k in expected),
                  f"{label}: kernel {k} launched {v} times")
        check(bool(torch.isfinite(sim.state.particles.pos).all()),
              "non-finite positions")
        if params.has_entries:
            check(fluid_num > 0, f"{label}: the emitter delivered no fluid")
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
        return sim, launches, last_step, moved

    sims, path_launches, step_launches = {}, [], {}
    # launches of the per-step rigid-volume pass on moved positions: in all,
    # and per step, by engine and path
    moved_launches = {e: 0 for e in pk.ENGINES}
    moved_per_step = {}
    for label, scene_name, overrides, steps in PATHS:
        sim, launches, last_step, moved = drive(label, scene_name, overrides,
                                                steps)
        path_launches.append(launches)
        # pair launches of one step, by engine, scene and method
        engine = pk.engine_of(sim.state.cached_neighbors)
        kind = path_kind(scene_name, sim.params)
        step_launches[(engine, kind)] = last_step
        moved_launches[engine] += moved
        if moved:
            moved_per_step[(engine, kind)] = moved // steps
        # the other runs only count launches
        if label in MEASURED + COUPLED_MEASURED + VISCOUS_MEASURED:
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
                "dij_pj": seeded(rng.normal(0.0, 10.0, (n, 3))),
                "x": torch.where(fluid, p.vel + seeded(
                    rng.normal(0.0, 0.1, (n, 3))), torch.zeros_like(p.vel))}

    def work_of_rows(env, params, fields, produce):
        """(candidates tested, pairs inside the radius) over these rows, the
        candidates counted from the engine's own table: a row's 9 runs of the
        cell table, or its 9 pieces of its block's windows."""
        rows = torch.nonzero(produce).flatten()
        slab = pk.engine_of(env) == "pair_slab"
        ranges = pairs.window_pieces if slab else pairs.candidate_ranges
        cand = int(ranges(env, rows)[1].sum())
        cnt = pk.run_cuda("divergence", env, fields, params, produce,
                          flags=1)["cnt"]
        return cand, int(cnt.sum().item())

    def rigid_j_pairs(env, params, fields, produce) -> int:
        """Pairs inside the radius of these rows whose neighbour is rigid,
        through the plain cell-list executor."""
        cell_env = pairs.make_pair_env(env.cells, env.produce, params)
        comps = {k: fields[k] for k in ("pos", "material")}

        def body(cx):
            _, d2, mask = cx.geometry()
            return {"n": cx.sum(torch.ones_like(d2), mask & (
                cx.slab("material") == MATERIAL_RIGID))}

        out = pairs.run_plain(body, cell_env, comps, ("n",), produce=produce)
        return int(out["n"].sum().item())

    def rows_read(env, params, fields, produce) -> int:
        """The rows whose fields a pass over these producing rows needs: the
        rows themselves and every row within the radius of one. A pair is
        symmetric, so these are the rows that produce or have a producing
        neighbour: one plain pass over all rows, through the cell-list
        executor (the pairs of both engines are the same)."""
        cell_env = pairs.make_pair_env(env.cells, env.produce, params)
        comps = {"pos": fields["pos"], "mark": produce.to(torch.float32)}

        def body(cx):
            _, _, mask = cx.geometry()
            return {"n": cx.sum(cx.slab("mark"), mask)}

        out = pairs.run_plain(body, cell_env, comps, ("n",),
                              produce=fields["material"] != MATERIAL_NONE)
        return int((produce | (out["n"] > 0)).sum().item())

    def pass_bytes(fk, read, table, n_out, n) -> int:
        """Bytes a pass must move at the least, each once: its per-row fields
        on the ``read`` rows it needs, its per-object tables, the engine's
        table, the produce mask and its (n_out, n) outputs."""
        fields = sum(t.numel() * t.element_size() // t.shape[0] * read
                     if t.shape[0] == n else t.numel() * t.element_size()
                     for t in fk.values())
        return fields + nbytes(table) + n * 1 + n_out * n * 4

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
            return work_of_rows(env, params, fields, produce)

        work_of = {"fluid": work(env.produce), "rigid": work(rigid_rows)}
        read_of = {k: rows_read(env, params, fields, rows)
                   for k, rows in (("fluid", env.produce),
                                   ("rigid", rigid_rows))}
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
            rows = "rigid" if produce is not None else "fluid"
            tests, npairs = work_of[rows]
            n_bytes = pass_bytes(fk, read_of[rows], table, len(out_k), n)
            if name in VISC_OPS:
                n_rj = rigid_j_pairs(env, params, fields, env.produce)
                f_ops, r_ops = VISC_OPS[name]
                n_ops = (npairs * GEOMETRY_OPS + (npairs - n_rj) * f_ops
                         + n_rj * r_ops)
                say(f"[4] {engine}/{name}: {n_rj} of the {npairs} pairs have "
                    f"a rigid neighbour")
            else:
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
        p2 = common.update_fluid_position(st.particles, st.rigid, params)
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


    # ---- 4b. the rigid-body variants ------------------------------------
    def moved_positions(pos, com_rows, dyn_rows, dt):
        """Positions after one step of rigid motion of every dynamic body:
        turned by omega = (1, -2, 0.5) rad/s about its com and shifted by
        (0.3, -0.5, 0.2) m/s, over dt."""
        omega = torch.tensor([[1.0, -2.0, 0.5]], device=pos.device)
        turn = integrator._rodrigues(omega, dt)[0]
        shift = torch.tensor([0.3, -0.5, 0.2], device=pos.device) * dt
        new = com_rows + common.matvec(turn, pos - com_rows) + shift
        return torch.where(dyn_rows[:, None], new, pos).contiguous()

    def count_pairs(env, params, fields, produce, select):
        """Pairs inside the radius of these rows that ``select(cx)`` keeps,
        through the plain cell-list executor (the pairs of both engines are
        the same)."""
        cell_env = pairs.make_pair_env(env.cells, env.produce, params)
        comps = {k: fields[k] for k in ("pos", "material", "object_id")}
        obj = fields["object_id"]
        comps["chan"] = torch.where(
            obj >= 0, fields["chan"][obj.clamp(0, params.max_objects - 1).long()],
            torch.full_like(obj, -1))

        def body(cx):
            _, d2, mask = cx.geometry()
            return {"n": cx.sum(torch.ones_like(d2), mask & select(cx, d2))}

        out = pairs.run_plain(body, cell_env, comps, ("n",), produce=produce)
        return int(out["n"].sum().item())

    def fluid_j(cx, d2):
        return cx.slab("material") == MATERIAL_FLUID

    def check_rigid(where, params, env, fields, produce_all, dyn_rows, dt,
                    measure):
        """Every rigid-body variant under ``env``'s engine on one state
        against its plain version (2e-5 * max(1, max|b|)), and under the slab
        engine against the cell-list kernel, bit for bit. With ``measure``:
        the times, the bound and a record per variant."""
        engine = pk.engine_of(env)
        slab = engine == "pair_slab"
        n = params.n_pad

        def touching_j(cx, d2):
            return ((cx.blk("material") == MATERIAL_RIGID)
                    & (cx.slab("material") == MATERIAL_RIGID)
                    & (cx.blk("object_id") != cx.slab("object_id"))
                    & (torch.sqrt(d2) < params.particle_diameter)
                    & (cx.slab("chan") >= 0))

        com_rows = fields["com"][fields["object_id"].clamp(
            0, params.max_objects - 1).long()]
        moved = dict(fields, pos=moved_positions(fields["pos"], com_rows,
                                                 dyn_rows, dt))
        cell_env = pairs.make_pair_env(env.cells, env.produce, params)
        if measure:
            cand_all, pairs_all = work_of_rows(env, params, fields, produce_all)
            cand_dyn, pairs_dyn = work_of_rows(env, params, fields, dyn_rows)
            _, pairs_moved = work_of_rows(env, params, moved, dyn_rows)
            read_all = rows_read(env, params, fields, produce_all)
            read_dyn = rows_read(env, params, fields, dyn_rows)
            read_moved = rows_read(env, params, moved, dyn_rows)
            n_rf = count_pairs(env, params, fields, dyn_rows, fluid_j)
            n_touch = count_pairs(env, params, fields, dyn_rows, touching_j)
            say(f"[4] {where}, {engine}: {int(dyn_rows.sum())} dynamic rigid "
                f"rows; contact pass: {cand_dyn} candidates tested, "
                f"{pairs_dyn} pairs inside the radius, {n_touch} touching "
                f"pairs with a contact channel; {n_rf} pairs of a dynamic "
                f"rigid row and a fluid neighbour (the wrench pairs); rows "
                f"whose fields a pass reads: {read_all} of the variants' "
                f"producing rows and their neighbours, {read_dyn} of the "
                f"dynamic rows' ({read_moved} after the move)")
        for rec, body, rigid_flag in RIGID_VARIANTS:
            flags = pk.RIGID if rigid_flag else 0
            produce = produce_all if rigid_flag else dyn_rows
            fk = {k: (moved if body == "rigid_volume" else fields)[k]
                  for k in pk.fields_of(body, flags)}

            def kernel(e=env):
                return pk.run_cuda(body, e, fk, params, produce, flags)

            def plain():
                return pk.run_plain_body(body, env, fk, params, produce, flags)

            out_k, out_p = kernel(), plain()
            torch.cuda.synchronize()
            err, biggest = 0.0, 0.0
            for c in out_k:
                e = float((out_k[c] - out_p[c]).abs().max())
                err = max(err, e)
                biggest = max(biggest, float(out_p[c].abs().max()))
                if c == "cnt":
                    check(e == 0.0, f"{where}, {engine}/{rec}: counts differ")
                lim = TOL * max(1.0, float(out_p[c].abs().max()))
                check(e <= lim, f"{where}, {engine}/{rec}.{c}: max error "
                      f"{e} > {lim}")
            same = ""
            if slab:
                out_c = kernel(cell_env)
                diff = max(float((out_k[c] - out_c[c]).abs().max())
                           for c in out_k)
                check(diff == 0.0, f"{where}: the two pair kernels are not "
                      f"bit-equal on {rec}: {diff}")
                same = ", bit-equal to the cell-list kernel"
            say(f"[4] {where}, {engine}/{rec}: max_abs_err {err:.3e} "
                f"(largest sum {biggest:.3e}){same}")
            if not measure:
                continue
            ms = cuda_ms(kernel, 20)
            plain_ms = cuda_ms(plain, 1, warm_up=False) if slab \
                else cuda_ms(plain, 2)
            table = ((env.starts, env.lens, env.cells) if slab
                     else (env.cells, env.cell_start))
            read = (read_moved if body == "rigid_volume"
                    else read_all if rigid_flag else read_dyn)
            n_bytes = pass_bytes(fk, read, table, len(out_k), n)
            if body == "rigid_contact":
                tests, npairs = cand_dyn, pairs_dyn
                n_ops = (pairs_dyn * (GEOMETRY_OPS + OPS_PER_PAIR[body])
                         + n_touch * CONTACT_TOUCH_OPS)
                empty = torch.zeros_like(dyn_rows)
                empty_ms = cuda_ms(lambda: pk.run_cuda(
                    body, env, fk, params, empty, flags), 20)
                say(f"[4] {where}, {engine}/{rec}: the same launch with no "
                    f"row producing (what the non-producing rows cost: "
                    f"their warps or blocks write zeros and exit) "
                    f"{empty_ms:.4f} ms")
            elif body == "rigid_volume":
                tests, npairs = cand_dyn, pairs_moved
                n_ops = pairs_moved * (GEOMETRY_OPS + OPS_PER_PAIR[body])
            else:
                tests, npairs = cand_all, pairs_all
                extra = pairs_all if body == "density_alpha_divergence" else n_rf
                n_ops = (pairs_all * (GEOMETRY_OPS + OPS_PER_PAIR[body])
                         + extra * RIGID_EXTRA_OPS[body])
            b_ms, b_by = bound_ms(n_bytes, n_ops)
            floor_ms = (tests * TEST_INSTR + n_ops) / instr_per_s * 1e3
            key = pk.launch_key(engine, body, flags)
            if body == "rigid_volume":
                launches, per_step = moved_launches[engine], {
                    kind: k for (e, kind), k in moved_per_step.items()
                    if e == engine}
            else:
                launches = total_launches[key]
                per_step = {kind: last[key]
                            for (e, kind), last in step_launches.items()
                            if e == engine and last[key]}
            say(f"[4] {where}, {engine}/{rec}: kernel {ms:.3f} ms, plain "
                f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}: "
                f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.4f} Gop), instruction "
                f"floor {floor_ms:.4f} ms, launches {launches}")
            records.append(dict(
                name=f"{engine}/{rec}", route="cuda",
                source=ENGINES[engine][0], replaces=ENGINES[engine][1],
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=b_ms, bound_by=b_by, library_ms=None,
                issue_floor_ms=floor_ms, tests_per_pair=tests / max(npairs, 1),
                launches_per_step=per_step))

    def check_rigid_pile_up():
        """The rigid-body variants on the pile-up state under both kernels:
        dynamic rows of objects 0 and 1 (with a com each), static rows of
        object 2."""
        params, cells, produce, fields = pk.pile_up_case()
        params = dataclasses.replace(params, contact_channels=pk.PILE_UP_CHANNELS)
        cells, produce = cells.cuda(), produce.cuda()
        fields = {k: v.cuda() for k, v in fields.items()}
        dyn_rows = (fields["material"] == MATERIAL_RIGID) & \
            (fields["is_dynamic"] > 0)
        for make in (pairs.make_pair_env, pairs.make_slab_env):
            env = make(cells, produce, params)
            check_rigid("pile-up", params, env, fields, produce | dyn_rows,
                        dyn_rows, 2e-3, measure=False)

    def check_rigid_scene(sim):
        """The rigid-body variants on a coupled scene's state, measured."""
        st, params = sim.state, sim.params
        p = st.particles
        env = st.cached_neighbors
        fields = pair_fields(sim)
        fields.update(is_dynamic=p.is_dynamic, com=st.rigid.com.contiguous(),
                      chan=integrator.channel_table(st.rigid, params))
        dyn_rows = integrator.dynamic_rigid_mask(p, st.rigid, params)
        check_rigid("dragon_bath", params, env, fields, env.produce, dyn_rows,
                    params.dt, measure=True)

    instr_per_s = instruction_rate()
    say(f"[4] instruction rate {instr_per_s:.4e} per second and row "
        f"({torch.cuda.get_device_properties(0).multi_processor_count} "
        f"multiprocessors x {SCHEDULERS_PER_SM} schedulers x 32 lanes x the "
        f"highest SM clock); a candidate tested counts {TEST_INSTR}, a pair "
        f"kept the operations of the bound")
    check_pile_up()
    check_rigid_pile_up()
    for label in COUPLED_MEASURED:
        check_rigid_scene(sims.pop(label))
        torch.cuda.empty_cache()
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
    for label in VISCOUS_MEASURED:
        check_engine(sims.pop(label), VISCOUS_BODIES)
        torch.cuda.empty_cache()
    records.append(dict(
        name="permute", route="cuda",
        source="sph_project_tpu_torch/csrc/permute.cu",
        replaces=PERMUTE_REPLACES, launches=total_launches["permute"],
        **check_permute(cold_sim), warm_path=check_permute(slab_sim)))
    del sims, cold_sim, slab_sim
    torch.cuda.empty_cache()

    # ---- 5. small scenes: CPU plain versions vs card kernels ---------------
    small_runs = [(f"small domain-box scene, {label}", small_box_config(),
                   overrides) for label, overrides in SMALL_RUNS]
    # implicit viscosity against the walls, and an implicit emitter whose
    # placeholders turn fluid: the CG's iterations and the fluid count too
    small_runs += [("implicit domain box", implicit_box_config(), {}),
                   ("implicit emitter column", emitter_column_config(), {})]
    for label, cfg, overrides in small_runs:
        runs = {}
        for dev in ("cpu", "cuda"):
            sc, st = load_scene(config=SimConfig(config=cfg), **overrides)
            small = simlib.Simulation(sc, st, device=dev)
            implicit = sc.params.viscosity_method == "implicit"
            counts = []
            for _ in range(SMALL_STEPS):
                d = small.step()
                counts.append(
                    tuple(int(d[k]) for k in ("solver_iters", "div_iters")
                          if k in d)
                    + ((viscosity_cg.last_solve["cg_iters"],
                        int(d["fluid_num"])) if implicit else ()))
            sp = small.state.particles
            runs[dev] = (counts, sp.pos[sp.material == MATERIAL_FLUID].cpu())
        check(runs["cpu"][0] == runs["cuda"][0],
              f"{label}: counts differ: {runs['cpu'][0]} vs "
              f"{runs['cuda'][0]}")
        a, b = runs["cuda"][1].double(), runs["cpu"][1].double()
        check(a.shape == b.shape, f"{label}: fluid counts differ")
        nn = float(torch.cdist(a, b).min(dim=1).values.max())
        say(f"[5] {label}, {SMALL_STEPS} steps: (pressure solver, divergence "
            f"solver{', CG, fluid count' if implicit else ''}) iterations "
            f"{runs['cuda'][0]} equal on CPU and card; max nearest-neighbour "
            f"distance {nn:.3e}")
        check(nn < NN_TOL, f"{label}: trajectories differ by {nn}")

    coupled_runs = [(f"cube pool, {m.upper()}", cube_pool_config(m),
                     SMALL_STEPS if m == "dfsph" else COUPLED_STEPS)
                    for m in ("dfsph", "wcsph", "pcisph", "iisph")]
    coupled_runs.append(("three-box squeeze", squeeze_config(), SQUEEZE_STEPS))
    for label, cfg, steps in coupled_runs:
        runs = {}
        for dev in ("cpu", "cuda"):
            sc, st = load_scene(config=SimConfig(config=cfg))
            small = simlib.Simulation(sc, st, device=dev)
            bodies = list(sc.params.contact_channels)
            iters, states = [], []
            for _ in range(steps):
                d = small.step()
                iters.append(tuple(int(d[k]) for k in ("solver_iters",
                                                       "div_iters") if k in d))
                r = small.state.rigid
                states.append({k: getattr(r, k)[bodies].cpu().double()
                               for k in BODY_TOL})
            sp = small.state.particles
            runs[dev] = (iters, states,
                         sp.pos[sp.material == MATERIAL_FLUID].cpu())
        check(runs["cpu"][0] == runs["cuda"][0],
              f"{label}: iteration counts differ: {runs['cpu'][0]} vs "
              f"{runs['cuda'][0]}")
        worst = {k: 0.0 for k in BODY_TOL}
        for s, (a, b) in enumerate(zip(runs["cuda"][1], runs["cpu"][1])):
            for k, tol in BODY_TOL.items():
                scale = float(torch.stack([x[k] for x in runs["cpu"][1]])
                              .abs().max()) if k in ("vel", "omega") else 1.0
                e = float((a[k] - b[k]).abs().max())
                scale = max(scale, SPEED_FLOOR)
                worst[k] = max(worst[k], e / scale)
                check(e <= tol * scale,
                      f"{label}, step {s}: body {k} differs by {e}")
        a, b = runs["cuda"][2].double(), runs["cpu"][2].double()
        nn = float(torch.cdist(a, b).min(dim=1).values.max()) if len(b) else 0.0
        check(a.shape == b.shape and nn < NN_TOL,
              f"{label}: fluid differs by {nn}")
        last = runs["cuda"][1][-1]
        say(f"[5] {label}, {steps} steps: iterations {runs['cuda'][0]} equal "
            f"on CPU and card; body states every step within "
            f"{json.dumps({k: f'{v:.2e}' for k, v in worst.items()})} "
            f"(com, rot absolute; vel, omega relative to their largest "
            f"|value|, at least {SPEED_FLOOR}); fluid max nearest-neighbour distance {nn:.3e}; last "
            f"com {[[round(x, 6) for x in c] for c in last['com'].tolist()]}, "
            f"vel {[[round(x, 5) for x in c] for c in last['vel'].tolist()]}")

    # ---- 6. records --------------------------------------------------------
    check(len(records) == 2 * (len(pk.BODIES) - 1 + len(RIGID_VARIANTS)) + 1,
          "a kernel has no record")
    say(json.dumps({"kernels": records}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

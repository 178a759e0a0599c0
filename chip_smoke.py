#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``sph_project_tpu_torch``) on one GPU.

Run from the root of a checkout, on a host with one CUDA device:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and skipped). Every
``Simulation`` on the card captures its step into a CUDA graph, the solver
loops conditional WHILE nodes (``ops/graph_loop.py``, ``csrc/graph_loop.cu``),
and steps by replaying it (the shape-matching backend steps eagerly); launch
counts are read with the loop iterations of the replays added in:

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
   path's, with its pack and its unpack (the fields as one (n, W) int32
   buffer), bit-equal to their plain versions and to ``index_select``, and
   so again under a uniformly random permutation and on a 2D state of an
   odd row count. Prints the error, the kernel's, the plain version's
   and (for the gather) ``index_select``'s time (the gather's also as the
   device's time alone, behind a sleep on the stream, with its wrapper's
   host time per call), the least time the card could
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
6. the port's driver at full size, through the CLI
   (``sph_project_tpu_torch.cli.main``, what ``run_simulation_torch.py``
   runs) and the checkpoint module, checkpoints under ``build/smoke/``: the
   flagship, cold DFSPH through the cell-list kernel, through impact to the
   JAX bench's settle point (1,250 steps, 0.75 s), with the density solver
   iterating more than once on each of its last steps and the bench's gates
   at the end; a resume from that checkpoint, 20 steps straight through
   against 10, a checkpoint, a fresh ``load_scene`` + ``Simulation`` and 10
   more, bit for bit; the settled regime from that checkpoint per method and
   engine (DFSPH cold and warm through each engine; WCSPH, PCISPH, IISPH
   through the cell-list engine), timed; ``dragon_bath_dfsph.json`` through
   the fluid's arrival at the dragons (the first step with a fluid force on
   one, read before the body step consumes it), with finite bodies and a
   fluid force in the last step. Launch counts are zeroed just before each
   run and read just after, as in phase 3. Then the DFSPH bodies of both
   kernels on the settled states and the rigid-body variants of both
   kernels on the post-impact ``dragon_bath`` state (with its wrench and
   touching pairs) against their plain versions, the kernels bit-equal;
7. PBF: ``pbf_3d.json`` at full size (468,000 fluid particles, 2D-tuned
   reference constants in 3D with s_corr off: a violent flow) for
   ``PBF_STEPS`` steps through each kernel, every step with its wall ms,
   density range, vel_max*dt, finite positions, overflow 0 and exact
   launches (one ``nonpressure@poly6``, five of each PBF body, one gather,
   nothing else); on the state the cell-list run left, the iterations of
   one step with the candidacy count (the pairs within h at the moved
   positions that a fresh binning finds and the step-start stencil misses),
   and at the moved positions of its second iteration the four bodies of a
   PBF step under both kernels against their plain versions (counts exact,
   the kernels bit-equal), timed with their bound and instruction floor;
   ``pbf_2d.json`` for ``PBF_2D_STEPS`` steps on the CPU and on the card
   through both kernels (the kernels bit-equal every step, the CPU and the
   card within 1e-5 for ``PBF_2D_NN_STEPS``) and its bodies, the 2D walk,
   measured the same way; both walks on a 2D pile-up (about 450 neighbours
   a row, runs of 432 candidates across the staged tiles) and on the 3D
   pile-up under poly6, with ``nonpressure+rigid`` too;
8. the other methods in 2D and under poly6, PBF with implicit viscosity
   and shape matching: ``pbf_3d.json`` at full size under DFSPH, WCSPH,
   PCISPH and IISPH (3D poly6) and under PBF with implicit viscosity, a few
   steps through each kernel (gated, exact launch sets, iteration and CG
   counts printed, the two kernels' runs equal step for step); the 2D paths
   (``pbf_2d.json`` under DFSPH, WCSPH and IISPH; the small 2D domain box
   under DFSPH and with implicit viscosity) on the CPU and the card through
   both kernels (iteration counts equal every step, the kernels bit-equal,
   the card within 1e-5 of the CPU for the first steps); each new body
   instance of both kernels against its plain version on the state its
   path leaves, timed with its bound and instruction floor;
   ``coupling_dfsph.json`` under the shape-matching backend at full size
   (``SM_STEPS`` steps, touching pairs counted, bodies finite and rigid
   within 5%, a short run through the slab-window kernel), ``rigid_dem``
   measured there and the host synchronizations of one projection
   printed; then every body, rigid variant, contact and DEM pass of both
   kernels on the pile-ups of each new kind and dimension;
9. the spatial decomposition (``parallel/spatial.py``): at world size 1
   over NCCL in this process, the flagship cold under DFSPH, 3 decomposed
   steps through each pair kernel beside 3 single-device steps (sorted fluid
   positions bit-equal, iteration counts equal, overflow 0); both kernels
   on the extended layout (H sentinel rows at each end: -1 in front,
   ``num_cells`` at the back) against their plain versions, counts exact,
   and against each other; the gather's resort pack and unpack
   (``permute_pack``, ``permute_unpack``: the rows gathered straight into
   the send buffer and out of the received one), as rank 1 of 4 takes them,
   bit-equal to ``pack_words`` of ``index_select`` and to their plain
   versions (the unpack gives the rank's slice of the sorted state), timed
   as phase 4 times the gather, beside the gather alone, the gather plus a
   copy of the buffer and their bound; then 4
   ranks spawned on the one card over gloo (``parallel/launch.py``), the
   flagship, ``dragon_bath_dfsph.json`` and
   ``high_viscosity_implicit.json`` 3 steps each through the cell-list
   kernel, held to this process's single-device runs (fluid and body com
   bit-equal, body velocities within 1e-6, iteration and CG counts equal,
   no shortfall on any rank); the H, shortfall, backend, wall ms and
   launches of each run;
10. the offline pipeline on the card's host: ``native.available()``; the
   load times of ``dragon_bath_dfsph.json`` and ``high_viscosity_bunny.json``
   with the native inside test and with the numpy one (the same particles
   from both); the settled flagship from phase 6's checkpoint a few steps
   through the driver with its particle export on (counts zeroed just
   before, read just after), then ``surface_reconstruction_torch.py`` and
   ``render_torch.py`` on the frame it wrote (1,231,200 fluid particles):
   the OBJ has triangles, finite vertices inside the domain box and within
   the fluid's bound plus 2h, the PNG has the size asked for and pixels
   drawn; the scripts' host times, and ``blender_test_torch.py`` listing
   the card;
11. the step as one device program: on the flagship (DFSPH cold and warm
   through each kernel, WCSPH, PCISPH, IISPH from the prepared state, DFSPH
   cold and warm from phase 6's settled checkpoint), ``dragon_bath_dfsph``
   through the fluid's arrival, ``high_viscosity_implicit``, ``pbf_3d``,
   ``pbf_2d`` under DFSPH through its block's landing and
   ``buckling_emitter``: the same steps from the same state graphed
   (``Simulation.step``) and eager (``get_step_fn`` called directly), every
   state tensor and diagnostic bit-equal and the iteration and CG counts
   equal every step; ``Simulation.run`` under the sync debug mode set to
   raise; per path and mode the wall ms, device busy ms, idle share and
   kernels a step (``tools/profile_torch_step.py``), the warm-up step's and
   the capture's host ms and the device memory of the simulation, with the
   card line; the launch counts of replays against a profiler trace on two
   paths. Phase 4 checks the WHILE node's condition kernel against the
   host loop (``graph_while``);
12. one JSON line with every kernel record (its launches count phases 6's,
   8's, 9's and 10's runs too), the card line again, then the result.

Without a CUDA device, or outside a checkout of the repository, it fails
before printing any result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import shutil
import subprocess
import sys
import time
import warnings

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
# the timing rule and the bound, shared with tools/bench_gather.py
sys.path.append(os.path.join(ROOT, "tools"))
from cuda_timing import bound_ms, cuda_ms, led_ms, nbytes  # noqa: E402
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
FLAGSHIP_FLUID = 1231200
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
                "iisph_sum_i": 47, "rigid_contact": 5,
                # PBF (poly6/spiky from the distance: one sqrt, the kernel
                # form, its zero conditions); nonpressure@poly6 takes two
                # sqrt and two kernel forms in place of the cubic's rsqrt
                "pbf_density": 14, "pbf_lambda": 30, "pbf_fix": 40,
                "nonpressure@poly6": 62}
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
# the gather's timed runs: calls each, with the host's time per call (as
# every kernel here is timed) and behind a sleep on the stream, without it
PERMUTE_REPS = 20
PERMUTE_LED_REPS = 50
# the gather's other cases in phase 4: a 2D state of an odd row count
PERMUTE_2D_ROWS = 1_000_003
# phase 6, the driver at full size. The JAX bench's settle point: 0.75 s of
# simulated time, 1,250 steps at the flagship's dt of 0.6 ms (bench.py:19-21);
# the block hits the floor near step 265
SETTLE_STEPS = 1250
# the density solver must iterate more than once on each of the last steps
SETTLED_TAIL = 10
# steps from the settled checkpoint straight through, and in two halves
RESUME_STEPS = 20
# the settled regime per method and engine, from the settled checkpoint:
# steps to warm up, steps timed
SETTLED_WARMUP = 2
SETTLED_STEPS = 5
SETTLED_PATHS = (("DFSPH cold, cell-list kernel", {}),
                 ("DFSPH warm start, cell-list kernel", WARM),
                 ("DFSPH cold, slab-window kernel", SLAB),
                 ("DFSPH warm start, slab-window kernel", dict(WARM, **SLAB)),
                 ("WCSPH, cell-list kernel", dict(simulation_method="wcsph")),
                 ("PCISPH, cell-list kernel", dict(simulation_method="pcisph")),
                 ("IISPH, cell-list kernel", dict(simulation_method="iisph")))
# the settled states the kernels are checked on
SETTLED_MEASURED = ("DFSPH cold, cell-list kernel",
                    "DFSPH cold, slab-window kernel")
# dragon_bath at dt 2 ms: its fluid column reaches the dragons after about
# 0.6 s; the run ends at 0.8 s
DRAGON = "dragon_bath_dfsph.json"
DRAGON_STEPS = 400
# phase 7, PBF: pbf_3d.json at full size (468,000 fluid particles) through
# each kernel, steps per engine; pbf_2d.json on the CPU and the card
PBF_3D = "pbf_3d.json"
PBF_3D_FLUID = 468000
PBF_STEPS = {"pair_pass": 40, "pair_slab": 10}
PBF_2D = "pbf_2d.json"
PBF_2D_STEPS = 20
# the CPU and the card keep pbf_2d's fluid within NN_TOL for this many steps
# (a float32 rounding difference doubles about every step at its dt of
# 0.05 s; the CPU tests hold the port to the JAX package for 5 steps)
PBF_2D_NN_STEPS = 4
# the bodies of a PBF step: launches per step (one non-pressure pass, then
# the three passes in each of the 5 position iterations)
PBF_BODIES = ("nonpressure", "pbf_density", "pbf_lambda", "pbf_fix")
PBF_ITERS = 5
# phase 8, the other methods in 2D and under poly6, PBF with implicit
# viscosity and shape matching. pbf_3d.json (3D, poly6) per path: label,
# overrides, steps through the cell-list kernel, then through the
# slab-window kernel, and the bodies measured on the state it leaves (each
# body once: the first path that runs it)
KIND_3D_PATHS = (
    ("DFSPH cold", dict(simulation_method="dfsph"), 4, 2,
     ("density", "alpha", "divergence", "correction",
      "density_alpha_divergence")),
    ("WCSPH", dict(simulation_method="wcsph"), 3, 2, ("pressure",)),
    ("PCISPH", dict(simulation_method="pcisph"), 3, 2,
     ("pcisph_density_pred",)),
    ("IISPH", dict(simulation_method="iisph"), 3, 2,
     ("iisph_dii", "iisph_aii", "iisph_density_star", "iisph_dij_pj",
      "iisph_sum_i")),
    # the reference's common viscosity (its scene file has 0.0, where the
    # solve would have nothing to do)
    ("PBF, implicit viscosity", dict(viscosity_method="implicit",
                                     viscosity=0.05), 3, 2, VISCOUS_BODIES))
# 2D: label, scene (a file, or "box": the small 2D domain box), overrides,
# steps, steps the CPU and the card are held within NN_TOL for (pbf_2d's
# block falls freely until it lands in step 18), bodies measured. PCISPH
# under poly6 in 2D runs on no configuration a user reaches: pbf_2d.json
# divides by zero in its stiffness (no lattice point within h at that
# spacing, in both packages: tests/test_torch_kinds_steps_pbf2d.py), and a
# 2D scene at the 3D scenes' spacing is outside the poly6 kernel's range
# (the 3D form in every dimension, as the JAX package's: the 2D box's
# density starts at 10 rho0). Its instance is checked on the 2D pile-up.
KIND_2D_PATHS = (
    ("pbf_2d DFSPH", "pbf_2d.json", dict(simulation_method="dfsph"), 20, 10,
     ("density", "alpha", "divergence", "correction",
      "density_alpha_divergence")),
    ("pbf_2d WCSPH", "pbf_2d.json", dict(simulation_method="wcsph"), 20, 10,
     ("pressure",)),
    ("pbf_2d IISPH", "pbf_2d.json", dict(simulation_method="iisph"), 20, 10,
     ("iisph_dii", "iisph_aii", "iisph_density_star", "iisph_dij_pj",
      "iisph_sum_i")),
    ("2D box DFSPH", "box", {}, 20, 20,
     ("density", "alpha", "nonpressure", "divergence", "correction",
      "density_alpha_divergence", "rigid_volume")),
    # viscosity 500 (tests/test_torch_kinds_steps.py: at 2000 this box's CG
    # stalls at cg_max_iter in its second step)
    ("2D box DFSPH, implicit viscosity", "box",
     dict(viscosity_method="implicit", viscosity=500.0, viscosity_b=500.0),
     20, 20, VISCOUS_BODIES))
# shape matching on coupling_dfsph.json at full size: steps, and every how
# many steps the touching pairs are counted
SM_SCENE = "coupling_dfsph.json"
SM_STEPS = 300
SM_COUNT_EVERY = 50
# and a short run through the slab-window kernel
SM_SLAB_STEPS = 10
# the rigidity measure of tests/test_rigid.py:298-327: each dynamic body's
# largest and mean distance of its particles from their centroid, kept
# within this share
SM_RIGID_RTOL = 0.05
# operations per pair of the new instances (OPS_PER_PAIR counts the cubic 3D
# bodies): under poly6 each kernel form a body takes costs a sqrt and the
# zero conditions beyond the cubic's shared reciprocal root (4 more); in 2D
# the geometry is 5 operations (2 sub, 2 mul, 1 add) and a body saves its
# per-component operations once
KERNEL_FORMS = {"density": 1, "alpha": 1, "nonpressure": 2, "divergence": 1,
                "correction": 1, "density_alpha_divergence": 2,
                "rigid_volume": 1, "nonpressure_warm": 3, "pressure": 1,
                "pcisph_density_pred": 1, "iisph_dii": 1, "iisph_aii": 1,
                "iisph_density_star": 1, "iisph_dij_pj": 1, "iisph_sum_i": 1,
                "visc_prep": 1, "visc_matvec": 1}
POLY6_FORM_OPS = 4
GEOMETRY_OPS_2D = 5
PER_COMPONENT_OPS = {"density": 0, "alpha": 2, "nonpressure": 7,
                     "divergence": 3, "correction": 3,
                     "density_alpha_divergence": 5, "rigid_volume": 0,
                     "nonpressure_warm": 10, "pressure": 3,
                     "pcisph_density_pred": 3, "iisph_dii": 2, "iisph_aii": 6,
                     "iisph_density_star": 3, "iisph_dij_pj": 2,
                     "iisph_sum_i": 9, "visc_prep": 6, "visc_matvec": 4}
# phase 11, the step as one device program: (label, scene, overrides, start,
# steps) run graphed (Simulation.step, a replay) and eager (get_step_fn
# called directly) from the same state, "prepared" (load_scene +
# Simulation) or "settled" (phase 6's checkpoint of the flagship), held
# bit-equal step for step; dragon_bath_dfsph through the fluid's arrival
# (the first fluid force at step 192), pbf_2d through its block's landing
# (step 18); buckling_emitter for its peak memory (2,288,640 rows)
GRAPH_PATHS = (
    ("flagship DFSPH cold, cell-list", FLAGSHIP, {}, "prepared", 3),
    ("flagship DFSPH warm, cell-list", FLAGSHIP, WARM, "prepared", 3),
    ("flagship DFSPH cold, slab-window", FLAGSHIP, SLAB, "prepared", 3),
    ("flagship DFSPH warm, slab-window", FLAGSHIP, dict(WARM, **SLAB),
     "prepared", 3),
    ("flagship WCSPH", FLAGSHIP, dict(simulation_method="wcsph"), "prepared",
     3),
    ("flagship PCISPH", FLAGSHIP, dict(simulation_method="pcisph"),
     "prepared", 3),
    ("flagship IISPH", FLAGSHIP, dict(simulation_method="iisph"), "prepared",
     3),
    ("flagship settled DFSPH cold, cell-list", FLAGSHIP, {}, "settled", 4),
    ("flagship settled DFSPH warm, cell-list", FLAGSHIP, WARM, "settled", 4),
    ("dragon_bath_dfsph through the arrival",
     os.path.join(SCENES, "dragon_bath_dfsph.json"), {}, "prepared", 220),
    ("high_viscosity_implicit",
     os.path.join(SCENES, "high_viscosity_implicit.json"), {}, "prepared", 4),
    ("pbf_3d", os.path.join(SCENES, "pbf_3d.json"), {}, "prepared", 4),
    ("pbf_2d DFSPH", os.path.join(SCENES, "pbf_2d.json"),
     dict(simulation_method="dfsph"), "prepared", 20),
    ("buckling_emitter", os.path.join(SCENES, "buckling_emitter.json"), {},
     "prepared", 2))
# steps each mode is timed and profiled from the state the compared steps
# left, and replays run under the sync debug mode
GRAPH_MEASURE_STEPS = 5
GRAPH_RUN_STEPS = 3
# the path whose launch counts are held against a profiler trace of its
# replays, and one whose trace is printed beside its counts, a replay a
# trace: on the H100 its traces have missed a few kernels of a replay
# whose counts the CG's own iteration counts confirm (phase 3 holds the
# matvec's launches to them every step)
GRAPH_TRACED = ("flagship settled DFSPH cold, cell-list",)
GRAPH_TRACE_SHOWN = ("high_viscosity_implicit",)
# the condition kernel's check: iteration counts of a toy loop, and the
# iterations its replay is timed over
GRAPH_TOY_COUNTS = (0, 1, 37)
GRAPH_TOY_ITERS = 2000
GRAPH_WHILE_SOURCE = "sph_project_tpu_torch/csrc/graph_loop.cu"
# the JAX package's lax.while_loop the WHILE node stands for (no Pallas
# kernel: the loop of the density corrector, as the others)
GRAPH_WHILE_REPLACES = "sph_project_tpu/solvers/dfsph.py:427"

# rigid_dem: the material and object compares (3) on a pair, and on a
# touching one the distance (sqrt), the penetration, 1/max(dist, 1e-9), the
# normal speed (2D: 5, 3D: 8 with its product), the force's two terms and
# its clamp, its scale, and the dim sums
DEM_PAIR_OPS = 3
DEM_TOUCH_OPS = {3: 23, 2: 18}


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


def gather_times(kernel, plain, library, **more) -> dict:
    """The gather's times: ``ms``, ``plain_ms`` and ``library_ms`` back to
    back with the host's time per call, as every kernel here is timed;
    ``device_ms`` and ``library_device_ms`` behind a sleep on the stream,
    the device's time alone, and ``host_us``, the kernel wrapper's host time
    per call. Each of ``more`` is timed both ways too, as ``<name>_ms`` and
    ``<name>_device_ms``."""
    out = {"ms": cuda_ms(kernel, PERMUTE_REPS),
           "plain_ms": cuda_ms(plain, PERMUTE_REPS),
           "library_ms": cuda_ms(library, PERMUTE_REPS)}
    out["device_ms"], out["host_us"] = led_ms(kernel, PERMUTE_LED_REPS)
    out["library_device_ms"] = led_ms(library, PERMUTE_LED_REPS)[0]
    for name, fn in more.items():
        out[f"{name}_ms"] = cuda_ms(fn, PERMUTE_REPS)
        out[f"{name}_device_ms"] = led_ms(fn, PERMUTE_LED_REPS)[0]
    return out


def gather_text(t: dict) -> str:
    return (f"kernel {t['ms']:.4f} ms (device {t['device_ms']:.4f}, the "
            f"wrapper's host time {t['host_us']:.1f} us a call), plain "
            f"{t['plain_ms']:.4f} ms, index_select per field "
            f"{t['library_ms']:.4f} ms (device {t['library_device_ms']:.4f})")


def instruction_rate() -> float:
    """Instructions per second the card can start, counted per row (thread):
    multiprocessors x schedulers x 32 lanes x the highest SM clock."""
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits"],
                         capture_output=True, text=True, timeout=60, check=True)
    hz = float(out.stdout.strip()) * 1e6
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return sms * SCHEDULERS_PER_SM * 32 * hz


def work_of_rows(env, params, fields, produce):
    """(candidates tested, pairs inside the radius) over these rows, the
    candidates counted from the engine's own table: a row's 9 runs of the
    cell table, or its 9 pieces of its block's windows."""
    from sph_project_tpu_torch.ops import pair_kernels as pk
    from sph_project_tpu_torch.ops import pairs
    rows = torch.nonzero(produce).flatten()
    slab = pk.engine_of(env) == "pair_slab"
    ranges = pairs.window_pieces if slab else pairs.candidate_ranges
    cand = int(ranges(env, rows)[1].sum())
    cnt = pk.run_cuda("divergence", env, fields, params, produce,
                      flags=1)["cnt"]
    return cand, int(cnt.sum().item())


def rows_read(env, params, fields, produce) -> int:
    """The rows whose fields a pass over these producing rows needs: the
    rows themselves and every row within the radius of one. A pair is
    symmetric, so these are the rows that produce or have a producing
    neighbour: one plain pass over all rows, through the cell-list
    executor (the pairs of both engines are the same)."""
    from sph_project_tpu_torch.core.params import MATERIAL_NONE
    from sph_project_tpu_torch.ops import pairs
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


def box_2d_config() -> dict:
    """The 2D domain box of the CPU tests (tests/test_torch_kinds.py
    box2d_config): a 0.1 x 0.1 block thrown onto the floor of a 0.3 x 0.3
    box of static walls."""
    return {
        "Configuration": {
            "domainStart": [0, 0], "domainEnd": [0.3, 0.3],
            "addDomainBox": True, "particleRadius": 0.01, "density0": 1000,
            "gravitation": [0, -9.81], "simulationMethod": "dfsph",
            "viscosityMethod": "standard", "timeStepSize": 1e-3,
            "viscosity": 0.05, "viscosity_b": 0.03},
        "FluidBlocks": [{"objectId": 0, "start": [0.1, 0.08],
                         "end": [0.2, 0.18], "translation": [0, 0],
                         "scale": [1, 1], "velocity": [0.0, -2.5],
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
    walls = {"rigid_volume"} if params.has_rigid else set()
    if method == "pbf":
        out = {"nonpressure", *PBF_BODIES[1:], *walls}
        if implicit:
            out.update(VISCOUS_BODIES)
        return out
    if method == "dfsph":
        # the warm correction rides the non-pressure pass only with standard
        # viscosity
        np_body = "nonpressure_warm" if params.dfsph_warm_start and \
            not implicit else "nonpressure"
        out = {"density", "alpha", *walls, "divergence", v(np_body),
               v("correction"), v("density_alpha_divergence")}
    else:
        out = {*walls, "density", v("nonpressure"), v("pressure"),
               *(b for b in NEW_METHOD_BODIES[method] if b != "pressure")}
        if method == "pcisph":
            out.add("pressure")      # the prediction loop's, without wrench
    if rigid and params.rigid_solver == "shape_matching":
        out.add("rigid_dem")
    elif rigid and params.contact_channels:
        out.add("rigid_contact")
    if implicit:
        out.update(VISCOUS_BODIES)
    return out


def path_kind(scene: str, params) -> str:
    method = params.simulation_method
    if method == "dfsph":
        method = "dfsph warm" if params.dfsph_warm_start else "dfsph cold"
    return f"{scene[:-5]}: {method}"


def median(xs) -> float:
    return float(np.median(xs)) if len(xs) else float("nan")


def zero_counts() -> None:
    """Every launch count 0, the loop iterations of earlier replays
    dropped."""
    from sph_project_tpu_torch.ops import graph_loop
    from sph_project_tpu_torch.ops import pair_kernels as pk
    from sph_project_tpu_torch.ops import permute as permlib
    graph_loop.flush_launches()
    for k in pk.launches:
        pk.launches[k] = 0
    permlib.launches["permute"] = 0
    graph_loop.launches["graph_while"] = 0


def read_counts() -> dict:
    """The launch counts, the loop iterations of the replays so far added
    in (``graph_loop.flush_launches``)."""
    from sph_project_tpu_torch.ops import graph_loop
    from sph_project_tpu_torch.ops import pair_kernels as pk
    from sph_project_tpu_torch.ops import permute as permlib
    torch.cuda.synchronize()
    graph_loop.flush_launches()
    return dict(pk.launches, permute=permlib.launches["permute"],
                graph_while=graph_loop.launches["graph_while"])


def loops_on_device(params) -> bool:
    """Whether a graphed step of ``params`` has WHILE nodes, whose condition
    kernel (``graph_while``) then launches: the DFSPH, PCISPH and IISPH
    correctors and the implicit viscosity's CG."""
    from sph_project_tpu_torch import sim as simlib
    return simlib.graphed(params) and (
        params.simulation_method in ("dfsph", "pcisph", "iisph")
        or params.viscosity_method == "implicit")


def launch_keys(params, engine: str) -> set:
    """The launch keys (``pair_kernels.launch_key``: the kind and the
    dimension of ``params``) of the bodies a path of ``params`` launches."""
    from sph_project_tpu_torch.ops import pair_kernels as pk
    return {pk.launch_key(engine, b.split("+")[0],
                          pk.RIGID if b.endswith("+rigid") else 0,
                          params.kernel_type, params.dim)
            for b in expected_bodies(params)}


def check_launches(label: str, params, engine: str, launches: dict) -> None:
    """Every kernel of the path launched, and no other."""
    expected = launch_keys(params, engine)
    expected.add("permute")
    if loops_on_device(params):
        expected.add("graph_while")
    for k, v in launches.items():
        check((v > 0) == (k in expected),
              f"{label}: kernel {k} launched {v} times")


def check_band(label: str, log: list, rho0: float) -> float:
    """The per-step gates of a run through impact: the fluid count
    constant, overflow 0, and the JAX bench's band, density_avg within
    [0.72, 1.01] rho0 (bench.py:199). Returns the largest density_max, which
    no gate holds after impact: DFSPH bounds the mean density error, and the
    densest particle of a settled column passes 1.01 rho0 in the JAX package
    too (1028.02 in its settled flagship sample, BENCH_r04.json)."""
    for e in log:
        s = e["step"]
        check(e["fluid_num"] == log[0]["fluid_num"], f"{label}, step {s}: "
              f"fluid count {e['fluid_num']}")
        check(0.72 * rho0 <= e["density_avg"] <= 1.01 * rho0,
              f"{label}, step {s}: density_avg {e['density_avg']} outside "
              f"[0.72, 1.01] rho0")
        check(e["neighbor_overflow"] == 0 and e["sort_overflow"] == 0,
              f"{label}, step {s}: overflow")
    return max(e["density_max"] for e in log)


class WrenchProbe:
    """Within ``with``: for every step of a ``Simulation``, the magnitude of
    each dynamic body's accumulated SPH force, read before the rigid body
    step consumes it (the force of the fluid: gravity and contact enter
    inside the step). The probe in the body step writes it into a tensor
    (under a captured step the graph's, which each replay rewrites), and a
    copy of that tensor is kept after each step; read once at the end."""

    def __enter__(self):
        from sph_project_tpu_torch import sim as simlib
        from sph_project_tpu_torch.core.state import constant
        from sph_project_tpu_torch.rigid import integrator
        self.integrator, self.orig = integrator, integrator.rigid_body_step
        self.simlib, self.orig_step = simlib, simlib.Simulation.step
        self.forces, self.slot = [], None

        def probe(p, rigid, params, **kw):
            # the bodies' rows, a device constant (no copy under a capture)
            bodies = constant(tuple(params.contact_channels), torch.int64,
                              rigid.force.device)
            self.slot = rigid.force.index_select(0, bodies).norm(dim=1)
            return self.orig(p, rigid, params, **kw)

        def step(sim):
            diag = self.orig_step(sim)
            self.forces.append(self.slot.clone())
            return diag

        integrator.rigid_body_step = probe
        simlib.Simulation.step = step
        return self

    def __exit__(self, *exc):
        self.integrator.rigid_body_step = self.orig
        self.simlib.Simulation.step = self.orig_step

    def table(self) -> np.ndarray:
        """(steps, bodies) of force magnitudes, N."""
        return torch.stack(self.forces).cpu().numpy()


def driver_phase() -> dict:
    """Phase 6: the port's driver at full size, through the CLI
    (``sph_project_tpu_torch.cli.main``, what ``run_simulation_torch.py``
    runs) and the checkpoint module, checkpoints under ``build/smoke/``.
    Returns the launches of its paths, the simulations the kernel checks
    run on (the settled flagship under each engine, the post-impact
    ``dragon_bath`` under each engine) and the numbers it printed."""
    from sph_project_tpu_torch import bridge, cli
    from sph_project_tpu_torch import sim as simlib
    from sph_project_tpu_torch.io import checkpoint
    from sph_project_tpu_torch.ops import pair_kernels as pk
    from sph_project_tpu_torch.scene import load_scene

    out_root = os.path.join(ROOT, "build", "smoke")
    totals: dict = {}
    summary: dict = {}

    def add(launches):
        for k, v in launches.items():
            totals[k] = totals.get(k, 0) + v

    def run_cli(label, scene, args, out):
        """One CLI run in this process, counts zeroed just before it and
        read just after. Returns (simulation, JSONL entries)."""
        os.makedirs(out, exist_ok=True)
        log_path = os.path.join(out, "log.jsonl")
        argv = ["--scene_file", scene, "--no-export", "--quiet",
                "--output_dir", out, "--log_json", log_path, *args]
        zero_counts()
        t0 = time.perf_counter()
        sim = cli.main(argv)
        seconds = time.perf_counter() - t0
        launches = read_counts()
        add(launches)
        check_launches(label, sim.params, "pair_pass", launches)
        with open(log_path) as f:
            log = [json.loads(line) for line in f]
        peak = check_band(label, log, sim.params.density0)
        say(f"[6] {label}: run_simulation_torch {' '.join(argv)}: "
            f"{len(log)} steps in {seconds:.1f} s (load, prepare and "
            f"checkpoints included); largest density_max "
            f"{peak / sim.params.density0:.4f} rho0; launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}")
        return sim, log

    def iters_of(log):
        return [tuple(int(e[k]) for k in ("solver_iters", "div_iters")
                      if k in e) for e in log]

    # ---- 6a. the flagship through impact to the bench's settle point -----
    flag_out = os.path.join(out_root, "flagship")
    sim, log = run_cli(
        "flagship settle", FLAGSHIP,
        ["--steps", str(SETTLE_STEPS),
         "--checkpoint_interval", str(SETTLE_STEPS - 1)], flag_out)
    params = sim.params
    rho0, dt = params.density0, params.dt
    settled_ckpt = os.path.join(flag_out, "ckpt")
    check(int(sim.state.step_count) == SETTLE_STEPS, "flagship step count")
    it = iters_of(log)
    # impact: the first step whose densest particle passes rho0; the
    # density solver iterates more than once some steps later, when the
    # mean error passes its tolerance
    impact = next((e["step"] for e in log if e["density_max"] > rho0), None)
    iterating = next((s for s, (a, _) in enumerate(it) if a > 1), None)
    check(impact is not None and iterating is not None,
          "flagship: no impact, or the density solver never iterates")
    ms = [e["wall_ms"] for e in log]
    pre, post = median(ms[1:impact]), median(ms[iterating:])
    last = log[-1]
    say(f"[6] flagship: impact (density_max > rho0) at step {impact}, the "
        f"density solver first iterates more than once at step {iterating}; "
        f"median ms per step before impact {pre:.2f}, from that step on "
        f"{post:.2f}, over the last 250 steps {median(ms[-250:]):.2f}")
    for s in list(range(0, SETTLE_STEPS, 50)) + [SETTLE_STEPS - 1]:
        e = log[s]
        say(f"[6] flagship step {s}: {e['wall_ms']:.2f} ms, solver_iters "
            f"{it[s][0]} div_iters {it[s][1]} density_avg "
            f"{e['density_avg']:.3f} density_max {e['density_max']:.3f} "
            f"vel_max {e['vel_max']:.4f}")
    tail = it[-SETTLED_TAIL:]
    say(f"[6] flagship, last {SETTLED_TAIL} steps: (solver_iters, div_iters) "
        f"{tail}")
    check(all(a > 1 for a, _ in tail), f"flagship: the density solver "
          f"iterates once on a step among the last {SETTLED_TAIL}")
    # the JAX bench's gates at its settle point, as its physics_gates
    # applies them (bench.py:184-202): vel_max*dt at most one particle
    # diameter, density_avg within [0.72, 1.01] rho0 (its docstring's
    # [0.75, 0.90], bench.py:25, is not what it applies; its comment puts a
    # full hydrostatic settle near 0.94 rho0, bench.py:194-196)
    gate_avg = last["density_avg"] / rho0
    gate_cfl = last["vel_max"] * dt / params.particle_diameter
    say(f"[6] flagship at step {SETTLE_STEPS} (the bench's settle point, "
        f"{SETTLE_STEPS * dt:.2f} s): density_avg {gate_avg:.4f} rho0 "
        f"(gate [0.72, 1.01]), density_max "
        f"{last['density_max'] / rho0:.4f} rho0, vel_max*dt {gate_cfl:.4f} "
        f"particle diameters (gate <= 1)")
    check(0.72 <= gate_avg <= 1.01, f"settled density_avg {gate_avg} rho0")
    check(gate_cfl <= 1.0, f"settled vel_max*dt {gate_cfl} diameters")
    summary["flagship"] = dict(impact_step=impact, iterating_step=iterating,
                               ms_before=pre, ms_after=post, last_iters=tail,
                               density_avg_rho0=gate_avg, cfl=gate_cfl)
    del sim
    torch.cuda.empty_cache()

    # ---- 6b. resume: straight through against halves ----------------------
    half = SETTLE_STEPS + RESUME_STEPS // 2
    end = SETTLE_STEPS + RESUME_STEPS
    straight, log_s = run_cli(
        "resume, straight", FLAGSHIP,
        ["--resume", settled_ckpt, "--steps", str(end)],
        os.path.join(out_root, "straight"))
    _, log_a = run_cli(
        "resume, first half", FLAGSHIP,
        ["--resume", settled_ckpt, "--steps", str(half),
         "--checkpoint_interval", str(half - 1)],
        os.path.join(out_root, "half"))
    resumed, log_b = run_cli(
        "resume, second half", FLAGSHIP,
        ["--resume", os.path.join(out_root, "half", "ckpt"),
         "--steps", str(end)], os.path.join(out_root, "resumed"))
    check([e["step"] for e in log_a + log_b] == list(range(SETTLE_STEPS, end)),
          "resume: step numbers")
    check(iters_of(log_s) == iters_of(log_a + log_b),
          f"resume: iteration counts {iters_of(log_s)} vs "
          f"{iters_of(log_a + log_b)}")
    differ = [".".join(p) for (p, a), (_, b) in zip(
        bridge.walk(straight.state), bridge.walk(resumed.state))
        if not torch.equal(a, b)]
    check(not differ, f"resume: arrays differ from the run straight "
          f"through: {differ}")
    say(f"[6] resume: {RESUME_STEPS} steps from step {SETTLE_STEPS} straight "
        f"through equal {RESUME_STEPS // 2} steps, a checkpoint, a fresh "
        f"load_scene + Simulation, the restore and {RESUME_STEPS // 2} more, "
        f"bit for bit (every state array, positions and velocities "
        f"included); iterations {iters_of(log_s)}")
    del straight, resumed
    torch.cuda.empty_cache()

    # ---- 6c. the settled regime, per method and engine ---------------------
    kept = {}
    summary["settled"] = {}
    for label, overrides in SETTLED_PATHS:
        scene, state = load_scene(FLAGSHIP, **overrides)
        engine = "pair_slab" if overrides.get("pair_backend") == "pallas" \
            else "pair_pass"
        zero_counts()
        sim = simlib.Simulation(scene, state)
        sim.state = checkpoint.restore(settled_ckpt, sim.state, sim.params)
        for _ in range(SETTLED_WARMUP):
            sim.step()
        before = read_counts()
        ms, iters = [], []
        for _ in range(SETTLED_STEPS):
            t0 = time.perf_counter()
            d = sim.step()
            iters.append(tuple(int(d[k]) for k in ("solver_iters",
                                                   "div_iters") if k in d))
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
        launches = read_counts()
        add(launches)
        check_launches(f"settled {label}", sim.params, engine, launches)
        per_step = {k: (v - before[k]) / SETTLED_STEPS
                    for k, v in launches.items() if v - before[k]}
        say(f"[6] settled {label}: ms per step {[round(x, 2) for x in ms]} "
            f"(median {np.median(ms):.2f}), iterations {iters}; launches per "
            f"step {json.dumps(per_step)}")
        check(bool(torch.isfinite(sim.state.particles.pos).all()),
              f"settled {label}: positions not finite")
        summary["settled"][label] = dict(median_ms=float(np.median(ms)),
                                         iters=iters, launches=per_step)
        if label in SETTLED_MEASURED:
            kept[label] = sim
        del sim
        torch.cuda.empty_cache()

    # ---- 6d. dragon_bath through the fluid's arrival -----------------------
    dragon = os.path.join(SCENES, DRAGON)
    drag_out = os.path.join(out_root, "dragon_bath")
    with WrenchProbe() as probe:
        sim, log = run_cli(
            "dragon_bath", dragon,
            ["--steps", str(DRAGON_STEPS),
             "--checkpoint_interval", str(DRAGON_STEPS - 1)], drag_out)
    forces = probe.table()
    check(forces.shape == (DRAGON_STEPS, len(sim.params.contact_channels)),
          f"dragon_bath: {forces.shape[0]} rigid steps")
    hit = np.nonzero(forces.max(axis=1) > 0)[0]
    check(len(hit) > 0, "dragon_bath: no fluid force on a dragon")
    first = int(hit[0])
    it = np.array(iters_of(log))
    say(f"[6] dragon_bath: the first fluid force on a dragon at step {first} "
        f"({first * sim.params.dt:.3f} s); per body at that step "
        f"{forces[first].tolist()} N, at the last step "
        f"{forces[-1].tolist()} N; ms per step median "
        f"{median([e['wall_ms'] for e in log[1:first]]):.2f} before, "
        f"{median([e['wall_ms'] for e in log[first:]]):.2f} after, "
        f"{median([e['wall_ms'] for e in log[-50:]]):.2f} over the last 50 "
        f"steps; solver_iters mean {it[1:first, 0].mean():.2f} before, "
        f"{it[first:, 0].mean():.2f} after (most {it[:, 0].max()}); "
        f"iterations of the last steps {iters_of(log)[-5:]}")
    check(forces[-1].max() > 0, "dragon_bath: no fluid force in the last step")
    rigid = sim.state.rigid
    for oid in sim.params.contact_channels:
        body = {k: getattr(rigid, k)[oid].tolist()
                for k in ("com", "vel", "omega")}
        say(f"[6] dragon_bath body {oid} at step {DRAGON_STEPS}: " + ", ".join(
            f"{k} ({', '.join(f'{x:.6f}' for x in v)})"
            for k, v in body.items()))
        check(all(np.isfinite(v).all() for v in body.values()),
              f"dragon_bath: body {oid} state not finite")
    summary["dragon_bath"] = dict(first_wrench_step=first,
                                  last_force=forces[-1].tolist())
    del sim
    torch.cuda.empty_cache()
    # the post-impact state under each engine, for the kernel checks
    for engine, overrides in (("pair_pass", {}), ("pair_slab", SLAB)):
        scene, state = load_scene(dragon, **overrides)
        sim = simlib.Simulation(scene, state)
        sim.state = checkpoint.restore(os.path.join(drag_out, "ckpt"),
                                       sim.state, sim.params)
        check(pk.engine_of(sim.state.cached_neighbors) == engine,
              "dragon_bath: engine")
        kept[f"dragon_bath {engine}"] = sim
    return dict(launches=totals, sims=kept, summary=summary)


# phase 9, the spatial decomposition (``parallel/spatial.py``): steps per
# run, the ranks spawned on the one card, the scenes they run, and the body
# held against its plain version on the extended layout (its neighbour
# counts exact)
SPATIAL_STEPS = 3
SPATIAL_RANKS = 4
SPATIAL_SCENES = (("flagship", "large_scale_dfsph.json"),
                  ("dragon_bath", "dragon_bath_dfsph.json"),
                  ("high_viscosity", "high_viscosity_implicit.json"))
SPATIAL_BODY = "divergence"
# body velocities and angular velocities, decomposed against one device:
# the wrenches are all-reduced, so they add in another order
# (tests/test_spatial.py:145-153)
SPATIAL_BODY_TOL = 1e-6


def spatial_phase():
    """Phase 9: the spatial decomposition on the card. Returns its kernel
    records (the pair kernels on the extended layout, the gather's pack and
    unpack) and the launches of its decomposed runs, by kernel."""
    import torch.distributed as dist

    from sph_project_tpu_torch import sim as simlib
    from sph_project_tpu_torch.core.params import (MATERIAL_FLUID,
                                                   MATERIAL_NONE)
    from sph_project_tpu_torch.ops import neighbors as nblib
    from sph_project_tpu_torch.ops import pair_kernels as pk
    from sph_project_tpu_torch.ops import pairs
    from sph_project_tpu_torch.ops import permute as permlib
    from sph_project_tpu_torch.parallel import launch, spatial
    from sph_project_tpu_torch.scene import load_scene
    from sph_project_tpu_torch.solvers import common, viscosity_cg

    t_phase = time.perf_counter()
    run_dir = os.path.join(ROOT, "build", "smoke", "spatial")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    launches9 = {}

    def tally(counts):
        for k, v in counts.items():
            launches9[k] = launches9.get(k, 0) + v

    def sorted_fluid(pos, material):
        r = np.asarray(pos)[np.asarray(material) == MATERIAL_FLUID]
        return r[np.lexsort(r.T)]

    def steps_of(step, state, implicit):
        """SPATIAL_STEPS steps: (state, diagnostics, wall ms, CG
        iterations)."""
        diags, ms, cg = [], [], []
        for _ in range(SPATIAL_STEPS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            state, d = step(state)
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t0) * 1e3)
            diags.append({k: v.item() for k, v in d.items()})
            if implicit:
                cg.append(int(viscosity_cg.last_solve["cg_iters"]))
        return state, diags, ms, cg

    def single(scene_name, overrides):
        """The scene on one device: sorted fluid positions, the body table,
        diagnostics, wall ms and CG iterations of each step."""
        scene, state = load_scene(os.path.join(SCENES, scene_name),
                                  **overrides)
        sim = simlib.Simulation(scene, state)

        def step(_):
            return None, sim.step()

        zero_counts()
        _, diags, ms, cg = steps_of(
            step, None, scene.params.viscosity_method == "implicit")
        # the decomposed step is eager: its loops read their flags on the host
        kernels = {k for k, v in read_counts().items()
                   if v and k != "graph_while"}
        p, rigid = sim.state.particles, sim.state.rigid
        out = dict(fluid=sorted_fluid(p.pos.cpu(), p.material.cpu()),
                   rigid={k: getattr(rigid, k).cpu().numpy()
                          for k in ("com", "vel", "omega")},
                   diags=diags, ms=ms, cg=cg, kernels=kernels)
        del sim
        torch.cuda.empty_cache()
        return out

    def held(label, ref, diags, fluid, rigid, cg, launched):
        """A decomposed run against one device's: fluid bit-equal, counts
        equal, overflow 0, com bit-equal, vel and omega within
        SPATIAL_BODY_TOL, the CG's counts equal, and the same kernels
        launched."""
        ran = {k for k, v in launched.items() if v}
        check(ran == ref["kernels"], f"{label}: kernels {sorted(ran)}, one "
              f"device {sorted(ref['kernels'])}")
        check(fluid.shape == ref["fluid"].shape and
              np.array_equal(fluid, ref["fluid"]),
              f"{label}: fluid positions differ from one device's")
        for s, (a, b) in enumerate(zip(ref["diags"], diags)):
            check(b["neighbor_overflow"] == 0,
                  f"{label}, step {s}: neighbor_overflow {b['neighbor_overflow']}")
            for k in ("solver_iters", "div_iters"):
                check(a[k] == b[k], f"{label}, step {s}: {k} {b[k]}, one "
                      f"device {a[k]}")
        check(cg == ref["cg"], f"{label}: CG iterations {cg}, one device "
              f"{ref['cg']}")
        check(np.array_equal(rigid["com"], ref["rigid"]["com"]),
              f"{label}: body com differs")
        dv = max(float(np.abs(rigid[k] - ref["rigid"][k]).max())
                 for k in ("vel", "omega"))
        check(dv <= SPATIAL_BODY_TOL, f"{label}: body vel / omega off by {dv}")
        return dv

    # ---- 9a. world size 1, NCCL, in this process ---------------------------
    launch.init("nccl", 0, 1, os.path.join(run_dir, "store"))
    mesh = spatial.make_mesh()
    check(mesh.backend == "nccl" and mesh.device.type == "cuda",
          f"world size 1: backend {mesh.backend} on {mesh.device}")
    say(f"[9] world size 1: backend {mesh.backend}, {mesh.device}")
    ref = {}
    spatial_ms = {}
    kept = None
    for engine, overrides in (("pair_pass", {}), ("pair_slab", SLAB)):
        label = f"flagship DFSPH cold, {engine}"
        ref1 = single(SPATIAL_SCENES[0][1], overrides)
        scene, state = load_scene(os.path.join(SCENES, SPATIAL_SCENES[0][1]),
                                  **overrides)
        params = scene.params
        state = spatial.shard_state(simlib.prepare(state.to(mesh.device), params),
                                    mesh, params)
        step = spatial.spatial_step_fn(params, mesh)
        zero_counts()
        state, diags, ms, _ = steps_of(step, state, False)
        counts = read_counts()
        tally(counts)
        p = state.particles
        held(f"world size 1, {label}", ref1, diags,
             sorted_fluid(p.pos.cpu(), p.material.cpu()),
             {k: getattr(state.rigid, k).cpu().numpy()
              for k in ("com", "vel", "omega")}, [], counts)
        H = spatial.halo_width(params, params.n_pad)
        spatial_ms[(1, engine)] = ms
        say(f"[9] world size 1, {label}: {SPATIAL_STEPS} steps bit-equal to "
            f"one device (iterations "
            f"{[(d['solver_iters'], d['div_iters']) for d in diags]}, "
            f"overflow 0), H {H}; wall ms {[round(x, 2) for x in ms]}, one "
            f"device {[round(x, 2) for x in ref1['ms']]}; launches "
            f"{json.dumps({k: v for k, v in counts.items() if v})}")
        check(counts["permute"] == 4 * SPATIAL_STEPS and
              counts[f"{engine}/{SPATIAL_BODY}"] > 0,
              f"world size 1, {label}: launches {counts}")
        if engine == "pair_pass":
            ref["flagship"] = ref1
            kept = (state, params)
        del state, step
        torch.cuda.empty_cache()

    # ---- 9b. the kernels on the extended layout ----------------------------
    # the layout of the slab-window path (H whole blocks), which both
    # kernels take
    state, params = kept
    params_sp = dataclasses.replace(params, spmd_axis=mesh.axis, **SLAB)
    st = spatial.global_resort(state, params_sp, mesh)
    st, senv = spatial.SpatialPlumbing.neighbor_prep(st, params_sp)
    H, p = senv.halo, st.particles
    ext = spatial.extend_fields(
        {"pos": p.pos, "vel": p.vel, "rest_volume": p.rest_volume,
         "material": p.material}, H, mesh)
    cells = senv.inner.cells
    n_ext = cells.shape[0]
    check(n_ext == params.n_pad + 2 * H and bool((cells[:H] == -1).all())
          and bool((cells[-H:] == params.num_cells).all()),
          "the extended layout's sentinels")
    envs = {"pair_pass": pairs.make_pair_env(cells, senv.inner.produce,
                                             params),
            "pair_slab": senv.inner}
    records = []
    instr_per_s = instruction_rate()
    name, flags = SPATIAL_BODY, pk.COUNT
    fk = {k: ext[k] for k in pk.fields_of(name, flags)}
    outs = []
    for engine, env in envs.items():
        out_k = pk.run_cuda(name, env, fk, params, None, flags)
        out_p = pk.run_plain_body(name, env, fk, params, None, flags)
        torch.cuda.synchronize()
        err = 0.0
        for c in out_k:
            e = float((out_k[c] - out_p[c]).abs().max())
            err = max(err, e)
            if c == "cnt":
                check(e == 0.0, f"{engine}/{name} on the extended layout: "
                      f"neighbour counts differ")
            lim = TOL * max(1.0, float(out_p[c].abs().max()))
            check(e <= lim, f"{engine}/{name}.{c} on the extended layout: "
                  f"max error {e} > {lim}")
        check(not bool(out_k["cnt"][:H].any() or out_k["cnt"][-H:].any()),
              f"{engine}: a halo row produced")
        outs.append(out_k)
        ms = cuda_ms(lambda: pk.run_cuda(name, env, fk, params, None, flags),
                     20)
        plain_ms = cuda_ms(lambda: pk.run_plain_body(
            name, env, fk, params, None, flags), 1, warm_up=False)
        tests, npairs = work_of_rows(env, params, ext, env.produce)
        read = rows_read(env, params, ext, env.produce)
        table = ((env.starts, env.lens, env.cells) if engine == "pair_slab"
                 else (env.cells, env.cell_start))
        n_bytes = pass_bytes(fk, read, table, len(out_k), n_ext)
        n_ops = npairs * (GEOMETRY_OPS + OPS_PER_PAIR[name])
        b_ms, b_by = bound_ms(n_bytes, n_ops)
        floor_ms = (tests * TEST_INSTR + n_ops) / instr_per_s * 1e3
        say(f"[9] {engine}/{name} on the extended layout ({n_ext} rows, H "
            f"{H} sentinel rows at each end): max_abs_err {err:.3e}, counts "
            f"exact; kernel {ms:.3f} ms, plain {plain_ms:.3f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}), instruction floor {floor_ms:.4f} ms, "
            f"{tests / max(npairs, 1):.2f} candidates per pair")
        records.append(dict(
            name=f"{engine}/{name}@spatial", route="cuda",
            source=ENGINES[engine][0], replaces=ENGINES[engine][1],
            launches=0, max_abs_err=err, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
            issue_floor_ms=floor_ms, tests_per_pair=tests / max(npairs, 1),
            state=f"flagship after {SPATIAL_STEPS} spatial steps, halo-"
                  f"extended at world size 1"))
    check(all(torch.equal(outs[0][c], outs[1][c]) for c in outs[0]),
          "the two pair kernels differ on the extended layout")
    del st, senv, p, ext, envs, fk, outs

    # ---- 9c. the gather's pack and unpack ----------------------------------
    # rank 1 of SPATIAL_RANKS on the flagship's state advanced as a step
    # advances it before its second resort: what it packs from its rows, and
    # what it unpacks from the rows the others send it, which must be its
    # slice of the globally sorted state
    p = common.enforce_domain_boundary(
        common.update_fluid_position(state.particles, state.rigid, params),
        params)
    keys, extras = simlib.permuted_keys(params)
    arrays = {k: getattr(p, k) for k in keys}
    arrays.update({k: getattr(state, k) for k in extras})
    arrays["cells"] = nblib.flat_cell_ids(p.pos, p.material != MATERIAL_NONE,
                                          params)
    n, r, D = params.n_pad, 1, SPATIAL_RANKS
    nl = n // D
    perm = nblib.sort_permutation(arrays["cells"])
    send_idx, send_counts, recv_counts, inv = spatial.resort_plan(
        arrays["cells"], r, D)
    mine = perm[r * nl:(r + 1) * nl]
    order = torch.sort(torch.div(mine, nl, rounding_mode="floor"),
                       stable=True).indices
    local = {k: v[r * nl:(r + 1) * nl].contiguous() for k, v in arrays.items()}
    received = {k: v[mine[order]].contiguous() for k, v in arrays.items()}
    words = permlib.pack_words(received)
    # the packed kernel, its plain version, the gather alone and the gather
    # with the buffer's copy (the resort before the packed kernel)
    pack = dict(
        kernel=lambda: permlib.permute_pack_cuda(send_idx, local),
        plain=lambda: permlib.permute_pack_plain(send_idx, local),
        gather=lambda: permlib.permute_fields_cuda(send_idx, local),
        gather_and_copy=lambda: permlib.pack_words(
            permlib.permute_fields_cuda(send_idx, local)),
        idx=send_idx, src=local)
    unpack = dict(
        kernel=lambda: permlib.permute_unpack_cuda(inv, words, received),
        plain=lambda: permlib.permute_unpack_plain(inv, words, received),
        gather=lambda: permlib.permute_fields_cuda(inv, received),
        gather_and_copy=lambda: permlib.permute_fields_cuda(
            inv, permlib.unpack_words(words, received)),
        idx=inv, src=received)
    lib = {k: torch.index_select(v, 0, send_idx) for k, v in local.items()}
    sorted_rows = {k: v[mine] for k, v in arrays.items()}
    out_k, out_p = pack["kernel"](), pack["plain"]()
    torch.cuda.synchronize()
    check(out_k.dtype == torch.int32 and
          torch.equal(out_k, permlib.pack_words(lib)) and
          torch.equal(out_k, out_p),
          "pack: not bit-equal to pack_words of index_select")
    out_k, out_p = unpack["kernel"](), unpack["plain"]()
    torch.cuda.synchronize()
    for k in arrays:
        check(out_k[k].dtype == arrays[k].dtype and
              torch.equal(out_k[k].view(torch.int32),
                          sorted_rows[k].view(torch.int32)) and
              torch.equal(out_k[k].view(torch.int32),
                          torch.index_select(received[k], 0, inv).view(
                              torch.int32)) and
              torch.equal(out_k[k].view(torch.int32),
                          out_p[k].view(torch.int32)),
              f"unpack {k}: not rank {r}'s sorted rows")
    del lib, sorted_rows, out_k, out_p
    for tag, case in (("pack", pack), ("unpack", unpack)):
        idx, src = case["idx"], case["src"]
        t = gather_times(case["kernel"], case["plain"],
                         lambda: [torch.index_select(v, 0, idx)
                                  for v in src.values()],
                         gather=case["gather"],
                         gather_and_copy=case["gather_and_copy"])
        n_bytes = 2 * nbytes(src.values()) + nbytes([idx])
        b_ms, b_by = bound_ms(n_bytes, 0)
        say(f"[9] permute, resort {tag} (rank {r} of {D}: {nl} rows, "
            f"{len(src)} fields, one (n, "
            f"{sum(v[0].numel() for v in src.values())}) int32 buffer; sends "
            f"{send_counts}, receives {recv_counts}): bit-equal to "
            f"index_select and to the plain version; {gather_text(t)}; the "
            f"gather alone {t['gather_ms']:.4f} ms (device "
            f"{t['gather_device_ms']:.4f}), the gather and the buffer's copy "
            f"{t['gather_and_copy_ms']:.4f} ms (device "
            f"{t['gather_and_copy_device_ms']:.4f}); bound {b_ms:.4f} ms "
            f"({b_by}: {n_bytes / 1e6:.1f} MB)")
        records.append(dict(
            name=f"permute@{tag}", route="cuda",
            source="sph_project_tpu_torch/csrc/permute.cu",
            replaces=PERMUTE_REPLACES, launches=0, max_abs_err=0.0,
            bound_ms=b_ms, bound_by=b_by, fields=len(src), **t))
    del pack, unpack, words
    del state, kept, p, arrays, local, received, perm, mine, order
    torch.cuda.empty_cache()
    dist.destroy_process_group()

    # ---- 9d. world size SPATIAL_RANKS on the one card, gloo ----------------
    for key, scene_name in SPATIAL_SCENES[1:]:
        ref[key] = single(scene_name, {})
    cases = [dict(name=key, scene=os.path.join(SCENES, scene_name),
                  overrides={}, steps=SPATIAL_STEPS)
             for key, scene_name in SPATIAL_SCENES]
    t0 = time.perf_counter()
    launch.launch("sph_project_tpu_torch.parallel.launch:run_cases",
                  SPATIAL_RANKS, dict(cases=cases,
                                      out_dir=os.path.join(run_dir, "out")),
                  os.path.join(run_dir, "ranks"), backend="gloo",
                  device="cuda", timeout=400)
    say(f"[9] world size {SPATIAL_RANKS} on one card (spawned ranks): "
        f"{time.perf_counter() - t0:.1f} s with start-up")
    for key, scene_name in SPATIAL_SCENES:
        res = launch.gather_results(os.path.join(run_dir, "out"), key,
                                    SPATIAL_RANKS)
        rows, ranks = res["rows"], res["ranks"]
        for rk, rr in enumerate(ranks):
            check(rr["backend"] == "gloo" and not rr["foreign"] and
                  rr["shortfall"] == 0 and rr["diags"] == ranks[0]["diags"],
                  f"{key}, rank {rk}: backend {rr['backend']}, foreign "
                  f"{rr['foreign']}, shortfall {rr['shortfall']}")
            tally(rr["launches"])
        launched = {k: sum(rr["launches"].get(k, 0) for rr in ranks)
                    for k in ranks[0]["launches"]}
        dv = held(f"world size {SPATIAL_RANKS}, {scene_name}", ref[key],
                  ranks[0]["diags"],
                  sorted_fluid(rows["particles.pos"],
                               rows["particles.material"]),
                  {k: rows[f"rigid.{k}"] for k in ("com", "vel", "omega")},
                  ranks[0]["cg_iters"], launched)
        ms = [max(rr["ms"][s] for rr in ranks) for s in range(SPATIAL_STEPS)]
        spatial_ms[(SPATIAL_RANKS, key)] = ms
        check(launched.get("permute", 0) == 4 * SPATIAL_STEPS * SPATIAL_RANKS
              and launched.get(f"pair_pass/{SPATIAL_BODY}", 0) > 0,
              f"{key}: launches {launched}")
        say(f"[9] world size {SPATIAL_RANKS}, {scene_name} (n_pad "
            f"{ranks[0]['n_pad']}): {SPATIAL_STEPS} steps bit-equal to one "
            f"device (iterations "
            f"{[(d['solver_iters'], d['div_iters']) for d in ranks[0]['diags']]}"
            f", CG {ranks[0]['cg_iters']}, body vel / omega within {dv:.1e});"
            f" backend gloo; H per rank {[rr['H'] for rr in ranks]}, "
            f"shortfall per rank {[rr['shortfall'] for rr in ranks]}; wall ms "
            f"(slowest rank) {[round(x, 1) for x in ms]}, one device "
            f"{[round(x, 2) for x in ref[key]['ms']]}; launches (all ranks) "
            f"{json.dumps(launched)}")
    for rec in records:
        key = "permute" if rec["name"].startswith("permute@") \
            else rec["name"].split("@")[0]
        # a resort is one pack and one unpack
        rec["launches"] = launches9.get(key, 0) // (
            2 if key == "permute" else 1)
        check(rec["launches"] > 0, f"{rec['name']}: no launch in phase 9")
    say("[9] wall ms of a decomposed step, median after the first: " +
        "; ".join(f"world size {ws}, {k}: {median(ms[1:]):.2f}"
                  for (ws, k), ms in spatial_ms.items()))
    say(f"[9] phase 9: {time.perf_counter() - t_phase:.1f} s; launches of "
        f"the spatial runs {json.dumps({k: v for k, v in launches9.items() if v})}")
    return records, launches9


# phase 10, the offline pipeline on the card's host: the settled flagship
# (phase 6's checkpoint) a few steps through the driver with its particle
# export on, then surface_reconstruction_torch.py and render_torch.py on the
# frame it wrote
OFFLINE_STEPS = 5
# the export cadence (the scene's outputInterval): of the steps after the
# resume, step SETTLE_STEPS is the one whose frame is written
OFFLINE_INTERVAL = 10
# the surface grid's cell in particle radii (the script's --grid-scale). The
# preview renderer draws one triangle at a time in Python, and a frame's
# triangles grow as the inverse square of the cell: the script's default of
# 1 radius would make nine times as many, and their render would not fit
# the run's time (PERF.md §5)
OFFLINE_GRID_SCALE = 3.0
# the preview camera: the whole domain box in view
OFFLINE_SIZE = (800, 600)
OFFLINE_EYE = (4.25, 5.0, 11.0)
OFFLINE_TARGET = (4.25, 0.8, 1.0)
# the scripts' defaults: particle radius (the flagship's) and the kernel
# support in radii; the surface lies within the fluid's bound plus 2h
OFFLINE_RADIUS = 0.01
OFFLINE_SMOOTHING = 3.5
# the preview renderer's background (io/render3d.py)
RENDER_BG = (20, 20, 26)
# the scenes whose load fills meshes (geometry/mesh.py fill_lattice), timed
# with the native inside test and with the numpy one
MESH_SCENES = ("dragon_bath_dfsph.json", "high_viscosity_bunny.json")


def rounded(x) -> list:
    return [round(float(v), 4) for v in x]


def png_pixels(path: str) -> np.ndarray:
    """(H, W, 3) uint8 of a PNG written by ``io/exporters.write_png`` (one
    IDAT, 8-bit RGB, filter 0 on every row)."""
    import struct
    import zlib
    with open(path, "rb") as f:
        data = f.read()
    check(data[:8] == b"\x89PNG\r\n\x1a\n", f"{path}: not a PNG")
    pos, chunks = 8, {}
    while pos < len(data):
        n, tag = struct.unpack(">I4s", data[pos:pos + 8])
        chunks[tag] = chunks.get(tag, b"") + data[pos + 8:pos + 8 + n]
        pos += 12 + n
    w, h, depth, kind = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    check((depth, kind) == (8, 2), f"{path}: not 8-bit RGB")
    rows = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    rows = rows.reshape(h, 1 + 3 * w)
    check(bool((rows[:, 0] == 0).all()), f"{path}: a filtered row")
    return rows[:, 1:].reshape(h, w, 3)


def offline_phase(card: str) -> dict:
    """Phase 10: the offline pipeline on the card's host. The native
    helpers' library; the two mesh scenes' load times with each inside test
    (the same particles from both); the settled flagship
    ``OFFLINE_STEPS`` steps through the driver with its particle export on
    (counts zeroed just before, read just after, every kernel of the path
    launched); the surface and the preview render of the frame it wrote
    through the root scripts, checked by their files and printed lines.
    Returns the launches of its run."""
    from sph_project_tpu_torch import cli, native
    from sph_project_tpu_torch.core.params import (MATERIAL_FLUID,
                                                   MATERIAL_RIGID)
    from sph_project_tpu_torch.geometry import mesh
    from sph_project_tpu_torch.io.exporters import read_ply
    from sph_project_tpu_torch.scene import load_scene

    t_phase = time.perf_counter()
    ok = native.available()
    say(f"[10] native.available() {ok} ({os.path.relpath(native.LIB_PATH, ROOT)}"
        f"{'' if ok else ': ' + str(native.load_error())}); {card}")
    check(ok, f"the native library does not load: {native.load_error()}")

    # ---- the scene build's inside test: native and numpy ------------------
    for name in MESH_SCENES:
        seconds, built = {}, {}
        for mode in ("native", "numpy"):
            saved = native.mesh_inside
            if mode == "numpy":
                native.mesh_inside = mesh.inside_lattice
            try:
                t0 = time.perf_counter()
                scene, state = load_scene(os.path.join(SCENES, name))
                seconds[mode] = time.perf_counter() - t0
            finally:
                native.mesh_inside = saved
            m = state.particles.material
            built[mode] = (scene.params.n_pad, int((m == MATERIAL_FLUID).sum()),
                           int((m == MATERIAL_RIGID).sum()),
                           state.particles.pos)
        counts = {k: v[:3] for k, v in built.items()}
        check(counts["native"] == counts["numpy"],
              f"{name}: the inside tests fill other counts {counts}")
        check(counts["native"][1:] == COUNTS[name][:2],
              f"{name} particle counts {counts['native'][1:]}")
        check(torch.equal(built["native"][3], built["numpy"][3]),
              f"{name}: the inside tests place other particles")
        n_pad, n_fluid, n_rigid = counts["native"]
        say(f"[10] load_scene {name} (host time): native inside test "
            f"{seconds['native']:.3f} s, numpy {seconds['numpy']:.3f} s; "
            f"n_pad {n_pad}, {n_fluid} fluid + {n_rigid} rigid particles "
            f"from both, positions equal; {card}")
        del built, scene, state

    # ---- frames from the card: the settled flagship with export on --------
    out = os.path.join(ROOT, "build", "smoke", "offline")
    shutil.rmtree(out, ignore_errors=True)
    frames = os.path.join(out, "frames")
    os.makedirs(frames)
    with open(FLAGSHIP) as f:
        cfg = json.load(f)
    cfg["Configuration"].update(exportPly=True, exportFrame=True,
                                outputInterval=OFFLINE_INTERVAL)
    scene_file = os.path.join(out, "large_scale_dfsph_export.json")
    with open(scene_file, "w") as f:
        json.dump(cfg, f, indent=1)
    argv = ["--scene_file", scene_file, "--quiet", "--output_dir", frames,
            "--resume", os.path.join(ROOT, "build", "smoke", "flagship",
                                     "ckpt"),
            "--steps", str(SETTLE_STEPS + OFFLINE_STEPS),
            "--log_json", os.path.join(out, "log.jsonl")]
    zero_counts()
    t0 = time.perf_counter()
    sim = cli.main(argv)
    seconds = time.perf_counter() - t0
    launches = read_counts()
    check_launches("offline export", sim.params, "pair_pass", launches)
    check(int(sim.state.step_count) == SETTLE_STEPS + OFFLINE_STEPS,
          "offline export: step count")
    del sim
    torch.cuda.empty_cache()
    frame_dir = os.path.join(frames, f"{SETTLE_STEPS:06d}")
    check(sorted(os.listdir(frames)) == [f"{SETTLE_STEPS:06d}"],
          f"offline export: frames {sorted(os.listdir(frames))}")
    check(sorted(os.listdir(frame_dir)) == ["particle_object_0.ply",
                                            "raw_view.png"],
          f"offline export: files {sorted(os.listdir(frame_dir))}")
    pts = read_ply(os.path.join(frame_dir, "particle_object_0.ply"))
    check(pts.shape == (FLAGSHIP_FLUID, 3) and
          bool(np.isfinite(pts).all()),
          f"offline export: the PLY holds {pts.shape} particles")
    p_lo, p_hi = pts.min(axis=0), pts.max(axis=0)
    say(f"[10] run_simulation_torch {' '.join(argv)}: {OFFLINE_STEPS} steps "
        f"from the settled checkpoint in {seconds:.1f} s (load, prepare, "
        f"restore and the export included); frame {SETTLE_STEPS:06d}: "
        f"{len(pts)} fluid particles, bound {rounded(p_lo)} - {rounded(p_hi)}; "
        f"launches "
        f"{json.dumps({k: v for k, v in launches.items() if v})}")

    # ---- the root scripts on that frame ------------------------------------
    def script(name, *args):
        cmd = [sys.executable, os.path.join(ROOT, name), "--input_dir",
               frames, "--num_workers", "1", *args]
        t0 = time.perf_counter()
        r = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                           timeout=600)
        secs = time.perf_counter() - t0
        say(f"[10] {' '.join(os.path.relpath(c, ROOT) if c.startswith(ROOT) else c for c in cmd[1:])}: "
            f"exit {r.returncode} in {secs:.1f} s (host time); printed "
            f"{r.stdout.strip()!r}; {card}")
        check(r.returncode == 0, f"{name}: exit {r.returncode}: "
              f"{r.stderr[-2000:]}")
        check("FAILED" not in r.stdout and
              r.stdout.split() == ["done", frame_dir],
              f"{name}: printed {r.stdout!r}")
        return secs

    t_surface = script("surface_reconstruction_torch.py",
                       "--radius", str(OFFLINE_RADIUS), "--smoothing-length",
                       str(OFFLINE_SMOOTHING), "--grid-scale",
                       str(OFFLINE_GRID_SCALE))
    obj = os.path.join(frame_dir, "particle_object_0_surface.obj")
    check(os.path.exists(obj), "surface: no OBJ written")
    verts, faces = mesh.load_obj(obj)
    h = OFFLINE_SMOOTHING * OFFLINE_RADIUS
    v_lo, v_hi = verts.min(axis=0), verts.max(axis=0)
    dom_lo = np.asarray(cfg["Configuration"]["domainStart"], np.float64)
    dom_hi = np.asarray(cfg["Configuration"]["domainEnd"], np.float64)
    say(f"[10] surface: {len(faces)} triangles, {len(verts)} vertices, "
        f"bound {rounded(v_lo)} - {rounded(v_hi)} (the fluid's bound +- 2h: "
        f"{rounded(p_lo - 2 * h)} - {rounded(p_hi + 2 * h)}; the domain box "
        f"{dom_lo.tolist()} - {dom_hi.tolist()})")
    check(len(faces) > 0 and len(verts) == 3 * len(faces),
          "surface: no triangles")
    check(bool(np.isfinite(verts).all()), "surface: vertices not finite")
    check(bool((v_lo >= dom_lo).all() and (v_hi <= dom_hi).all()),
          "surface: a vertex outside the domain box")
    # rounding slack: the OBJ's vertices are float32 written as text
    slack = 1e-4 * OFFLINE_RADIUS
    check(bool((v_lo >= p_lo - 2 * h - slack).all()
               and (v_hi <= p_hi + 2 * h + slack).all()),
          "surface: wider than the fluid's bound plus 2h")

    t_render = script("render_torch.py", "--size", *map(str, OFFLINE_SIZE),
                      "--eye", *map(str, OFFLINE_EYE),
                      "--target", *map(str, OFFLINE_TARGET))
    png = os.path.join(frame_dir, "render.png")
    check(os.path.exists(png), "render: no PNG written")
    img = png_pixels(png)
    check(img.shape == (OFFLINE_SIZE[1], OFFLINE_SIZE[0], 3),
          f"render: image of {img.shape}, not {OFFLINE_SIZE}")
    drawn = float((img != np.uint8(RENDER_BG)).any(axis=-1).mean())
    say(f"[10] render: {img.shape[1]} x {img.shape[0]} PNG, "
        f"{drawn:.4f} of its pixels drawn (not background)")
    check(drawn > 0, "render: every pixel is background")

    r = subprocess.run([sys.executable, os.path.join(ROOT,
                                                     "blender_test_torch.py")],
                       cwd=ROOT, capture_output=True, text=True, timeout=300)
    check(r.returncode == 0, f"blender_test_torch.py: {r.stderr[-2000:]}")
    listing = r.stdout.strip().splitlines()
    say("[10] blender_test_torch.py: " + " | ".join(x.strip() for x in listing))
    check(f"cuda:0: {torch.cuda.get_device_name(0)}" in r.stdout,
          "blender_test_torch.py: the card is not listed")

    say(f"[10] offline pipeline on one full-size flagship frame (host "
        f"times): surface {t_surface:.1f} s, preview render {t_render:.1f} s "
        f"(grid {OFFLINE_GRID_SCALE} radii, {OFFLINE_SIZE[0]} x "
        f"{OFFLINE_SIZE[1]}); phase 10: {time.perf_counter() - t_phase:.1f} "
        f"s; {card}")
    return launches


def graph_while_record(card: str) -> dict:
    """The condition kernel (``csrc/graph_loop.cu``) against its plain
    version, the host loop: a toy loop ``i < k`` (``i + 1``) captured and
    replayed, and run on the host, for each k of GRAPH_TOY_COUNTS; iteration
    counts and carries must agree. Timed as an iteration of the WHILE node
    (the condition kernel, the test, the add and the copy back, on the
    card) against an iteration of the host loop (the same kernels and one
    read of the flag). Returns its kernel record (launches 0: the main
    paths' are added by the caller)."""
    from sph_project_tpu_torch.ops import graph_loop

    def toy(k):
        """The loop's function; its tensors stay alive with it (a graph
        reads them at every replay)."""
        limit = torch.full((), k, dtype=torch.int32, device="cuda")
        start = torch.zeros((), dtype=torch.int32, device="cuda")
        acc = torch.zeros(8, device="cuda")

        def run():
            return graph_loop.while_loop(
                lambda c: c[0] < limit,
                lambda c: (c[0] + 1, c[1] + 0.5), (start, acc))
        return run

    err = 0.0
    with graph_loop.uncounted():
        for k in GRAPH_TOY_COUNTS:
            fn = toy(k)
            graph, counts, out = graph_loop.capture(fn)
            graph.replay()
            graph.replay()
            plain = fn()
            torch.cuda.synchronize()
            # the condition kernel's count of the iterations of both replays
            iters = int(counts.loops[0][0]) // 2
            err = max(err, abs(iters - k), abs(int(out[0]) - int(plain[0])),
                      float((out[1] - plain[1]).abs().max()))
            check(iters == k and int(out[0]) == k,
                  f"graph_while: {iters} iterations for {k}")
            del graph, counts, out
        fn = toy(GRAPH_TOY_ITERS)
        graph, counts, _ = graph_loop.capture(fn)
        ms = cuda_ms(graph.replay, 5) / GRAPH_TOY_ITERS
        plain_ms = cuda_ms(fn, 2) / GRAPH_TOY_ITERS
        del graph, counts, fn
    # the kernel reads the flag (4 bytes) and reads and writes the count (8)
    b_ms, b_by = bound_ms(20, 0)
    say(f"[4] graph_while (the WHILE node's condition kernel): iteration "
        f"counts and carries of the toy loop equal to the host loop's for "
        f"k in {list(GRAPH_TOY_COUNTS)} (max_abs_err {err}); an iteration "
        f"{ms * 1e3:.3f} us in a replay, {plain_ms * 1e3:.3f} us on the host "
        f"loop, bound {b_ms:.2e} ms ({b_by}); {card}")
    return dict(name="graph_while", route="cuda", source=GRAPH_WHILE_SOURCE,
                replaces=GRAPH_WHILE_REPLACES, launches=0, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None)


def traced_launches(counted: dict, trace) -> tuple:
    """(launch counts, kernels a profiler trace saw) of the pair kernels,
    the gather and the condition kernel."""
    seen = {"pair": 0, "permute": 0, "graph_while": 0}
    for e in trace.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        if "pair_kernel<" in e.name or "slab_kernel<" in e.name:
            seen["pair"] += 1
        elif "permute_kernel" in e.name:
            seen["permute"] += 1
        elif "while_cond_kernel" in e.name:
            seen["graph_while"] += 1
    want = {"pair": sum(v for k, v in counted.items()
                        if k.startswith("pair_")),
            "permute": counted["permute"],
            "graph_while": counted["graph_while"]}
    return want, seen


def settled_checkpoint() -> str:
    """Phase 6's checkpoint of the flagship at the bench's settle point,
    made here through the driver if no run made it yet."""
    from sph_project_tpu_torch import cli
    out = os.path.join(ROOT, "build", "smoke", "flagship")
    ckpt = os.path.join(out, "ckpt")
    if not os.path.exists(os.path.join(ckpt, "state.npz")):
        cli.main(["--scene_file", FLAGSHIP, "--no-export", "--quiet",
                  "--output_dir", out, "--steps", str(SETTLE_STEPS),
                  "--checkpoint_interval", str(SETTLE_STEPS - 1)])
    return ckpt


def graph_phase(card: str) -> dict:
    """Phase 11: the step as one device program. For each of GRAPH_PATHS:
    the captured step's replays and the eager step from the same state,
    every state tensor and diagnostic bit-equal and the iteration and CG
    counts equal every step; ``Simulation.run`` under the sync debug mode
    (an error on any synchronisation); wall, device busy, idle share and
    kernels a step of both modes (``tools/profile_torch_step.py``
    ``measure``), the warm-up step's and the capture's host ms, the
    device memory the simulation holds (its state and graph pools) and the
    peak of its construction, and of the eager steps. On GRAPH_TRACED the
    launch counts of replays are held against a profiler trace; on
    GRAPH_TRACE_SHOWN both are printed, a replay a trace. Returns the
    numbers by path."""
    from torch.profiler import ProfilerActivity, profile

    import profile_torch_step as prof
    from sph_project_tpu_torch import sim as simlib
    from sph_project_tpu_torch.io import checkpoint
    from sph_project_tpu_torch.scene import load_scene
    from sph_project_tpu_torch.solvers import viscosity_cg

    t_phase = time.perf_counter()
    gib = 2.0 ** 30
    ckpt = settled_checkpoint()
    prof.attach_profiler()
    out = {}

    def bits(t):
        return t.view(torch.int32) if t.dtype == torch.float32 else t

    def same(a, b):
        return a.shape == b.shape and torch.equal(bits(a), bits(b))

    def cg(params):
        return (int(viscosity_cg.last_solve["cg_iters"]),) \
            if params.viscosity_method == "implicit" else ()

    for label, scene_file, overrides, start, steps in GRAPH_PATHS:
        t0 = time.perf_counter()
        scene, state = load_scene(scene_file, **overrides)
        params = scene.params
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        base_reserved = torch.cuda.memory_reserved()
        sim = simlib.Simulation(scene, state)
        check(sim._graph is not None, f"{label}: the step was not captured")
        if start == "settled":
            sim.state = checkpoint.restore(ckpt, sim.state, params)
        torch.cuda.synchronize()
        build_peak = (torch.cuda.max_memory_allocated() - base) / gib
        torch.cuda.empty_cache()
        held = (torch.cuda.memory_reserved() - base_reserved) / gib
        step_fn = simlib.get_step_fn(params)
        eager = simlib._cloned(sim.state)
        iters = []
        for s in range(steps):
            dg = sim.step()
            cg_g = cg(params)
            eager, de = step_fn(eager)
            cg_e = cg(params)
            check(set(dg) == set(de) and all(same(dg[k], de[k]) for k in de),
                  f"{label}, step {s}: diagnostics differ: "
                  f"{[k for k in de if not same(dg[k], de[k])]}")
            differ = [".".join(p) for (p, a), (_, b) in zip(
                simlib._tensors(sim.state), simlib._tensors(eager))
                if not same(a, b)]
            check(not differ, f"{label}, step {s}: graphed and eager states "
                  f"differ in {differ}")
            its = tuple(int(dg[k]) for k in ("solver_iters", "div_iters")
                        if k in dg)
            check(its == tuple(int(de[k]) for k in ("solver_iters",
                                                    "div_iters") if k in de)
                  and cg_g == cg_e, f"{label}, step {s}: iterations "
                  f"{its + cg_g} vs {cg_e}")
            iters.append(its + cg_g)
        del eager
        torch.cuda.set_sync_debug_mode("error")
        try:
            ran = sim.run(GRAPH_RUN_STEPS)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check(all(v.shape == (GRAPH_RUN_STEPS,) for v in ran.values()),
              f"{label}: run({GRAPH_RUN_STEPS}) diagnostics")
        check(bool(torch.isfinite(sim.state.particles.pos).all()),
              f"{label}: positions not finite")
        # both modes timed and profiled from the state the runs left
        from_here = simlib._cloned(sim.state)
        implicit = params.viscosity_method == "implicit"
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        m_e = prof.measure(prof.eager_step(params, from_here),
                           GRAPH_MEASURE_STEPS, implicit)
        eager_peak = (torch.cuda.max_memory_allocated() - base) / gib
        m_g = prof.measure(prof.graphed_step(sim, from_here),
                           GRAPH_MEASURE_STEPS, implicit)
        check(m_e["iters"] == m_g["iters"], f"{label}: measured steps "
              f"iterate differently: {m_e['iters']} vs {m_g['iters']}")
        if label in GRAPH_TRACED + GRAPH_TRACE_SHOWN:
            per = 1 if label in GRAPH_TRACE_SHOWN else GRAPH_MEASURE_STEPS
            sim.state = from_here
            for r in range(GRAPH_MEASURE_STEPS // per):
                zero_counts()
                with profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA]) as trace:
                    for _ in range(per):
                        sim.step()
                    torch.cuda.synchronize()
                want, seen = traced_launches(read_counts(), trace)
                if label in GRAPH_TRACED:
                    check(seen == want, f"{label}: launch counts {want} "
                          f"against the profiler's kernels {seen}")
                say(f"[11] {label}: launch counts of {per} replay(s) "
                    f"{want}, the profiler's kernel trace {seen}"
                    f"{' (held equal)' if label in GRAPH_TRACED else ''}")
        rec = dict(
            steps=steps, iters=iters, warmup_ms=sim.warmup_ms,
            capture_ms=sim.capture_ms, held_gib=held, build_peak_gib=build_peak,
            eager_peak_gib=eager_peak,
            **{f"{mode}_{k}": m[k] for mode, m in (("eager", m_e),
                                                   ("graphed", m_g))
               for k in ("wall_ms_per_step", "profiled_wall_ms_per_step",
                         "busy_ms_per_step", "idle_share",
                         "kernels_per_step")},
            measured_iters=m_g["iters"])
        out[label] = rec
        say(f"[11] {label}: {steps} steps graphed and eager bit-equal "
            f"(state, diagnostics, iterations {iters}); run("
            f"{GRAPH_RUN_STEPS}) with no host synchronisation; warm-up "
            f"step {sim.warmup_ms:.1f} ms, capture {sim.capture_ms:.1f} ms; "
            f"memory held {held:.3f} GiB (state and graph pools), peak "
            f"{build_peak:.3f} GiB building it, eager steps' peak "
            f"{eager_peak:.3f} GiB; per step over {GRAPH_MEASURE_STEPS} "
            f"(iterations {m_g['iters']}): graphed wall "
            f"{m_g['wall_ms_per_step']:.3f} ms (profiled run "
            f"{m_g['profiled_wall_ms_per_step']:.3f}), busy "
            f"{m_g['busy_ms_per_step']:.3f} ms, idle "
            f"{m_g['idle_share']:.3f}, {m_g['kernels_per_step']:.1f} kernels; "
            f"eager wall {m_e['wall_ms_per_step']:.3f} ms (profiled run "
            f"{m_e['profiled_wall_ms_per_step']:.3f}), busy "
            f"{m_e['busy_ms_per_step']:.3f} ms, idle "
            f"{m_e['idle_share']:.3f}, {m_e['kernels_per_step']:.1f} kernels "
            f"({time.perf_counter() - t0:.1f} s; {card})")
        del sim, from_here
        torch.cuda.empty_cache()
    say(f"[11] phase 11: {time.perf_counter() - t_phase:.1f} s; "
        f"{json.dumps(out)}")
    return out


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
    from sph_project_tpu_torch.ops import graph_loop
    from sph_project_tpu_torch.ops import neighbors as nblib
    from sph_project_tpu_torch.ops import pair_kernels as pk
    from sph_project_tpu_torch.ops import pairs
    from sph_project_tpu_torch.ops import permute as permlib
    from sph_project_tpu_torch.rigid import integrator
    from sph_project_tpu_torch.rigid import shape_matching as smlib
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
        zero_counts()
        t0 = time.perf_counter()
        sim = simlib.Simulation(scene, state)
        torch.cuda.synchronize()
        say(f"[3] {label}: prepare (sort, rigid volumes"
            f"{', density, alpha' if params.simulation_method == 'dfsph' else ''}"
            f"), the warm-up step ({sim.warmup_ms:.1f} ms) and the capture "
            f"({sim.capture_ms:.1f} ms) on {sim.device}: "
            f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
        implicit = params.viscosity_method == "implicit"
        step_ms = []
        fluid_num = 0
        for s in range(steps):
            before = dict(pk.launches)
            t0 = time.perf_counter()
            d = sim.step()
            torch.cuda.synchronize()
            step_ms.append((time.perf_counter() - t0) * 1e3)
            graph_loop.flush_launches()
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
                cg = int(viscosity_cg.last_solve["cg_iters"])
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
        launches = read_counts()
        last_step = {k: v - before[k] for k, v in pk.launches.items()}
        say(f"[3] {label}: launches {json.dumps({k: v for k, v in launches.items() if v})}"
            f"; in the last step {json.dumps({k: v for k, v in last_step.items() if v})}")
        check(pk.engine_of(sim.state.cached_neighbors) == engine,
              f"{label}: engine")
        check_launches(label, params, engine, launches)
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
        # PBF's bodies run in phase 7, the poly6 and the 2D instances in
        # phases 7 and 8, the DEM pass in phase 8
        if "@" not in k and "/pbf_" not in k and not k.endswith("/rigid_dem"):
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

        dim = params.dim
        kappa = seeded(rng.uniform(-50.0, 200.0, n))
        pressure = seeded(rng.uniform(0.0, 5000.0, n))
        fluid = (p.material == MATERIAL_FLUID)[:, None]
        shift = seeded(rng.normal(0.0, 0.1 * params.particle_radius, (n, dim)))
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
                "dii": seeded(rng.normal(0.0, 1e-2, (n, dim))),
                "dij_pj": seeded(rng.normal(0.0, 10.0, (n, dim))),
                "x": torch.where(fluid, p.vel + seeded(
                    rng.normal(0.0, 0.1, (n, dim))), torch.zeros_like(p.vel))}

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

    def check_engine(sim, bodies, where=None):
        """``bodies`` of the engine of ``sim``'s environment against their
        plain versions on ``sim``'s state; appends the records. With
        ``where`` (a state of phase 6) the kernel is checked and timed, and
        neither the plain version's time nor a record is taken."""
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
        tag = f"[6] {where}," if where else "[4]"
        for k, (cand, npairs) in work_of.items():
            say(f"{tag} {engine}, {k} rows: {cand} candidates tested, {npairs} "
                f"pairs inside the radius ({cand / max(npairs, 1):.2f} "
                f"candidates per pair)")
        table = ((env.starts, env.lens, env.cells) if slab
                 else (env.cells, env.cell_start))
        if slab:
            width = env.lens.sum(1)[env.produce.view(-1, env.block).any(1)]
            say(f"{tag} {engine}: {env.nb} blocks of {env.block} rows, "
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
            plain_ms = None if where else cuda_ms(plain, 1, warm_up=False) \
                if slab else cuda_ms(plain, 2)
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
            if where:
                say(f"[6] {where}, {engine}/{name}: max_abs_err {err:.3e}, "
                    f"kernel {ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}), "
                    f"instruction floor {floor_ms:.4f} ms, "
                    f"{tests / max(npairs, 1):.2f} candidates per pair")
                continue
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
                say(f"{tag} pair_slab vs pair_pass, {name}: largest difference "
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

    def gather_held(tag, perm, arrays):
        """The gather, its pack and its unpack (the fields packed as the
        resort packs them) on the card, each bit-equal to its plain version
        and to ``index_select``, dtypes kept."""
        lib = {k: torch.index_select(v, 0, perm) for k, v in arrays.items()}
        words = permlib.pack_words(arrays)
        outs = {"gather": (permlib.permute_fields_cuda(perm, arrays),
                           permlib.permute_fields_plain(perm, arrays)),
                "unpack": (permlib.permute_unpack_cuda(perm, words, arrays),
                           permlib.permute_unpack_plain(perm, words, arrays))}
        packed = permlib.permute_pack_cuda(perm, arrays)
        torch.cuda.synchronize()
        check(torch.equal(packed, permlib.pack_words(lib)) and
              torch.equal(packed, permlib.permute_pack_plain(perm, arrays)),
              f"{tag}: the pack is not bit-equal")
        for use, (out_k, out_p) in outs.items():
            for k in arrays:
                check(out_k[k].dtype == arrays[k].dtype and
                      torch.equal(out_k[k].view(torch.int32),
                                  lib[k].view(torch.int32)) and
                      torch.equal(out_k[k].view(torch.int32),
                                  out_p[k].view(torch.int32)),
                      f"{tag}: {use} of {k} not bit-equal")

    def check_permute(sim):
        """The fused gather on the next step's sort of ``sim``'s state:
        advance positions as the step does, then bin. Returns its numbers,
        and the fields and the permutation."""
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
        gather_held(f"permute, {len(arrays)} fields", perm, arrays)
        t = gather_times(
            lambda: permlib.permute_fields_cuda(perm, arrays),
            lambda: permlib.permute_fields_plain(perm, arrays),
            lambda: [torch.index_select(v, 0, perm) for v in arrays.values()])
        n_bytes = 2 * nbytes(arrays.values()) + nbytes([perm])
        b_ms, b_by = bound_ms(n_bytes, 0)
        say(f"[4] permute: {len(arrays)} fields "
            f"({sum(v[0].numel() for v in arrays.values())} words a row), "
            f"{moved} of {n} rows move; the gather, its pack and its unpack "
            f"bit-equal to their plain versions and to index_select; "
            f"{gather_text(t)}, bound {b_ms:.4f} ms ({b_by}: "
            f"{n_bytes / 1e6:.1f} MB)")
        return dict(fields=len(arrays), max_abs_err=0.0, bound_ms=b_ms,
                    bound_by=b_by, **t), arrays

    def check_permute_cases(arrays):
        """The gather's other cases: the flagship's fields under a uniformly
        random permutation, and a 2D state (2-word ``pos`` and ``vel``, the
        flagship's other fields) of an odd row count under a near-identity
        and a random permutation, from a numpy seed."""
        n = next(iter(arrays.values())).shape[0]
        rng = np.random.default_rng(12)
        rand = torch.from_numpy(rng.permutation(n)).cuda()
        gather_held("permute, random permutation", rand, arrays)
        m = PERMUTE_2D_ROWS
        state_2d = {}
        for k, v in arrays.items():
            shape = (m,) + ((2,) if k in ("pos", "vel") else tuple(v.shape[1:]))
            bits = rng.integers(-2 ** 31, 2 ** 31, shape, dtype=np.int64)
            state_2d[k] = torch.from_numpy(bits.astype(np.int32)).cuda().view(
                v.dtype)
        near = np.argsort(np.arange(m) + 2.5 * rng.random(m), kind="stable")
        for label, perm in (("near-identity", near), ("random",
                                                     rng.permutation(m))):
            gather_held(f"permute, 2D state of {m} rows, {label}",
                        torch.from_numpy(perm).cuda(), state_2d)
        say(f"[4] permute: the flagship's {len(arrays)} fields under a random "
            f"permutation of {n} rows, and a 2D state of {m} rows (2-word pos "
            f"and vel) under a near-identity and a random permutation: the "
            f"gather, its pack and its unpack bit-equal to their plain "
            f"versions and to index_select")


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
                    measure, phase=4):
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
        n_rf = count_pairs(env, params, fields, dyn_rows, fluid_j)
        n_touch = count_pairs(env, params, fields, dyn_rows, touching_j)
        say(f"[{phase}] {where}, {engine}: {n_rf} pairs of a dynamic rigid row "
            f"and a fluid neighbour (the wrench pairs), {n_touch} touching "
            f"pairs of two bodies with a contact channel")
        if measure:
            cand_all, pairs_all = work_of_rows(env, params, fields, produce_all)
            cand_dyn, pairs_dyn = work_of_rows(env, params, fields, dyn_rows)
            _, pairs_moved = work_of_rows(env, params, moved, dyn_rows)
            read_all = rows_read(env, params, fields, produce_all)
            read_dyn = rows_read(env, params, fields, dyn_rows)
            read_moved = rows_read(env, params, moved, dyn_rows)
            say(f"[4] {where}, {engine}: {int(dyn_rows.sum())} dynamic rigid "
                f"rows; contact pass: {cand_dyn} candidates tested, "
                f"{pairs_dyn} pairs inside the radius; rows whose fields a pass reads: {read_all} of the variants' "
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
            say(f"[{phase}] {where}, {engine}/{rec}: max_abs_err {err:.3e} "
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
        return n_rf, n_touch

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

    def check_rigid_scene(sim, where="dragon_bath", measure=True, phase=4):
        """The rigid-body variants on a coupled scene's state."""
        st, params = sim.state, sim.params
        p = st.particles
        env = st.cached_neighbors
        fields = pair_fields(sim)
        fields.update(is_dynamic=p.is_dynamic, com=st.rigid.com.contiguous(),
                      chan=integrator.channel_table(st.rigid, params))
        dyn_rows = integrator.dynamic_rigid_mask(p, st.rigid, params)
        return check_rigid(where, params, env, fields, env.produce, dyn_rows,
                           params.dt, measure=measure, phase=phase)

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
    cold_rec, cold_arrays = check_permute(cold_sim)
    warm_rec, _ = check_permute(slab_sim)
    check_permute_cases(cold_arrays)
    del cold_arrays
    records.append(dict(
        name="permute", route="cuda",
        source="sph_project_tpu_torch/csrc/permute.cu",
        replaces=PERMUTE_REPLACES, launches=total_launches["permute"],
        **cold_rec, warm_path=warm_rec))
    records.append(dict(graph_while_record(card),
                        launches=total_launches["graph_while"]))
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
                    + ((int(viscosity_cg.last_solve["cg_iters"]),
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

    # ---- 6. the driver at full size, and the kernels on its states ---------
    t0 = time.perf_counter()
    driven = driver_phase()
    kept = driven["sims"]
    for label in SETTLED_MEASURED:
        check_engine(kept.pop(label), DFSPH_BODIES, where=f"settled {label}")
        torch.cuda.empty_cache()
    for engine in pk.ENGINES:
        n_rf, _ = check_rigid_scene(kept.pop(f"dragon_bath {engine}"),
                                    where="dragon_bath after impact",
                                    measure=False, phase=6)
        check(n_rf > 0, "dragon_bath after impact: no wrench pairs")
        torch.cuda.empty_cache()
    # the records count every launch of the main paths, phase 6's included
    for rec in records:
        if not rec["name"].endswith("@moved"):
            rec["launches"] += driven["launches"].get(rec["name"], 0)
    say(f"[6] driver phase and its kernel checks: "
        f"{time.perf_counter() - t0:.1f} s; "
        f"{json.dumps(driven['summary'], default=float)}")

    def pbf_fields(p, dens, lam):
        return {"pos": p.pos, "vel": p.vel, "material": p.material,
                "mass": p.mass, "rest_volume": p.rest_volume,
                "inv_rho": common._inv_rho(p), "density": dens, "lam": lam,
                "is_dynamic": p.is_dynamic, "object_id": p.object_id}

    def pbf_count(env, params, fields, produce):
        """Neighbour counts at ``fields["pos"]`` over ``env``, per row."""
        return pk.run_cuda("pbf_density", env, fields, params, produce,
                           flags=pk.COUNT)["cnt"]

    def fresh_env(params, pos, fields, produce):
        """A pair environment binned on ``pos`` itself: the rows sorted by
        their cells at ``pos``; returns (env, sorted fields, produce)."""
        cells = nblib.flat_cell_ids(pos, fields["material"] != MATERIAL_NONE,
                                    params)
        perm = nblib.sort_permutation(cells)
        moved = {k: v[perm].contiguous() for k, v in fields.items()}
        env = pairs.make_pair_env(cells[perm].contiguous(), produce[perm],
                                  params)
        return env, moved, produce[perm].contiguous()

    def check_pbf_bodies(tag, params, envs, fields, produce, launches,
                         measure=True):
        """The bodies of a PBF step under both kernels on one state (the
        moved positions in ``fields["pos"]``) against their plain versions,
        neighbour counts exact, the two kernels bit-equal; with ``measure``
        the times, the bound and a record per body and engine."""
        outs = {}
        for engine, env in envs.items():
            slab = engine == "pair_slab"
            if measure:
                rows = torch.nonzero(produce).flatten()
                ranges = pairs.window_pieces if slab else pairs.candidate_ranges
                tests = int(ranges(env, rows)[1].sum())
                npairs = int(pbf_count(env, params, fields, produce).sum())
                read = rows_read(env, params, fields, produce)
                table = ((env.starts, env.lens, env.cells) if slab
                         else (env.cells, env.cell_start))
            for body in PBF_BODIES:
                flags = pk.COUNT if body == "pbf_density" else 0
                fk = {k: fields[k] for k in pk.fields_of(body, flags)}

                def kernel(e=env):
                    return pk.run_cuda(body, e, fk, params, produce, flags)

                def plain():
                    return pk.run_plain_body(body, env, fk, params, produce,
                                             flags)

                out_k, out_p = kernel(), plain()
                torch.cuda.synchronize()
                err = 0.0
                for c in out_k:
                    e = float((out_k[c] - out_p[c]).abs().max())
                    err = max(err, e)
                    if c == "cnt":
                        check(e == 0.0, f"{tag}, {engine}/{body}: counts differ")
                    lim = TOL * max(1.0, float(out_p[c].abs().max()))
                    check(e <= lim, f"{tag}, {engine}/{body}.{c}: max error "
                          f"{e} > {lim}")
                outs[(engine, body)] = out_k
                key = pk.params_key(engine, body, params)
                say(f"[7] {tag}, {key}: max_abs_err {err:.3e}"
                    f"{', counts exact' if 'cnt' in out_k else ''}")
                if not measure:
                    continue
                ms = cuda_ms(kernel, 20)
                plain_ms = cuda_ms(plain, 1, warm_up=False) if slab \
                    else cuda_ms(plain, 2)
                opk = f"{body}@poly6" if body == "nonpressure" else body
                n_ops = npairs * (GEOMETRY_OPS + OPS_PER_PAIR[opk])
                n_bytes = pass_bytes(fk, read, table, len(out_k), params.n_pad)
                b_ms, b_by = bound_ms(n_bytes, n_ops)
                floor_ms = (tests * TEST_INSTR + n_ops) / instr_per_s * 1e3
                say(f"[7] {tag}, {key}: kernel {ms:.3f} ms, plain "
                    f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}: "
                    f"{n_bytes / 1e6:.1f} MB, {n_ops / 1e9:.4f} Gop), "
                    f"instruction floor {floor_ms:.4f} ms, {tests} candidates "
                    f"tested, {npairs} pairs, launches {launches.get(key, 0)}")
                records.append(dict(
                    name=key, route="cuda", source=ENGINES[engine][0],
                    replaces=ENGINES[engine][1], launches=launches.get(key, 0),
                    max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None, issue_floor_ms=floor_ms,
                    tests_per_pair=tests / max(npairs, 1),
                    launches_per_step={
                        "pbf": PBF_ITERS if body != "nonpressure" else 1}))
        for body in PBF_BODIES:
            a, b = outs[("pair_slab", body)], outs[("pair_pass", body)]
            diff = max(float((a[c] - b[c]).abs().max()) for c in a)
            check(diff == 0.0, f"{tag}: the two pair kernels are not "
                  f"bit-equal on {body}: {diff}")
        say(f"[7] {tag}: the two kernels bit-equal on {', '.join(PBF_BODIES)}")

    def pbf_phase():
        """Phase 7: PBF. pbf_3d.json at full size through each kernel (exact
        launch counts per step), its bodies at the moved positions of one
        iteration against their plain versions with the candidacy count,
        pbf_2d.json on the CPU and the card, and both walks on a 2D pile-up
        and on the 3D one under poly6."""
        from sph_project_tpu_torch.solvers import pbf as pbflib
        launches3: dict = {}
        kept = None
        for engine, steps in PBF_STEPS.items():
            over = SLAB if engine == "pair_slab" else {}
            t0 = time.perf_counter()
            scene, state = load_scene(os.path.join(SCENES, PBF_3D), **over)
            params = scene.params
            n_fluid = int((state.particles.material == MATERIAL_FLUID).sum())
            check(n_fluid == PBF_3D_FLUID and params.dim == 3
                  and params.kernel_type == "poly6", f"{PBF_3D} parameters")
            zero_counts()
            sim = simlib.Simulation(scene, state)
            torch.cuda.synchronize()
            say(f"[7] {PBF_3D}, {engine}: {n_fluid} fluid particles, n_pad "
                f"{params.n_pad}, grid {params.grid_num}, h "
                f"{params.support_radius}, dt {params.dt}, pbfCorrK "
                f"{params.pbf_corr_k}; loaded and prepared in "
                f"{time.perf_counter() - t0:.1f} s")
            step_ms = []
            want = {pk.params_key(engine, b, params):
                    PBF_ITERS if b != "nonpressure" else 1 for b in PBF_BODIES}
            want["permute"] = 1
            for s in range(steps):
                before = read_counts()
                t1 = time.perf_counter()
                d = sim.step()
                torch.cuda.synchronize()
                step_ms.append((time.perf_counter() - t1) * 1e3)
                got = {k: v - before[k] for k, v in read_counts().items()
                       if v - before[k]}
                check(got == want, f"{PBF_3D}, {engine}, step {s}: launches "
                      f"{got}, not {want}")
                p = sim.state.particles
                fl = p.material == MATERIAL_FLUID
                check(bool(torch.isfinite(p.pos).all()),
                      f"{PBF_3D}, step {s}: positions not finite")
                check(int(d["neighbor_overflow"]) == 0
                      and int(d["sort_overflow"]) == 0,
                      f"{PBF_3D}, step {s}: overflow")
                check(int(d["fluid_num"]) == n_fluid, f"step {s}: fluid count")
                say(f"[7] step {s}: {step_ms[-1]:.2f} ms density min "
                    f"{float(p.density[fl].min()):.3f} avg "
                    f"{float(d['density_avg']):.3f} max "
                    f"{float(d['density_max']):.3f} vel_max*dt "
                    f"{float(d['vel_max']) * params.dt:.5f} m "
                    f"({float(d['vel_max']) * params.dt / params.particle_diameter:.3f}"
                    f" particle diameters)")
            for k, v in read_counts().items():
                if v:
                    launches3[k] = launches3.get(k, 0) + v
            say(f"[7] {PBF_3D}, {engine}: {steps} steps, mean "
                f"{np.mean(step_ms):.2f} ms, after the first "
                f"{np.mean(step_ms[1:]):.2f} ms, median "
                f"{median(step_ms[1:]):.2f} ms; launches exact every step "
                f"({json.dumps(want)})")
            if engine == "pair_pass":
                kept = sim
            del sim
            torch.cuda.empty_cache()

        # (b) the bodies at the moved positions of one iteration, on the
        # state the cell-list steps left: the step's sort and non-pressure
        # pass, the advection, then the first iteration
        sim, params = kept, kept.params
        st, env = simlib.Plumbing.neighbor_prep(sim.state, params)
        p, rigid = simlib.Plumbing.non_pressure_acceleration(
            st.particles, st.rigid, env, st, params)
        p = common.update_fluid_velocity(p, params)
        p = common.update_fluid_position(p, rigid, params)
        p = common.enforce_domain_boundary(p, params, MATERIAL_FLUID)
        fluid = p.material == MATERIAL_FLUID
        for it in range(PBF_ITERS):
            dens = pbflib.compute_density_moving(p, env, params, fluid)
            lam = pbflib.compute_lambda(p, dens, env, params, fluid)
            f = pbf_fields(p, dens, lam)
            kept_n = int(pbf_count(env, params, f, fluid).sum())
            fenv, fmoved, fprod = fresh_env(params, p.pos, f, fluid)
            all_n = int(pbf_count(fenv, params, fmoved, fprod).sum())
            say(f"[7] candidacy, iteration {it}: {all_n} pairs within h at "
                f"the moved positions (a fresh binning), {kept_n} in the "
                f"step-start stencil: (a) {all_n - kept_n} missed "
                f"({(all_n - kept_n) / max(all_n, 1):.3%})")
            check(all_n >= kept_n, "candidacy: the stencil kept more pairs")
            if it == 1:
                fields1 = f
            dx = pbflib.fix_position(p, lam, env, params, fluid)
            p = p.replace(pos=p.pos + dx, density=dens)
        envs = {"pair_pass": pairs.make_pair_env(env.cells, env.produce, params),
                "pair_slab": pairs.make_slab_env(env.cells, env.produce, params)}
        check_pbf_bodies(f"{PBF_3D} iteration 1", params, envs, fields1, fluid,
                         launches3)
        del kept, sim, st, env, envs, p, fields1, f, fenv, fmoved
        torch.cuda.empty_cache()

        # (c) pbf_2d on the CPU and the card, 20 steps each (the card through
        # both kernels)
        runs = {}
        launches2: dict = {}
        for dev, be in (("cpu", "pallas_dma"), ("cuda", "pallas_dma"),
                        ("cuda", "pallas")):
            scene, state = load_scene(os.path.join(SCENES, PBF_2D),
                                      pair_backend=be)
            zero_counts()
            sim2 = simlib.Simulation(scene, state, device=dev)
            pos = []
            for _ in range(PBF_2D_STEPS):
                d = sim2.step()
                sp = sim2.state.particles
                pos.append(sp.pos[sp.material == MATERIAL_FLUID].cpu().clone())
            if dev == "cuda":
                for k, v in read_counts().items():
                    if v:
                        launches2[k] = launches2.get(k, 0) + v
            runs[(dev, be)] = pos
        for s in range(PBF_2D_STEPS):
            a, b = runs[("cuda", "pallas_dma")][s], runs[("cpu", "pallas_dma")][s]
            c = runs[("cuda", "pallas")][s]
            nn = float(torch.cdist(a.double(), b.double()).min(dim=1)
                       .values.max())
            check(torch.equal(a, c), f"{PBF_2D}, step {s}: the two kernels "
                  f"differ")
            if s < PBF_2D_NN_STEPS:
                check(nn < NN_TOL, f"{PBF_2D}, step {s}: CPU and card differ "
                      f"by {nn}")
            say(f"[7] {PBF_2D}, step {s}: CPU vs card max nearest-neighbour "
                f"distance {nn:.3e}; the two kernels bit-equal")
        say(f"[7] {PBF_2D}: launches on the card {json.dumps(launches2)}")
        # the 2D bodies on pbf_2d's state after its card steps
        scene, state = load_scene(os.path.join(SCENES, PBF_2D))
        sim2 = simlib.Simulation(scene, state)
        for _ in range(3):
            sim2.step()
        params2 = scene.params
        st, env = simlib.Plumbing.neighbor_prep(sim2.state, params2)
        p = common.update_fluid_position(st.particles, st.rigid, params2)
        fluid = p.material == MATERIAL_FLUID
        dens = pbflib.compute_density_moving(p, env, params2, fluid)
        lam = pbflib.compute_lambda(p, dens, env, params2, fluid)
        envs = {"pair_pass": pairs.make_pair_env(env.cells, env.produce, params2),
                "pair_slab": pairs.make_slab_env(env.cells, env.produce,
                                                 params2)}
        check_pbf_bodies(f"{PBF_2D} (the 2D walk)", params2, envs,
                         pbf_fields(p, dens, lam), fluid, launches2)

        # (d) both walks on pile-ups: the 2D one, and the 3D one under poly6
        for label, case in (("2D pile-up", pk.pile_up_case_2d()),
                            ("3D pile-up, poly6", pk.pile_up_case())):
            params, cells, produce, fields = case
            params = dataclasses.replace(params, kernel_type="poly6")
            cells, produce = cells.cuda(), produce.cuda()
            fields = {k: v.cuda() for k, v in fields.items()}
            envs = {"pair_pass": pairs.make_pair_env(cells, produce, params),
                    "pair_slab": pairs.make_slab_env(cells, produce, params)}
            longest = int(pairs.candidate_ranges(
                envs["pair_pass"], torch.nonzero(produce).flatten())[1].max())
            most = int(pbf_count(envs["pair_pass"], params, fields,
                                 produce).max())
            say(f"[7] {label}: {int(produce.sum())} rows, most neighbours of "
                f"a row {most}, longest run of candidates {longest}, widest "
                f"window {int(envs['pair_slab'].lens.max())}")
            check_pbf_bodies(label, params, envs, fields, produce, {},
                             measure=False)
            # the non-pressure pass with the dynamic-rigid outputs
            dyn = (fields["material"] == MATERIAL_RIGID) & \
                (fields["is_dynamic"] > 0)
            fk = {k: fields[k] for k in pk.fields_of("nonpressure", pk.RIGID)}
            outs = []
            for engine, env in envs.items():
                out_k = pk.run_cuda("nonpressure", env, fk, params,
                                    produce | dyn, pk.RIGID)
                out_p = pk.run_plain_body("nonpressure", env, fk, params,
                                          produce | dyn, pk.RIGID)
                for c in out_k:
                    e = float((out_k[c] - out_p[c]).abs().max())
                    lim = TOL * max(1.0, float(out_p[c].abs().max()))
                    check(e <= lim, f"{label}, {engine}/nonpressure+rigid.{c}:"
                          f" max error {e} > {lim}")
                outs.append(out_k)
            check(all(torch.equal(outs[0][c], outs[1][c]) for c in outs[0]),
                  f"{label}: the kernels differ on nonpressure+rigid")
            say(f"[7] {label}: nonpressure+rigid of both kernels within "
                f"tolerance and bit-equal")

    # ---- 7. PBF -------------------------------------------------------------
    t0 = time.perf_counter()
    pbf_phase()
    say(f"[7] PBF phase: {time.perf_counter() - t0:.1f} s")

    # ---- 8. the other methods in 2D and under poly6, PBF with implicit
    # viscosity, shape matching ------------------------------------------------
    def timed(fn):
        """(fn(), its device time in ms), from CUDA events around one call."""
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = fn()
        b.record()
        b.synchronize()
        return out, a.elapsed_time(b)

    def kind_ops(body, params, ops):
        """``ops``, a cubic 3D body's operations per pair, for ``params``'
        kind and dimension (KERNEL_FORMS, PER_COMPONENT_OPS)."""
        if params.kernel_type == "poly6":
            ops += POLY6_FORM_OPS * KERNEL_FORMS[body]
        return ops - (3 - params.dim) * PER_COMPONENT_OPS[body]

    new_records = []

    def compare(tag, out_k, out_p):
        """Largest |kernel - plain| over the outputs, each within TOL of its
        largest |plain|; counts exact."""
        err = 0.0
        for c in out_k:
            e = float((out_k[c] - out_p[c]).abs().max())
            err = max(err, e)
            if c == "cnt":
                check(e == 0.0, f"{tag}: counts differ")
            lim = TOL * max(1.0, float(out_p[c].abs().max()))
            check(e <= lim, f"{tag}.{c}: max error {e} > {lim}")
        return err

    def measure_kinds(tag, sim, bodies):
        """``bodies`` of both kernels on ``sim``'s state, sorted again as its
        next step would sort it, against their plain versions (counts
        exact), the kernels bit-equal; their times, bound and instruction
        floor, and a record per body and engine."""
        params = sim.params
        st, env = simlib.Plumbing.neighbor_prep(sim.state, params)
        sim.state = st.replace(cached_neighbors=env)
        fields = pair_fields(sim)
        rigid_rows = sim.state.particles.material == MATERIAL_RIGID
        envs = {"pair_pass": pairs.make_pair_env(env.cells, env.produce,
                                                 params),
                "pair_slab": pairs.make_slab_env(env.cells, env.produce,
                                                 params)}
        geom = GEOMETRY_OPS if params.dim == 3 else GEOMETRY_OPS_2D
        outs = {}
        for engine, e in envs.items():
            slab = engine == "pair_slab"
            table = ((e.starts, e.lens, e.cells) if slab
                     else (e.cells, e.cell_start))
            work = {}
            for body in bodies:
                flags = pk.COUNT if body == "divergence" else 0
                wall = body == "rigid_volume"
                rows = rigid_rows if wall else e.produce
                if wall not in work:
                    work[wall] = (*work_of_rows(e, params, fields, rows),
                                  rows_read(e, params, fields, rows))
                tests, npairs, read = work[wall]
                fk = {k: fields[k] for k in pk.fields_of(body, flags)}

                def kernel(e=e):
                    return pk.run_cuda(body, e, fk, params, rows, flags)

                out_k = kernel()
                out_p, plain_ms = timed(lambda: pk.run_plain_body(
                    body, e, fk, params, rows, flags))
                key = pk.params_key(engine, body, params)
                err = compare(f"{tag}, {key}", out_k, out_p)
                outs[(engine, body)] = out_k
                ms = cuda_ms(kernel, 20)
                if body in VISC_OPS:
                    n_rj = rigid_j_pairs(e, params, fields, rows)
                    f_ops, r_ops = (kind_ops(body, params, o)
                                    for o in VISC_OPS[body])
                    n_ops = (npairs * geom + (npairs - n_rj) * f_ops
                             + n_rj * r_ops)
                else:
                    n_ops = npairs * (geom + kind_ops(body, params,
                                                      OPS_PER_PAIR[body]))
                n_bytes = pass_bytes(fk, read, table, len(out_k),
                                     params.n_pad)
                b_ms, b_by = bound_ms(n_bytes, n_ops)
                floor_ms = (tests * TEST_INSTR + n_ops) / instr_per_s * 1e3
                say(f"[8] {tag}, {key}: max_abs_err {err:.3e}, kernel "
                    f"{ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                    f"{b_ms:.5f} ms ({b_by}: {n_bytes / 1e6:.2f} MB, "
                    f"{n_ops / 1e9:.5f} Gop), instruction floor "
                    f"{floor_ms:.5f} ms, {tests} candidates tested, "
                    f"{npairs} pairs")
                new_records.append(dict(
                    name=key, route="cuda", source=ENGINES[engine][0],
                    replaces=ENGINES[engine][1], launches=0, max_abs_err=err,
                    ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                    library_ms=None, issue_floor_ms=floor_ms,
                    tests_per_pair=tests / max(npairs, 1), state=tag))
        for body in bodies:
            a, b = outs[("pair_slab", body)], outs[("pair_pass", body)]
            check(all(torch.equal(a[c], b[c]) for c in a),
                  f"{tag}: the two pair kernels differ on {body}")
        say(f"[8] {tag}: the two kernels bit-equal on {', '.join(bodies)}")

    launches8: dict = {}

    def run_path(tag, load, steps, device="cuda", engine="pair_pass"):
        """``load()`` -> (scene, state); a Simulation on ``device`` and
        ``steps`` steps, each gated (finite positions, overflow 0, the fluid
        count) and printed; on the card the launches zeroed just before and
        read just after, every kernel of the path launched and no other.
        Returns (simulation, per-step (iterations, fluid positions on the
        CPU))."""
        t0 = time.perf_counter()
        scene, state = load()
        params = scene.params
        n_fluid = int((state.particles.material == MATERIAL_FLUID).sum())
        if device == "cuda":
            zero_counts()
        sim = simlib.Simulation(scene, state, device=device)
        implicit = params.viscosity_method == "implicit"
        log, ms = [], []
        for s in range(steps):
            t1 = time.perf_counter()
            d = sim.step()
            if device == "cuda":
                torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            p = sim.state.particles
            fl = p.material == MATERIAL_FLUID
            its = tuple(int(d[k]) for k in ("solver_iters", "div_iters")
                        if k in d)
            if implicit:
                its += (int(viscosity_cg.last_solve["cg_iters"]),)
            check(bool(torch.isfinite(p.pos).all()),
                  f"{tag}, step {s}: positions not finite")
            check(int(d["neighbor_overflow"]) == 0
                  and int(d["sort_overflow"]) == 0, f"{tag}, step {s}: overflow")
            check(int(d["fluid_num"]) == n_fluid, f"{tag}, step {s}: fluid count")
            log.append((its, p.pos[fl].cpu().clone()))
            if device == "cuda" and (steps <= 5 or s % 5 == 4 or s == 0):
                say(f"[8] {tag}, step {s}: {ms[-1]:.2f} ms, iterations "
                    f"{its}, density_avg {float(d['density_avg']):.3f} max "
                    f"{float(d['density_max']):.3f}, vel_max*dt "
                    f"{float(d['vel_max']) * params.dt:.5f} m")
        if device == "cuda":
            launches = read_counts()
            check_launches(tag, params, engine, launches)
            for k, v in launches.items():
                if v:
                    launches8[k] = launches8.get(k, 0) + v
            say(f"[8] {tag}: {n_fluid} fluid, n_pad {params.n_pad}, loaded and"
                f" run in {time.perf_counter() - t0:.1f} s; median step "
                f"{median(ms[1:] if len(ms) > 1 else ms):.2f} ms; launches "
                f"{json.dumps({k: v for k, v in launches.items() if v})}")
        return sim, log

    measured = set()

    def kinds_3d():
        """pbf_3d.json under DFSPH, WCSPH, PCISPH, IISPH (3D poly6) and
        under PBF with implicit viscosity, through both kernels: the two
        runs' iteration counts and positions equal step for step (the
        kernels are bit-equal), the bodies measured on the cell-list run's
        state."""
        for label, over, n_cell, n_slab, bodies in KIND_3D_PATHS:
            logs = {}
            for engine, steps in (("pair_pass", n_cell), ("pair_slab", n_slab)):
                over_e = dict(over, **(SLAB if engine == "pair_slab" else {}))
                sim, logs[engine] = run_path(
                    f"{PBF_3D} {label}, {engine}",
                    lambda: load_scene(os.path.join(SCENES, PBF_3D), **over_e),
                    steps, engine=engine)
                check(sim.params.kernel_type == "poly6"
                      and sim.params.dim == 3, "pbf_3d parameters")
                if engine == "pair_pass":
                    kept = sim
                else:
                    del sim
            for s, (a, b) in enumerate(zip(logs["pair_slab"],
                                           logs["pair_pass"])):
                check(a[0] == b[0] and torch.equal(a[1], b[1]),
                      f"{PBF_3D} {label}, step {s}: the kernels' runs differ")
            say(f"[8] {PBF_3D} {label}: the two kernels' runs equal for "
                f"{n_slab} steps (iterations and positions)")
            todo = [b for b in bodies
                    if (b, "poly6", 3) not in measured]
            measure_kinds(f"{PBF_3D} {label}", kept, todo)
            measured.update((b, "poly6", 3) for b in todo)
            del kept
            torch.cuda.empty_cache()

    def kinds_2d():
        """The 2D paths on the CPU and on the card through both kernels:
        iteration counts equal in all three runs every step, the two kernels'
        positions equal, the card within NN_TOL of the CPU for the path's
        first steps; the bodies measured on the card's cell-list state."""
        for label, scene_name, over, steps, nn_steps, bodies in KIND_2D_PATHS:
            def load(be, over=over, scene_name=scene_name):
                if scene_name == "box":
                    return load_scene(config=SimConfig(config=box_2d_config()),
                                      pair_backend=be, **over)
                return load_scene(os.path.join(SCENES, scene_name),
                                  pair_backend=be, **over)

            runs = {}
            for dev, be in (("cpu", "pallas_dma"), ("cuda", "pallas_dma"),
                            ("cuda", "pallas")):
                engine = "pair_slab" if be == "pallas" else "pair_pass"
                sim, runs[(dev, be)] = run_path(
                    f"{label}, {dev} {engine}", lambda be=be: load(be), steps,
                    device=dev, engine=engine)
                if (dev, be) == ("cuda", "pallas_dma"):
                    kept = sim
            worst = 0.0
            for s in range(steps):
                a = runs[("cuda", "pallas_dma")][s]
                b = runs[("cpu", "pallas_dma")][s]
                c = runs[("cuda", "pallas")][s]
                check(a[0] == b[0] == c[0], f"{label}, step {s}: iterations "
                      f"{a[0]} (card), {b[0]} (CPU), {c[0]} (slab-window)")
                check(torch.equal(a[1], c[1]),
                      f"{label}, step {s}: the two kernels differ")
                nn = float(torch.cdist(a[1].double(), b[1].double())
                           .min(dim=1).values.max())
                if s < nn_steps:
                    check(nn < NN_TOL, f"{label}, step {s}: CPU and card "
                          f"differ by {nn}")
                    worst = max(worst, nn)
            say(f"[8] {label}: {steps} steps, iterations equal on the CPU and "
                f"the card every step ({[r[0] for r in runs[('cuda', 'pallas_dma')]]}), "
                f"the kernels bit-equal; CPU vs card max nearest-neighbour "
                f"distance {worst:.3e} over the first {nn_steps} steps, "
                f"{nn:.3e} at the last")
            params = kept.params
            todo = [b for b in bodies if (b, params.kernel_type, 2)
                    not in measured]
            measure_kinds(label, kept, todo)
            measured.update((b, params.kernel_type, 2) for b in todo)

    def dem_check(tag, params, env, fields, dyn_rows, measure):
        """rigid_dem of both kernels on one state against its plain version,
        the kernels bit-equal; with ``measure`` the times and a record per
        engine. Returns the touching pairs."""
        def touching(cx, d2):
            return ((cx.blk("material") == MATERIAL_RIGID)
                    & (cx.slab("material") == MATERIAL_RIGID)
                    & (cx.blk("object_id") != cx.slab("object_id"))
                    & (torch.sqrt(d2) < params.particle_diameter))

        n_touch = count_pairs(env, params, fields, dyn_rows, touching)
        fk = {k: fields[k] for k in pk.fields_of("rigid_dem")}
        envs = {"pair_pass": pairs.make_pair_env(env.cells, env.produce,
                                                 params),
                "pair_slab": pairs.make_slab_env(env.cells, env.produce,
                                                 params)}
        outs = []
        geom = GEOMETRY_OPS if params.dim == 3 else GEOMETRY_OPS_2D
        for engine, e in envs.items():
            def kernel(e=e):
                return pk.run_cuda("rigid_dem", e, fk, params, dyn_rows)

            out_k = kernel()
            out_p, plain_ms = timed(lambda: pk.run_plain_body(
                "rigid_dem", e, fk, params, dyn_rows))
            key = pk.params_key(engine, "rigid_dem", params)
            err = compare(f"{tag}, {key}", out_k, out_p)
            outs.append(out_k)
            say(f"[8] {tag}, {key}: {int(dyn_rows.sum())} dynamic rigid rows, "
                f"{n_touch} touching pairs, max_abs_err {err:.3e} (largest "
                f"|f| {max(float(v.abs().max()) for v in out_p.values()):.3e})")
            if not measure:
                continue
            ms = cuda_ms(kernel, 20)
            slab = engine == "pair_slab"
            table = ((e.starts, e.lens, e.cells) if slab
                     else (e.cells, e.cell_start))
            tests, npairs = work_of_rows(e, params, fields, dyn_rows)
            read = rows_read(e, params, fields, dyn_rows)
            n_ops = npairs * (geom + DEM_PAIR_OPS) + \
                n_touch * DEM_TOUCH_OPS[params.dim]
            n_bytes = pass_bytes(fk, read, table, params.dim, params.n_pad)
            b_ms, b_by = bound_ms(n_bytes, n_ops)
            floor_ms = (tests * TEST_INSTR + n_ops) / instr_per_s * 1e3
            say(f"[8] {tag}, {key}: kernel {ms:.4f} ms, plain {plain_ms:.3f} "
                f"ms, bound {b_ms:.5f} ms ({b_by}), instruction floor "
                f"{floor_ms:.5f} ms, {tests} candidates tested, {npairs} pairs")
            new_records.append(dict(
                name=key, route="cuda", source=ENGINES[engine][0],
                replaces=ENGINES[engine][1], launches=0, max_abs_err=err,
                ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None, issue_floor_ms=floor_ms,
                tests_per_pair=tests / max(npairs, 1), state=tag))
        check(all(torch.equal(outs[0][c], outs[1][c]) for c in outs[0]),
              f"{tag}: the two pair kernels differ on rigid_dem")
        return n_touch

    def rigidity(sim):
        """Per dynamic body: the largest and the mean distance of its
        particles from their centroid (tests/test_rigid.py:298-327)."""
        p = sim.state.particles
        out = []
        for oid in sim.params.contact_channels:
            x = p.pos[(p.object_id == oid) & (p.material == MATERIAL_RIGID)]
            r = (x - x.mean(0)).norm(dim=1)
            out.append((float(r.max()), float(r.mean())))
        return np.array(out)

    def shape_matching_path():
        """coupling_dfsph.json under the shape-matching backend at full size:
        SM_STEPS steps, the touching pairs counted every SM_COUNT_EVERY, the
        bodies finite and rigid; rigid_dem measured on the final state and,
        where no pair touches there, checked on the pile-up's squeezed
        bodies."""
        t0 = time.perf_counter()
        scene, state = load_scene(os.path.join(SCENES, SM_SCENE),
                                  rigid_solver="shape_matching")
        params = scene.params
        check(params.rigid_solver == "shape_matching"
              and params.has_dynamic_rigid, f"{SM_SCENE} parameters")
        n_fluid = int((state.particles.material == MATERIAL_FLUID).sum())
        zero_counts()
        sim = simlib.Simulation(scene, state)
        r0 = rigidity(sim)
        ms, touched = [], 0
        for s in range(SM_STEPS):
            t1 = time.perf_counter()
            d = sim.step()
            torch.cuda.synchronize()
            ms.append((time.perf_counter() - t1) * 1e3)
            p = sim.state.particles
            check(bool(torch.isfinite(p.pos).all()),
                  f"{SM_SCENE}, step {s}: positions not finite")
            check(int(d["neighbor_overflow"]) == 0
                  and int(d["fluid_num"]) == n_fluid,
                  f"{SM_SCENE}, step {s}: overflow or fluid count")
            rigid = sim.state.rigid
            body = {k: getattr(rigid, k)[list(params.contact_channels)]
                    for k in ("com", "vel", "rot")}
            check(all(bool(torch.isfinite(v).all()) for v in body.values()),
                  f"{SM_SCENE}, step {s}: bodies not finite")
            if s % SM_COUNT_EVERY == SM_COUNT_EVERY - 1:
                st = sim.state
                env = pairs.make_pair_env(st.cached_neighbors.cells,
                                          st.cached_neighbors.produce, params)
                fields = {"pos": p.pos, "material": p.material,
                          "object_id": p.object_id,
                          "chan": integrator.channel_table(rigid, params)}
                dyn = integrator.dynamic_rigid_mask(p, rigid, params)
                n = count_pairs(env, params, fields, dyn, lambda cx, d2: (
                    (cx.blk("material") == MATERIAL_RIGID)
                    & (cx.slab("material") == MATERIAL_RIGID)
                    & (cx.blk("object_id") != cx.slab("object_id"))
                    & (torch.sqrt(d2) < params.particle_diameter)))
                touched = max(touched, n)
                say(f"[8] {SM_SCENE} shape matching, step {s}: "
                    f"{ms[-1]:.2f} ms, touching pairs {n}, iterations "
                    f"({int(d['solver_iters'])}, {int(d['div_iters'])}), com "
                    f"{[[round(x, 4) for x in c] for c in body['com'].tolist()]}"
                    f", vel {[[round(x, 4) for x in c] for c in body['vel'].tolist()]}")
        launches = read_counts()
        check_launches(f"{SM_SCENE} shape matching", params, "pair_pass",
                       launches)
        for k, v in launches.items():
            if v:
                launches8[k] = launches8.get(k, 0) + v
        r1 = rigidity(sim)
        worst = float(np.abs(r1 / r0 - 1.0).max())
        check(worst <= SM_RIGID_RTOL, f"{SM_SCENE}: a body deformed by "
              f"{worst:.3%} (radius max and mean {r0.tolist()} -> "
              f"{r1.tolist()})")
        say(f"[8] {SM_SCENE} shape matching: {SM_STEPS} steps in "
            f"{time.perf_counter() - t0:.1f} s, median {median(ms[1:]):.2f} "
            f"ms; rigidity (radius max, mean per body) {r0.round(5).tolist()}"
            f" -> {r1.round(5).tolist()}, largest change {worst:.4%}; the "
            f"most touching pairs at a count {touched}; launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}")
        st, env = simlib.Plumbing.neighbor_prep(sim.state, params)
        del sim
        p = st.particles
        fields = {"pos": p.pos, "vel": p.vel, "material": p.material,
                  "object_id": p.object_id, "rest_volume": p.rest_volume,
                  "chan": integrator.channel_table(st.rigid, params)}
        dyn = integrator.dynamic_rigid_mask(p, st.rigid, params)
        n_touch = dem_check(f"{SM_SCENE} after {SM_STEPS} steps", params, env,
                            fields, dyn, measure=True)
        # whether the projection waits for the card (torch.linalg.svd and
        # det on CUDA may, for their error checks): the synchronizations
        # torch's sync debug mode reports over one projection
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                smlib.shape_matching_step(p, st.rigid, params)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        say(f"[8] {SM_SCENE}: one shape-matching projection on the card "
            f"synchronizes with the host {len(caught)} times"
            f"{': ' if caught else ''}"
            f"{'; '.join(sorted({str(w.message)[:120] for w in caught}))}")
        del st, env, p, fields
        torch.cuda.empty_cache()
        # the same path through the slab-window kernel, a few steps
        scene, state = load_scene(os.path.join(SCENES, SM_SCENE),
                                  rigid_solver="shape_matching", **SLAB)
        zero_counts()
        slab_sim = simlib.Simulation(scene, state)
        for s in range(SM_SLAB_STEPS):
            slab_sim.step()
        check(bool(torch.isfinite(slab_sim.state.particles.pos).all()),
              f"{SM_SCENE}, slab-window kernel: positions not finite")
        launches = read_counts()
        check_launches(f"{SM_SCENE} shape matching, slab-window", params,
                       "pair_slab", launches)
        for k, v in launches.items():
            if v:
                launches8[k] = launches8.get(k, 0) + v
        say(f"[8] {SM_SCENE} shape matching, slab-window kernel: "
            f"{SM_SLAB_STEPS} steps, launches "
            f"{json.dumps({k: v for k, v in launches.items() if v})}")
        del slab_sim
        torch.cuda.empty_cache()
        if n_touch == 0:
            say(f"[8] {SM_SCENE}: no pair touches in {SM_STEPS} steps (the "
                f"bodies fall toward the fluid); rigid_dem is checked on the "
                f"pile-up's squeezed bodies below")

    def pile_up_kinds():
        """Every body, rigid variant, contact pass and the DEM pass of both
        kernels on the pile-up states of the new kinds and dimensions
        (lists that fill and flush, runs across tiles, touching bodies)
        against their plain versions, the kernels bit-equal."""
        cases = (("3D pile-up, poly6", pk.pile_up_case, "poly6",
                  pk.PILE_UP_CHANNELS, None),
                 ("3D pile-up, cubic", pk.pile_up_case, "cubic",
                  pk.PILE_UP_CHANNELS, ("rigid_dem",)),
                 ("2D pile-up, cubic", pk.pile_up_case_2d, "cubic",
                  pk.PILE_UP_CHANNELS_2D, None),
                 ("2D pile-up, poly6", pk.pile_up_case_2d, "poly6",
                  pk.PILE_UP_CHANNELS_2D, None))
        for label, make, kind, chans, only in cases:
            params, cells, produce, fields = make()
            params = dataclasses.replace(params, kernel_type=kind,
                                         contact_channels=chans,
                                         has_dynamic_rigid=True)
            cells, produce = cells.cuda(), produce.cuda()
            fields = {k: v.cuda() for k, v in fields.items()}
            dyn = (fields["material"] == MATERIAL_RIGID) & \
                (fields["is_dynamic"] > 0)
            envs = {"pair_pass": pairs.make_pair_env(cells, produce, params),
                    "pair_slab": pairs.make_slab_env(cells, produce, params)}
            names = only or tuple(pk.BODIES)
            done = []
            for name in names:
                for flags in (0, pk.RIGID):
                    if flags and name not in pk.RIGID_OUTPUTS:
                        continue
                    if name in ("divergence", "pbf_density"):
                        flags |= pk.COUNT
                    rows = (dyn if name in ("rigid_contact", "rigid_dem",
                                            "rigid_volume")
                            else produce | dyn if flags & pk.RIGID
                            else produce)
                    fk = {k: fields[k] for k in pk.fields_of(name, flags)}
                    outs = []
                    for engine, e in envs.items():
                        out_k = pk.run_cuda(name, e, fk, params, rows, flags)
                        out_p = pk.run_plain_body(name, e, fk, params, rows,
                                                  flags)
                        compare(f"{label}, {engine}/{name}", out_k, out_p)
                        outs.append(out_k)
                    check(all(torch.equal(outs[0][c], outs[1][c])
                              for c in outs[0]),
                          f"{label}: the two pair kernels differ on {name}")
                    done.append(name + ("+rigid" if flags & pk.RIGID else ""))
            n_touch = dem_check(label, params, envs["pair_pass"], fields, dyn,
                                measure=False)
            check(n_touch > 0, f"{label}: no touching pairs")
            say(f"[8] {label}: {len(done)} instances within tolerance of "
                f"their plain versions and bit-equal between the kernels "
                f"({', '.join(done)})")

    t0 = time.perf_counter()
    kinds_3d()
    say(f"[8] pbf_3d paths: {time.perf_counter() - t0:.1f} s")
    t1 = time.perf_counter()
    kinds_2d()
    say(f"[8] 2D paths: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    shape_matching_path()
    say(f"[8] shape matching: {time.perf_counter() - t1:.1f} s")
    t1 = time.perf_counter()
    pile_up_kinds()
    say(f"[8] pile-ups: {time.perf_counter() - t1:.1f} s")
    # the records count every launch of the main paths, phase 8's included
    for rec in records:
        rec["launches"] += launches8.get(rec["name"], 0)
    for rec in new_records:
        rec["launches"] = launches8.get(rec["name"], 0)
        check(rec["launches"] > 0, f"{rec['name']}: measured on {rec['state']}"
              f" but launched on no path")
    records.extend(new_records)
    say(f"[8] phase 8: {time.perf_counter() - t0:.1f} s")

    # ---- 9. the spatial decomposition ---------------------------------------
    records9, launches9 = spatial_phase()
    for rec in records:
        rec["launches"] += launches9.get(rec["name"], 0)
    records.extend(records9)

    # ---- 10. the offline pipeline -------------------------------------------
    launches10 = offline_phase(card)
    for rec in records:
        if not rec["name"].endswith("@moved"):
            rec["launches"] += launches10.get(rec["name"], 0)

    # ---- 11. the step as one device program: graphed against eager ---------
    graph_phase(card)

    # ---- 12. records -------------------------------------------------------
    # per engine: every body but the contact pass, the DEM pass and the PBF
    # bodies at the flagship's shapes, the rigid variants, the bodies of a
    # PBF step in 3D and in 2D, phase 8's instances and its DEM pass, and
    # phase 9's body on the extended layout; the gather, and its resort pack
    # and unpack; the WHILE node's condition kernel
    n_pbf = len([b for b in pk.BODIES if b.startswith("pbf_")])
    check(len(records) == 2 * (len(pk.BODIES) - 2 - n_pbf + len(RIGID_VARIANTS)
                               + 2 * len(PBF_BODIES) + len(measured) + 2) + 4,
          "a kernel has no record")
    say(json.dumps({"kernels": records}))
    say(card)
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

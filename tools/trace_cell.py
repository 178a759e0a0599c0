"""One benchmark cell with the program's spans on, on the card: what they
show, the checks they must pass, and what tracing costs.

    python3 tools/trace_cell.py --workload flagship_dfsph.settled --seed 7
    python3 tools/trace_cell.py --settle 1200 --steps 20 \\
        --scene data/scenes/high_viscosity_implicit.json

With ``--workload``: the harness's set-up of the cell (``benchmark/
harness.py`` ``Cell.setup``, traced), its traced pass (the device trace of
the step captured without tracing), then ``benchmark/program_trace.py``'s
pass (the step captured again with tracing on, one segment replayed, 20
steps profiled); every per-layer reader, the benchmark's and the five of
the program's spans; the checks (stamps an iteration against the
correctors' counts, the pair-launch spans against the trace's ``pair_ms``,
the replay gap against the idle share, the first step's pairs against the
reference's count on the positions the walk sorted, no event dropped, the
clock); then the cost: the segment replayed with tracing off, on, on, off.
With ``--scene``: a scene run ``--settle`` steps, then ``--steps`` steps
traced, the CG's ticks a step against ``viscosity_cg.last_solve``, and the
time inside the CG's spans against the kernel time the profiler traced in
them. One JSON line on stdout, also written to ``--out``. ``--root``
takes the cell from another checkout's ``BENCHMARK.json`` and benchmark;
``--device cpu`` rehearses the run on the CPU's plain versions (no stamps,
no profiled steps, no device numbers).
"""
import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(ROOT, "benchmark")


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def segment_ms(cell, sim, on: bool) -> tuple:
    """ms a step of one segment from the snapshot, as the window steps,
    with tracing ``on`` or off; and the stamps a step."""
    from sph_project_tpu_torch.utils.telemetry import host_values
    sim.trace(on)
    sim.state = cell.snapshot
    cell._sync()
    sim.spans()
    seg = cell.spec["traffic"]["segment_steps"]
    t0 = time.perf_counter()
    for _ in range(seg):
        host_values(sim.step(), sim.recording)
    ms = (time.perf_counter() - t0) / seg * 1e3
    r = sim.spans()
    return ms, len(r.get("stamps", ())) / seg


def cell_run(args) -> dict:
    import torch
    import harness
    import program_trace
    t0 = time.perf_counter()
    bench = os.path.join(args.root, "benchmark")
    spec = harness.load_cell(args.root, args.workload, bench)
    torch.set_num_threads(1)
    cell = harness.Cell(spec, args.seed, args.device)
    cell.setup(t0, True)
    log(f"set-up {cell.setup_s:.1f} s")
    cell.window(1.0)   # the held first step, as the window takes it
    rec = cell.traced_pass()
    prog = program_trace.program_pass(cell, log)
    rec["program"] = prog
    cost = []
    for on in (False, True, True, False):
        cost.append((on, *segment_ms(cell, cell.sim, on)))
    cell.free()
    rec["work"] = cell.pair_work()
    metrics = {}
    for m in spec["per_layer"] + [{"name": n} for n in (
            "replay_gap_ms", "prep_ms", "solve_ms", "glue_ms",
            "pair_hit_rate")]:
        metrics[m["name"]] = harness.metric_reader(BENCH, m["name"])(rec)
    if cell.device.type != "cuda":
        metrics = {k: v for k, v in metrics.items()
                   if k in ("solver_iters", "pair_hit_rate")}
    # checks
    seg = prog["steps"]
    ticks = {}
    for name, r, n in prog["ticks"]:
        ticks[(name, r)] = n
    loops = ("dfsph.density", "dfsph.divergence")
    iters_bad = 0
    for k, r in enumerate(prog["replays"]):
        row = prog["diags"][k]
        want = row.get("solver_iters", 0) + row.get("div_iters", 0)
        iters_bad += sum(ticks.get((n, r), 0) for n in loops) != want
    pair_ns = sum(e - s for name, _, s, e in prog["spans"]
                  if name.startswith("pair.") and name != "pair.pair_count")
    pair_span_ms = pair_ns / 1e6 / seg
    ref = cell.ref_mod
    held_mat = cell.held["material"]
    pr = ref.Pairs(cell.held["pos"].double(), held_mat != 0, cell.ph)
    held_pairs = int((held_mat[pr.i] == ref.FLUID).sum())
    kept1 = prog["first_counters"].get("pair_kept", 0)
    wall_ms = rec["wall_s"] / rec["steps"] * 1e3
    idle = metrics.get("device_idle")
    checks = dict(
        iters_mismatched_steps=iters_bad,
        pair_span_ms=pair_span_ms,
        pair_span_over_pair_ms=(pair_span_ms / metrics["pair_ms"]
                                if metrics.get("pair_ms") else None),
        replay_gap_bound_ms=(None if idle is None else
                             idle / 100 * wall_ms +
                             prog["timer_step_ns"] / 1e6),
        first_step_pairs_kept=kept1, snapshot_pairs=rec["work"]["pairs"],
        held_pairs=held_pairs,
        first_vs_held=(kept1 - held_pairs) / held_pairs,
        first_vs_snapshot=(kept1 - rec["work"]["pairs"]) /
        rec["work"]["pairs"],
        dropped=prog["dropped"], inside_share=prog.get("inside_share"),
        offset_uncertainty_ns=prog["offset_uncertainty_ns"],
        timer_step_ns=prog["timer_step_ns"])
    glue = {}
    for name, _, s, e in prog["spans"]:
        if not name.startswith("pair.") and name != "step":
            glue[name] = glue.get(name, 0.0) + (e - s) / 1e6 / seg
    # each stage's time outside the pair launches in it, and the step's
    # outside every stage
    stages = {}
    by_replay = {}
    for sp in prog["spans"]:
        by_replay.setdefault(sp[1], []).append(sp)
    for r, sps in by_replay.items():
        pair = [(s, e) for n, _, s, e in sps if n.startswith("pair.")]
        step = [(s, e) for n, _, s, e in sps if n == "step"]
        tops = [(n, s, e) for n, _, s, e in sps
                if not n.startswith("pair.") and n != "step"
                and not any(n2 != n and not n2.startswith("pair.")
                            and n2 != "step" and s2 <= s and e <= e2
                            for n2, _, s2, e2 in sps)]
        for n, s, e in tops:
            inner = [(max(a, s), min(b, e)) for a, b in pair
                     if b > s and a < e]
            stages[n] = stages.get(n, 0.0) + (
                e - s - program_trace.union_ns(inner)) / 1e6 / seg
        if step:
            s0, e0 = step[0]
            covered = program_trace.union_ns(
                [(s, e) for _, s, e in tops] + pair)
            stages["(outside any stage)"] = stages.get(
                "(outside any stage)", 0.0) + (e0 - s0 - covered) / 1e6 / seg
    out = dict(workload=args.workload, seed=args.seed,
               device=harness.device_info(cell.device)["kind"],
               metrics=metrics,
               checks=checks, stage_ms=glue, glue_by_stage_ms=stages,
               cost=[dict(trace=on, step_ms=ms, stamps=st)
                     for on, ms, st in cost],
               stamps_per_step=prog["stamps_per_step"],
               counters=prog["counters"],
               traced_wall_ms=wall_ms, program_wall_ms=prog["wall_s"] / seg *
               1e3, capture_s=prog["capture_s"],
               drift_ppm=prog["drift_ppm"],
               replay_gaps=prog["replay_gaps"],
               profiled={k: prog.get(k) for k in (
                   "profiled_steps", "stamps_profiled", "stamps_inside",
                   "stamp_kernels_unmatched", "sessions", "gaps_20us")})
    return out


def scene_run(args) -> dict:
    """The implicit-viscosity probe: the CG's ticks against its count, and
    the time inside its spans against the profiler's kernels there."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from sph_project_tpu_torch.scene import load_scene
    from sph_project_tpu_torch.sim import Simulation
    from sph_project_tpu_torch.solvers import viscosity_cg
    from sph_project_tpu_torch.utils.telemetry import host_values
    import bench_trace
    torch.set_num_threads(1)
    # as the benchmark's traced runs: a profiler session before any capture
    bench_trace.attach_profiler()
    scene, state = load_scene(os.path.join(ROOT, args.scene))
    sim = Simulation(scene, state, device="cuda")
    done = 0
    while done < args.settle:
        k = min(250, args.settle - done)
        sim.run(k)
        done += k
    torch.cuda.synchronize()
    sim.trace(True)
    trace = sim.recording
    sim.spans()
    cg, ticks, span_ms, traced_ms, kernels_in, cg_matvec = [], [], [], [], \
        [], []
    for k in range(args.steps):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            host_values(sim.step(), trace)
            torch.cuda.synchronize()
        cg.append(int(viscosity_cg.last_solve["cg_iters"]))
        trace.calibrate()
        r = sim.spans()
        ticks.append(sum(n for (name, _), n in r["ticks"].items()
                         if name == "viscosity.cg"))
        dev, host = [], []
        cuda = torch.autograd.DeviceType.CUDA
        for e in prof.profiler.kineto_results.events():
            s = e.start_ns()
            if e.name().startswith("sph."):
                if e.device_type() != cuda:
                    host.append((e.name(), s, s + e.duration_ns()))
            elif e.device_type() == cuda:
                dev.append((e.name(), s, s + e.duration_ns()))
        mine = sorted((s for s in r["spans"] if s.where == "host"
                       and s.name.startswith("sph.")), key=lambda s: s.start)
        theirs = sorted(host, key=lambda x: x[1])
        h_off = sorted(s - m.start for m, (_, s, _) in zip(mine, theirs))
        h_off = h_off[len(h_off) // 2] if h_off else 0.0
        spans = [s for s in r["spans"] if s.name == "viscosity.cg"]
        own = r["device_ns"]
        span_ms.append(sum(own[s.seq][1] - own[s.seq][0] for s in spans)
                       / 1e6)
        t_in = 0
        n_in = 0
        n_mv = 0
        for s in spans:
            lo, hi = s.start + h_off, s.end + h_off
            for name, a, b in dev:
                if a >= lo and b <= hi:
                    t_in += b - a
                    n_in += 1
                    n_mv += "ViscMatvec" in name
        traced_ms.append(t_in / 1e6)
        kernels_in.append(n_in)
        cg_matvec.append(n_mv)
    return dict(scene=args.scene, device=torch.cuda.get_device_name(0),
                settle=args.settle, cg_iters=cg, cg_ticks=ticks,
                ticks_equal=cg == ticks, cg_span_ms=span_ms,
                profiler_kernel_ms_in_cg=traced_ms,
                profiler_kernels_in_cg=kernels_in,
                profiler_matvecs_in_cg=cg_matvec)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--scene")
    ap.add_argument("--settle", type=int, default=0)
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--out", default=None)
    ap.add_argument("--root", default=ROOT)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    sys.path[:0] = [BENCH, ROOT]
    import torch
    if args.device == "cuda" and not torch.cuda.is_available():
        log("trace_cell.py: needs a CUDA device")
        return 2
    out = cell_run(args) if args.workload else scene_run(args)
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())

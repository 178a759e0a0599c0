"""CLI driver: run a scene JSON end to end with periodic frame export.

The JAX package's driver (``run_simulation.py``) for the port, with the same
flags and frame cadence: ``--scene_file`` picks the JSON, frames come every
``outputInterval`` steps (else every 1/``fps`` s of simulated time), the run
lasts ``totalTime`` (capped by ``--steps``), exports land in
``<scene>_output/<frame:06d>/`` and checkpoints in ``<out>/ckpt``.
``--device`` is ``cuda`` (the default: every pair pass and every sort runs
through the CUDA kernels) or ``cpu`` (their plain PyTorch versions); there
is no fallback from one to the other.

    python run_simulation_torch.py --scene_file data/scenes/smoke_test.json
    python -m sph_project_tpu_torch --scene_file ... --device cpu
"""
from __future__ import annotations

import argparse
import os
import time


def main(argv=None):
    """Run the driver on ``argv`` (default: the command line). Returns the
    :class:`~sph_project_tpu_torch.sim.Simulation` at the end of the run."""
    parser = argparse.ArgumentParser()
    parser.add_argument("--scene_file", default="", help="scene file")
    parser.add_argument("--steps", type=int, default=None,
                        help="cap on simulation steps (default: totalTime/dt)")
    parser.add_argument("--no-export", action="store_true")
    parser.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    parser.add_argument("--output_dir", default=None)
    parser.add_argument("--quiet", action="store_true")
    parser.add_argument("--checkpoint_interval", type=int, default=0,
                        help="steps between checkpoints (0 = off)")
    parser.add_argument("--log_json", default=None,
                        help="JSONL file for per-step telemetry")
    parser.add_argument("--resume", default=None,
                        help="checkpoint directory to resume from")
    parser.add_argument("--viewer", type=int, default=0, metavar="PORT",
                        help="serve a live browser view on this port "
                             "(the GGUI-window counterpart; 0 = off)")
    args = parser.parse_args(argv)

    from .io import checkpoint
    from .io.exporters import FrameExporter
    from .scene import load_scene
    from .sim import Simulation
    from .utils.telemetry import StepTelemetry

    scene, state = load_scene(args.scene_file)
    cfg = scene.config
    params = scene.params

    fps = cfg.get_cfg("fps") or 60
    dt = params.dt
    output_interval = int((1.0 / fps) / dt)
    if cfg.get_cfg("outputInterval"):
        output_interval = cfg.get_cfg("outputInterval")
    total_time = cfg.get_cfg("totalTime") or 10.0
    total_rounds = int(total_time / dt)
    if args.steps is not None:
        total_rounds = min(total_rounds, args.steps)

    scene_name = os.path.splitext(os.path.basename(args.scene_file))[0] or "scene"
    out_dir = args.output_dir or f"{scene_name}_output"
    exporter = None
    if not args.no_export:
        exporter = FrameExporter(
            scene, out_dir,
            export_ply=bool(cfg.get_cfg("exportPly")),
            export_obj=bool(cfg.get_cfg("exportObj")),
            export_frame=bool(cfg.get_cfg("exportFrame")),
        )

    sim = Simulation(scene, state, device=args.device)

    if args.resume:
        # replaces the prepared state; nothing is prepared again
        sim.state = checkpoint.restore(args.resume, sim.state, params)
        print(f"resumed from {args.resume} at step "
              f"{int(sim.state.step_count)}")

    print(f"Simulation method: {params.simulation_method}")
    print(f"particles: {params.n_particles}  dt: {dt}  steps: {total_rounds}")

    viewer = None
    if args.viewer:
        from .io.viewer import LiveViewer
        viewer = LiveViewer(params, port=args.viewer)
        print(f"live viewer: http://localhost:{viewer.port}")

    telem = StepTelemetry(log_file=args.log_json,
                          print_every=0 if args.quiet else 1)
    start_cnt = int(sim.state.step_count)
    t_prev = time.perf_counter()
    for cnt in range(start_cnt, total_rounds):
        diag = sim.step()
        telem.record(diag, cnt, params.n_particles)
        if exporter is not None and cnt % output_interval == 0:
            exporter.dump(sim.state, cnt)
        if viewer is not None and cnt % max(output_interval // 4, 1) == 0:
            now = time.perf_counter()
            # steps elapsed since the previous update, not 1 (the update
            # fires only every output_interval//4 steps)
            viewer.update(sim.state,
                          steps_per_s=max(output_interval // 4, 1) /
                          max(now - t_prev, 1e-9))
            t_prev = now
        if args.checkpoint_interval and cnt and cnt % args.checkpoint_interval == 0:
            checkpoint.save(os.path.join(out_dir, "ckpt"), sim.state)

    summ = telem.summary(params.n_particles)
    telem.close()
    if viewer is not None:
        viewer.close()
    if summ["steps"] > 0:
        print(f"Simulation Finished: {summ['steps']} steps in "
              f"{summ['elapsed_s']}s ({summ['steps_per_s']} steps/s, "
              f"{summ['particle_steps_per_s']:.3g} particle-steps/s)")
    return sim

"""Render the port's exported frames to shaded images, without JAX.

The flags and backends of ``render.py``:

- ``preview`` (default): the numpy z-buffer renderer of the port
  (``sph_project_tpu_torch/io/render3d.py``). Per frame directory it draws
  every OBJ (the surfaces of ``surface_reconstruction_torch.py``, and any
  rigid-body OBJs) and every particle PLY that has no surface, and writes
  ``render.png`` there; frames go round a worker pool;
- ``blender``: each frame through ``blender -b <blend_file> --python
  rendering_script.py``, frames round-robined over ``--num_devices`` GPUs
  of ``--device_type``.

A frame that fails prints ``FAILED <error> <frame>`` and the others go on.

    python render_torch.py --input_dir <out> --size 800 800 --num_workers 4
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import shutil
import subprocess


RENDER_SCRIPT = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "rendering_script.py")


def render_frame(args_tuple):
    """Render one frame directory; returns (frame, None) or (frame, the
    error's message)."""
    (frame_dir, eye, target, fov, size, backend, blend_file,
     device_type, device_id) = args_tuple
    try:
        if backend == "blender":
            out = os.path.join(frame_dir, "render.png")
            subprocess.run(
                ["blender", "-b", blend_file, "--python", RENDER_SCRIPT,
                 "--", frame_dir, out, device_type, str(device_id)],
                check=True, capture_output=True)
            return frame_dir, None
        from sph_project_tpu_torch.geometry.mesh import load_obj
        from sph_project_tpu_torch.io import render3d
        from sph_project_tpu_torch.io.exporters import read_ply, write_png

        img = zbuf = None
        objs = sorted(f for f in os.listdir(frame_dir) if f.endswith(".obj"))
        plys = sorted(f for f in os.listdir(frame_dir) if f.endswith(".ply"))
        surfaced = {f.split("_surface")[0] for f in objs if "_surface" in f}
        for name in objs:
            v, fc = load_obj(os.path.join(frame_dir, name))
            color = (90, 140, 230) if "particle" in name else (200, 200, 205)
            img, zbuf = render3d.render_mesh(
                v, fc, size=size, eye=eye, target=target, fov=fov,
                color=color, img=img, zbuf=zbuf)
        for name in plys:
            if name[:-4] in surfaced:
                continue   # already drawn as a surface
            pts = read_ply(os.path.join(frame_dir, name))
            img, zbuf = render3d.render_particles(
                pts, size=size, eye=eye, target=target, fov=fov,
                img=img, zbuf=zbuf)
        if img is None:
            return frame_dir, "nothing to render"
        write_png(os.path.join(frame_dir, "render.png"), img)
        return frame_dir, None
    except Exception as e:
        return frame_dir, str(e)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--input_dir", required=True)
    ap.add_argument("--num_workers", type=int, default=4)
    ap.add_argument("--backend", choices=["preview", "blender"],
                    default="preview")
    ap.add_argument("--blend_file", default="scene.blend")
    ap.add_argument("--device_type", default="NONE",
                    help="Cycles device for the blender backend "
                         "(OPTIX/CUDA/HIP/METAL/NONE=CPU)")
    ap.add_argument("--num_devices", type=int, default=1,
                    help="GPUs to round-robin frames over (blender backend)")
    ap.add_argument("--eye", type=float, nargs=3, default=[3.0, 2.0, 3.0])
    ap.add_argument("--target", type=float, nargs=3, default=[0.5, 0.5, 0.5])
    ap.add_argument("--fov", type=float, default=50.0)
    ap.add_argument("--size", type=int, nargs=2, default=[800, 800])
    args = ap.parse_args()

    if args.backend == "blender" and shutil.which("blender") is None:
        raise SystemExit("blender not found on PATH; use --backend preview")

    frames = sorted(
        os.path.join(args.input_dir, d) for d in os.listdir(args.input_dir)
        if os.path.isdir(os.path.join(args.input_dir, d)))
    work = [(f, tuple(args.eye), tuple(args.target), args.fov,
             tuple(args.size), args.backend, args.blend_file,
             args.device_type, rank % max(args.num_devices, 1))
            for rank, f in enumerate(frames)]
    # spawned workers: each starts from a fresh import of this script
    with multiprocessing.get_context("spawn").Pool(args.num_workers) as pool:
        for frame, err in pool.imap_unordered(render_frame, work):
            print(f"{'FAILED ' + err if err else 'done'} {frame}")


if __name__ == "__main__":
    main()

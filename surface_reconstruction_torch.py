"""Offline surface reconstruction of the port's frames: per-frame PLY particle
clouds -> OBJ meshes, without JAX.

The flags, frame walk and file names of ``surface_reconstruction.py``, over
``sph_project_tpu_torch.io.exporters`` and ``sph_project_tpu_torch.native``
(the repository's C++ helpers): a cubic-spline density splat on a grid, then
marching tetrahedra at an iso level. ``--input_dir`` holds one subdirectory
per frame (``run_simulation_torch.py --output_dir``); each
``particle_object_<id>.ply`` in it becomes ``particle_object_<id>_surface.obj``
beside it. ``--use-splashsurf`` shells out to a ``splashsurf`` binary on
PATH instead. A frame that fails prints ``FAILED <frame>: <error>`` and the
others go on.

    python surface_reconstruction_torch.py --input_dir <out> --num_workers 4
"""
from __future__ import annotations

import argparse
import multiprocessing
import os
import shutil
import subprocess

import numpy as np


def reconstruct_file(ply_path: str, out_path: str, radius: float,
                     smoothing_length: float, iso: float,
                     grid_scale: float) -> int:
    """Surface one PLY cloud into ``out_path``; returns the triangle count."""
    from sph_project_tpu_torch import native
    from sph_project_tpu_torch.io.exporters import read_ply, write_obj

    pts = read_ply(ply_path)
    if len(pts) == 0:
        write_obj(out_path, np.zeros((0, 3)), np.zeros((0, 3), np.int64))
        return 0
    h = smoothing_length * radius
    cell = radius * grid_scale
    lo = pts.min(axis=0) - 2 * h
    hi = pts.max(axis=0) + 2 * h
    dims = np.maximum(((hi - lo) / cell).astype(np.int32) + 1, 2)
    vol = 0.8 * (2 * radius) ** 3
    grid = native.density_grid(pts, lo, [cell] * 3, dims, h, vol)
    tris = native.marching_tetrahedra(grid, lo, [cell] * 3, iso)
    verts = tris.reshape(-1, 3)
    faces = np.arange(len(verts), dtype=np.int64).reshape(-1, 3)
    write_obj(out_path, verts, faces)
    return len(faces)


def process_frame(args_tuple):
    """Surface every particle PLY of one frame directory; returns (frame,
    None) or (frame, the error's message)."""
    frame_dir, radius, smoothing_length, iso, grid_scale, use_splashsurf = \
        args_tuple
    try:
        for name in sorted(os.listdir(frame_dir)):
            if not (name.startswith("particle_object_")
                    and name.endswith(".ply")):
                continue
            src = os.path.join(frame_dir, name)
            dst = os.path.join(frame_dir, name[:-4] + "_surface.obj")
            if use_splashsurf:
                subprocess.run(
                    ["splashsurf", "reconstruct", src, "-r", str(radius),
                     "-l", str(smoothing_length), "-c", "0.5", "-t", "0.6",
                     "--subdomain-grid=on", "--mesh-cleanup=on",
                     "--mesh-smoothing-weights=on", "--mesh-smoothing-iters=25",
                     "--normals=on", "-o", dst],
                    check=True, capture_output=True)
            else:
                reconstruct_file(src, dst, radius, smoothing_length, iso,
                                 grid_scale)
        return frame_dir, None
    except Exception as e:  # reported per frame; the pool goes on
        return frame_dir, str(e)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--input_dir", required=True,
                    help="directory of per-frame subdirectories")
    ap.add_argument("--num_workers", type=int, default=4)
    ap.add_argument("--radius", type=float, default=0.01)
    ap.add_argument("--smoothing-length", dest="smoothing_length",
                    type=float, default=3.5,
                    help="kernel support in radii")
    ap.add_argument("--iso", type=float, default=0.45,
                    help="isosurface level of the normalized density")
    ap.add_argument("--grid-scale", type=float, default=1.0,
                    help="grid cell size in particle radii")
    ap.add_argument("--use-splashsurf", action="store_true",
                    help="shell out to splashsurf (reference pipeline parity)")
    args = ap.parse_args()

    if args.use_splashsurf and shutil.which("splashsurf") is None:
        raise SystemExit("splashsurf not found on PATH")

    frames = sorted(
        os.path.join(args.input_dir, d) for d in os.listdir(args.input_dir)
        if os.path.isdir(os.path.join(args.input_dir, d)))
    work = [(f, args.radius, args.smoothing_length, args.iso,
             args.grid_scale, args.use_splashsurf) for f in frames]
    # spawned workers: each starts from a fresh import of this script
    with multiprocessing.get_context("spawn").Pool(args.num_workers) as pool:
        for frame, err in pool.imap_unordered(process_frame, work):
            if err:
                print(f"FAILED {frame}: {err}")
            else:
                print(f"done {frame}")


if __name__ == "__main__":
    main()

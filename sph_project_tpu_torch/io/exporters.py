"""Frame exporters: PLY / OBJ / NPZ / PNG, dependency-free.

The JAX package's ``io/exporters.py``, writing byte for byte the same files
for the same state, so the repository's surfacing and rendering scripts read
the port's frames unchanged. :meth:`FrameExporter.dump` takes the port's
state and copies each field it uses to the host once.

The reference exports per-interval frames from the driver loop
(run_simulation.py:131-150): ascii PLY point clouds per fluid object (via
taichi's PLYWriter), transformed OBJ meshes per rigid object (via trimesh),
and a GGUI screenshot. Neither taichi nor trimesh exists here, so the writers
are implemented directly; the PNG "raw view" is a small orthographic particle
rasterizer so headless runs still produce inspectable frames.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np


def write_ply(path: str, points: np.ndarray) -> None:
    """Ascii PLY point cloud (x, y, z) — same schema the reference's
    PLYWriter.export_ascii emits for fluid objects (run_simulation.py:142-144)."""
    pts = np.asarray(points, np.float32)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for p in pts:
            f.write(f"{p[0]} {p[1]} {p[2]}\n")


def read_ply(path: str) -> np.ndarray:
    """Minimal ascii-PLY reader (for tests / post-processing)."""
    with open(path) as f:
        line = f.readline()
        n = 0
        while line and line.strip() != "end_header":
            if line.startswith("element vertex"):
                n = int(line.split()[-1])
            line = f.readline()
        return np.loadtxt(f, max_rows=n, dtype=np.float32).reshape(n, -1)[:, :3]


def write_obj(path: str, verts: np.ndarray, faces: np.ndarray) -> None:
    """Wavefront OBJ triangle mesh (rigid-object export,
    run_simulation.py:145-150)."""
    with open(path, "w") as f:
        for v in np.asarray(verts):
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for tri in np.asarray(faces):
            f.write(f"f {tri[0] + 1} {tri[1] + 1} {tri[2] + 1}\n")


def write_npz(path: str, **arrays) -> None:
    np.savez_compressed(path, **arrays)


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    chunk = tag + data
    return struct.pack(">I", len(data)) + chunk + \
        struct.pack(">I", zlib.crc32(chunk) & 0xFFFFFFFF)


def png_bytes(rgb: np.ndarray) -> bytes:
    """Encode an (H, W, 3) uint8 array as PNG bytes (no imaging deps)."""
    h, w, _ = rgb.shape
    raw = b"".join(b"\x00" + rgb[y].tobytes() for y in range(h))
    out = b"\x89PNG\r\n\x1a\n"
    out += _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
    out += _png_chunk(b"IDAT", zlib.compress(raw, 6))
    out += _png_chunk(b"IEND", b"")
    return out


def write_png(path: str, rgb: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as a PNG (no imaging deps)."""
    with open(path, "wb") as f:
        f.write(png_bytes(rgb))


def rasterize_particles(pos: np.ndarray, colors: np.ndarray,
                        domain_start, domain_end,
                        size: int = 512, axis: int = 2) -> np.ndarray:
    """Orthographic particle splat along one axis -> (size, size, 3) uint8.

    Stands in for the reference's GGUI viewport (run_simulation.py:116-129)
    for headless frame export. Depth-sorts so near particles win.
    """
    lo = np.asarray(domain_start, np.float64)
    hi = np.asarray(domain_end, np.float64)
    dims = [d for d in range(pos.shape[1]) if d != axis][:2]
    if pos.shape[1] == 2:
        dims = [0, 1]
    img = np.zeros((size, size, 3), np.uint8)
    if len(pos) == 0:
        return img
    span = np.maximum(hi[dims] - lo[dims], 1e-9)
    uv = (pos[:, dims] - lo[dims]) / span
    px = np.clip((uv * (size - 1)).astype(np.int64), 0, size - 1)
    if pos.shape[1] == 3:
        order = np.argsort(pos[:, axis])          # far first, near overwrites
    else:
        order = np.arange(len(pos))
    x, y = px[order, 0], (size - 1) - px[order, 1]
    img[y, x] = np.asarray(colors, np.uint8)[order]
    return img


class FrameExporter:
    """Per-interval frame writer matching the reference's output layout:
    ``<scene>_output/<frame:06d>/{particle_object_<id>.ply,
    mesh_object_<id>.obj, raw_view.png}`` (run_simulation.py:131-150)."""

    def __init__(self, scene, out_dir: str, export_ply=True, export_obj=False,
                 export_frame=False, export_npz=False):
        self.scene = scene
        self.out_dir = out_dir
        self.export_ply = export_ply
        self.export_obj = export_obj
        self.export_frame = export_frame
        self.export_npz = export_npz
        os.makedirs(out_dir, exist_ok=True)

    def dump(self, state, cnt: int) -> None:
        frame_dir = os.path.join(self.out_dir, f"{cnt:06d}")
        os.makedirs(frame_dir, exist_ok=True)
        p = state.particles
        pos = p.pos.cpu().numpy()
        obj_ids = p.object_id.cpu().numpy()

        if self.export_ply:
            for oid in self.scene.fluid_object_ids:
                sel = obj_ids == oid
                write_ply(os.path.join(frame_dir, f"particle_object_{oid}.ply"),
                          pos[sel])
        if self.export_obj:
            com = state.rigid.com.cpu().numpy()
            rot = state.rigid.rot.cpu().numpy()
            for so in self.scene.objects:
                if so.mesh_verts is None or not so.is_dynamic:
                    continue
                oid = so.object_id
                v = (so.mesh_verts - 0.0) @ rot[oid].T + com[oid]
                write_obj(os.path.join(frame_dir, f"mesh_object_{oid}.obj"),
                          v, so.mesh_faces)
        if self.export_frame or self.export_npz:
            mat = p.material.cpu().numpy()
        if self.export_frame:
            active = mat != 0
            colors = np.zeros((len(pos), 3), np.uint8)
            for so in self.scene.objects:
                if so.visible:
                    colors[obj_ids == so.object_id] = so.color
            vis = active & (colors.sum(axis=1) > 0)
            img = rasterize_particles(
                pos[vis], colors[vis],
                self.scene.params.domain_start, self.scene.params.domain_end)
            write_png(os.path.join(frame_dir, "raw_view.png"), img)
        if self.export_npz:
            write_npz(os.path.join(frame_dir, "state.npz"),
                      pos=pos, vel=p.vel.cpu().numpy(), material=mat,
                      object_id=obj_ids, density=p.density.cpu().numpy())

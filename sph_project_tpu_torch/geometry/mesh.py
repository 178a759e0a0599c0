"""From-scratch OBJ loading, transforms, and mesh voxelization (host-side).

The reference leans on trimesh for mesh IO and voxelization
(``base_container.py:611-717``); trimesh is not available here, so this module
implements the needed subset directly:

- :func:`load_obj` — minimal Wavefront OBJ triangle loader
- :func:`rotation_matrix_axis_angle` / :func:`rotation_matrix_euler_xyz` —
  the two rotation conventions the reference mixes (trimesh axis-angle for
  static bodies, bullet Euler for dynamic ones; base_container.py:621-624,
  bullet_solver.py:102-107)
- :func:`inside_lattice` — lattice points inside a closed mesh via z-ray
  parity counting (the analogue of ``mesh.voxelized(pitch).fill().points`` and
  of the reference's per-point ``mesh.contains`` loop, but vectorized)

Everything here runs once at scene build time on the host, in numpy. The
JAX package can hand the inside test to its C++ helper; the port always uses
the vectorised numpy version below.
"""
from __future__ import annotations

import math

import numpy as np


def load_obj(path: str) -> tuple[np.ndarray, np.ndarray]:
    """Load an OBJ file. Returns (vertices (V, 3) f64, faces (F, 3) i64).

    Polygon faces are fan-triangulated; v/vt/vn index forms and negative
    indices are handled.
    """
    verts: list[list[float]] = []
    faces: list[list[int]] = []
    with open(path, "r") as f:
        for line in f:
            if line.startswith("v "):
                parts = line.split()
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif line.startswith("f "):
                idx = []
                for tok in line.split()[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float64), np.asarray(faces, np.int64)


def rotation_matrix_axis_angle(axis, angle_rad: float) -> np.ndarray:
    """Rodrigues rotation about a (normalized) axis."""
    a = np.asarray(axis, np.float64)
    n = np.linalg.norm(a)
    if n < 1e-12:
        return np.eye(3)
    a = a / n
    K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
    return np.eye(3) + math.sin(angle_rad) * K + (1 - math.cos(angle_rad)) * K @ K


def rotation_matrix_euler_xyz(rpy) -> np.ndarray:
    """Bullet's getQuaternionFromEuler convention: intrinsic XYZ (roll, pitch,
    yaw). Used for dynamic rigid bodies (bullet_solver.py:102-107)."""
    r, p, y = rpy
    cr, sr = math.cos(r), math.sin(r)
    cp, sp = math.cos(p), math.sin(p)
    cy, sy = math.cos(y), math.sin(y)
    Rx = np.array([[1, 0, 0], [0, cr, -sr], [0, sr, cr]])
    Ry = np.array([[cp, 0, sp], [0, 1, 0], [-sp, 0, cp]])
    Rz = np.array([[cy, -sy, 0], [sy, cy, 0], [0, 0, 1]])
    return Rz @ Ry @ Rx


def inside_lattice(verts: np.ndarray, faces: np.ndarray,
                   points: np.ndarray) -> np.ndarray:
    """Boolean inside-mesh test for lattice ``points`` (P, 3).

    Casts +z rays: for every triangle, finds which points' (x, y) fall inside
    its projection and the crossing z; a point is inside iff the number of
    crossings below it is odd. Vectorized per triangle over candidate points
    via sorted key arithmetic — no (P, F) blowup.
    """
    if len(faces) == 0 or len(points) == 0:
        return np.zeros(len(points), dtype=bool)
    P = points.astype(np.float64)
    tri = verts[faces]                     # (F, 3, 3)

    # Assign points to a uniform xy-binning so each triangle only tests the
    # points inside its xy bounding box.
    xy_min = P[:, :2].min(axis=0)
    # bin size ~ triangle size; use median triangle bbox extent, bounded
    ext = (tri[:, :, :2].max(axis=1) - tri[:, :, :2].min(axis=1))
    cell = max(float(np.median(ext)) if len(ext) else 1e-3, 1e-6)
    pc = np.floor((P[:, :2] - xy_min) / cell).astype(np.int64)
    nx = int(pc[:, 0].max()) + 1 if len(pc) else 1
    ny = int(pc[:, 1].max()) + 1 if len(pc) else 1
    key = pc[:, 0] * ny + pc[:, 1]
    order = np.argsort(key, kind="stable")
    key_sorted = key[order]
    # bin start offsets
    bin_starts = np.searchsorted(key_sorted, np.arange(nx * ny))
    bin_ends = np.searchsorted(key_sorted, np.arange(nx * ny) + 1)

    crossings_per_point = np.zeros(len(P), dtype=np.int64)

    A, B, C = tri[:, 0], tri[:, 1], tri[:, 2]
    e1 = B - A
    e2 = C - A
    denom = e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]
    ok = np.abs(denom) > 1e-15

    t_lo = np.floor((tri[:, :, :2].min(axis=1) - xy_min) / cell).astype(np.int64)
    t_hi = np.floor((tri[:, :, :2].max(axis=1) - xy_min) / cell).astype(np.int64)
    t_lo = np.clip(t_lo, 0, [nx - 1, ny - 1])
    t_hi = np.clip(t_hi, 0, [nx - 1, ny - 1])

    for f in np.nonzero(ok)[0]:
        cand: list[np.ndarray] = []
        for bx in range(t_lo[f, 0], t_hi[f, 0] + 1):
            base = bx * ny
            s = bin_starts[base + t_lo[f, 1]]
            e = bin_ends[base + t_hi[f, 1]]
            if e > s:
                cand.append(order[s:e])
        if not cand:
            continue
        ptsf = np.concatenate(cand)
        d = P[ptsf, :2] - A[f, :2]
        inv = 1.0 / denom[f]
        s = (d[:, 0] * e2[f, 1] - d[:, 1] * e2[f, 0]) * inv
        t = (e1[f, 0] * d[:, 1] - e1[f, 1] * d[:, 0]) * inv
        hit = (s >= 0) & (t >= 0) & (s + t <= 1)
        if not hit.any():
            continue
        zc = A[f, 2] + s[hit] * e1[f, 2] + t[hit] * e2[f, 2]
        below = zc < P[ptsf[hit], 2]
        np.add.at(crossings_per_point, ptsf[hit][below], 1)

    return (crossings_per_point % 2) == 1


def fill_lattice(verts: np.ndarray, faces: np.ndarray, pitch: float,
                 offset_half_pitch: bool = True) -> np.ndarray:
    """Lattice of points inside the mesh, spaced ``pitch``.

    With ``offset_half_pitch`` the lattice sits at voxel centers over the mesh
    bounds — the analogue of trimesh ``voxelized(pitch).fill().points`` used
    for rigid bodies (base_container.py:635-638). Without it the lattice
    starts at the min bound, matching the fluid-body path
    (base_container.py:690-717).
    """
    lo = verts.min(axis=0)
    hi = verts.max(axis=0)
    start = lo + (0.5 * pitch if offset_half_pitch else 0.0)
    axes = [np.arange(start[i], hi[i], pitch) for i in range(3)]
    grid = np.meshgrid(*axes, indexing="ij")
    pts = np.stack(grid, axis=-1).reshape(-1, 3)
    keep = inside_lattice(verts, faces, pts)
    return pts[keep].astype(np.float32)

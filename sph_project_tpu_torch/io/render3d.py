"""Software 3D preview renderer: z-buffered flat-shaded triangles, numpy only.

The JAX package's ``io/render3d.py``, unchanged: it takes numpy arrays and
gives the same images.

The reference's offline rendering is a Blender farm (render.py +
rendering_script.py in jason-huang03/SPH_Project). Blender stays supported as
an optional backend of the repo-root ``render.py`` driver; this module is the
dependency-free fallback so every environment can turn surface meshes and
particle clouds into shaded frames.
"""
from __future__ import annotations

import numpy as np


def look_at(eye, target, up=(0.0, 1.0, 0.0)):
    eye = np.asarray(eye, np.float64)
    f = np.asarray(target, np.float64) - eye
    f = f / np.linalg.norm(f)
    r = np.cross(f, np.asarray(up, np.float64))
    r = r / np.linalg.norm(r)
    u = np.cross(r, f)
    view = np.eye(4)
    view[0, :3], view[1, :3], view[2, :3] = r, u, -f
    view[:3, 3] = -view[:3, :3] @ eye
    return view


def perspective(fov_deg, aspect, near=0.01, far=100.0):
    t = 1.0 / np.tan(np.radians(fov_deg) / 2)
    m = np.zeros((4, 4))
    m[0, 0] = t / aspect
    m[1, 1] = t
    m[2, 2] = (far + near) / (near - far)
    m[2, 3] = 2 * far * near / (near - far)
    m[3, 2] = -1.0
    return m


def render_mesh(verts: np.ndarray, faces: np.ndarray, *, size=(800, 800),
                eye=(3.0, 2.0, 3.0), target=(0.5, 0.5, 0.5), fov=50.0,
                color=(90, 140, 230), bg=(20, 20, 26),
                light_dir=(0.5, 1.0, 0.3), img=None, zbuf=None):
    """Rasterize a triangle mesh with Lambert shading. Returns (img, zbuf);
    pass them back in to composite multiple meshes into one frame."""
    W, H = size
    if img is None:
        img = np.empty((H, W, 3), np.uint8)
        img[:] = np.asarray(bg, np.uint8)
    if zbuf is None:
        zbuf = np.full((H, W), np.inf, np.float32)
    if len(faces) == 0:
        return img, zbuf

    view = look_at(eye, target)
    proj = perspective(fov, W / H)
    v4 = np.concatenate([verts, np.ones((len(verts), 1))], axis=1)
    clip = (proj @ view @ v4.T).T
    w = clip[:, 3:4]
    keep_w = w[:, 0] > 1e-6
    ndc = np.where(keep_w[:, None], clip[:, :3] / np.maximum(w, 1e-6), 0.0)
    sx = (ndc[:, 0] * 0.5 + 0.5) * (W - 1)
    sy = (1.0 - (ndc[:, 1] * 0.5 + 0.5)) * (H - 1)
    depth = -(view @ v4.T).T[:, 2]          # camera-space z > 0 in front

    tri = faces
    light = np.asarray(light_dir, np.float64)
    light = light / np.linalg.norm(light)
    e1 = verts[tri[:, 1]] - verts[tri[:, 0]]
    e2 = verts[tri[:, 2]] - verts[tri[:, 0]]
    nrm = np.cross(e1, e2)
    nl = np.linalg.norm(nrm, axis=1)
    nrm = nrm / np.maximum(nl, 1e-12)[:, None]
    lam = np.abs(nrm @ light)
    shade = (0.25 + 0.75 * lam)[:, None] * np.asarray(color, np.float64)
    shade = shade.clip(0, 255).astype(np.uint8)

    order = np.argsort(-depth[tri].mean(axis=1))   # far-to-near painter prep
    for t in order:
        i0, i1, i2 = tri[t]
        if not (keep_w[i0] and keep_w[i1] and keep_w[i2]):
            continue
        xs = np.array([sx[i0], sx[i1], sx[i2]])
        ys = np.array([sy[i0], sy[i1], sy[i2]])
        zs = np.array([depth[i0], depth[i1], depth[i2]])
        x0, x1 = int(max(xs.min(), 0)), int(min(xs.max(), W - 1)) + 1
        y0, y1 = int(max(ys.min(), 0)), int(min(ys.max(), H - 1)) + 1
        if x0 >= x1 or y0 >= y1:
            continue
        px, py = np.meshgrid(np.arange(x0, x1), np.arange(y0, y1))
        d = (xs[1] - xs[0]) * (ys[2] - ys[0]) - (xs[2] - xs[0]) * (ys[1] - ys[0])
        if abs(d) < 1e-9:
            continue
        l1 = ((px - xs[0]) * (ys[2] - ys[0]) - (py - ys[0]) * (xs[2] - xs[0])) / d
        l2 = ((py - ys[0]) * (xs[1] - xs[0]) - (px - xs[0]) * (ys[1] - ys[0])) / d
        l0 = 1.0 - l1 - l2
        inside = (l0 >= 0) & (l1 >= 0) & (l2 >= 0)
        if not inside.any():
            continue
        z = l0 * zs[0] + l1 * zs[1] + l2 * zs[2]
        sub_z = zbuf[y0:y1, x0:x1]
        upd = inside & (z < sub_z) & (z > 0)
        sub_z[upd] = z[upd]
        img[y0:y1, x0:x1][upd] = shade[t]
    return img, zbuf


def render_particles(pos: np.ndarray, *, size=(800, 800), eye=(3.0, 2.0, 3.0),
                     target=(0.5, 0.5, 0.5), fov=50.0, radius_px=2,
                     color=(90, 140, 230), img=None, zbuf=None, bg=(20, 20, 26)):
    """Depth-tested particle splats through the same camera."""
    W, H = size
    if img is None:
        img = np.empty((H, W, 3), np.uint8)
        img[:] = np.asarray(bg, np.uint8)
    if zbuf is None:
        zbuf = np.full((H, W), np.inf, np.float32)
    if len(pos) == 0:
        return img, zbuf
    view = look_at(eye, target)
    proj = perspective(fov, W / H)
    v4 = np.concatenate([pos, np.ones((len(pos), 1))], axis=1)
    clip = (proj @ view @ v4.T).T
    w = np.maximum(clip[:, 3], 1e-6)
    x = ((clip[:, 0] / w) * 0.5 + 0.5) * (W - 1)
    y = (1.0 - ((clip[:, 1] / w) * 0.5 + 0.5)) * (H - 1)
    depth = -(view @ v4.T).T[:, 2]
    ok = (depth > 0) & (x >= 0) & (x < W) & (y >= 0) & (y < H)
    xi, yi, zi = x[ok].astype(int), y[ok].astype(int), depth[ok].astype(np.float32)
    order = np.argsort(-zi)
    col = np.asarray(color, np.uint8)
    r = radius_px
    for dx in range(-r, r + 1):
        for dy in range(-r, r + 1):
            if dx * dx + dy * dy > r * r:
                continue
            xs = np.clip(xi[order] + dx, 0, W - 1)
            ys = np.clip(yi[order] + dy, 0, H - 1)
            upd = zi[order] < zbuf[ys, xs]
            zbuf[ys[upd], xs[upd]] = zi[order][upd]
            img[ys[upd], xs[upd]] = col
    return img, zbuf

"""Host-side particle seeding: cube lattices and hollow box shells.

Numerics intentionally reproduce the reference's ``np.arange``-based lattice
generation (``base_container.py:753-849``) so particle counts and seed
positions match the reference scene-for-scene (BASELINE.md derived counts).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np


def cube_lattice(lower: Sequence[float], size: Sequence[float],
                 spacing: float) -> np.ndarray:
    """Particles on a lattice filling [lower, lower+size), spaced by
    ``spacing`` (reference add_cube, base_container.py:753-798)."""
    axes = [np.arange(lower[i], lower[i] + size[i], spacing)
            for i in range(len(lower))]
    grid = np.meshgrid(*axes, sparse=False, indexing="ij")
    return np.stack(grid, axis=-1).reshape(-1, len(lower)).astype(np.float32)


def box_shell_lattice(lower: Sequence[float], size: Sequence[float],
                      spacing: float, thickness: float) -> np.ndarray:
    """Lattice keeping only points within ``thickness`` of a face — the hollow
    domain box (reference add_box, base_container.py:800-849)."""
    pts = cube_lattice(lower, size, spacing)
    dim = pts.shape[1]
    mask = np.zeros(pts.shape[0], dtype=bool)
    for i in range(dim):
        mask |= (pts[:, i] <= lower[i] + thickness) | \
                (pts[:, i] >= lower[i] + size[i] - thickness)
    return pts[mask]


def cube_particle_count(start: Sequence[float], end: Sequence[float],
                        spacing: float) -> int:
    """Exact count add_cube would produce (base_container.py:719-727)."""
    n = 1
    for s, e in zip(start, end):
        n *= len(np.arange(s, e, spacing))
    return n

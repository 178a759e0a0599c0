"""ctypes bindings for the repository's C++ helpers (``native/libsphnative.so``).

The library is built from ``native/marching_cubes.cpp`` and
``native/voxelize.cpp`` by ``native/Makefile`` (plain C ABI, no pybind11):

- :func:`density_grid`: the cubic-spline density splat of a particle cloud
  onto a regular grid (normalised: particle volume times kernel sums);
- :func:`marching_tetrahedra`: the triangle soup of a grid at an iso level;
- :func:`mesh_inside`: the inside test of a closed triangle mesh (ray
  parity), the scene loader's (``geometry/mesh.py`` ``fill_lattice``);
- :func:`available`: whether the library loads.

They run on the host, over numpy arrays, as they do for the JAX package:
surface reconstruction and the scene build are offline work around the
simulation, not on the card. The argument and result types are the JAX
package's ``native.py``'s, so both give the same arrays.

The library is tracked in the repository, built for x86-64 Linux against
glibc 2.14 symbols and libstdc++ (``GLIBCXX_3.4``). When it is missing,
the first call runs ``make -C native`` (``g++`` and ``make`` needed). When
it is present but does not load, for example on a host whose glibc or
libstdc++ is older than the one it was linked against, ``ctypes.CDLL``
raises ``OSError`` naming the missing symbol version: every function here
re-raises it, :func:`available` returns False, and :func:`load_error`
gives the message. Nothing rebuilds the tracked file on its own; ``make -C
native clean all`` rebuilds it with the host's own compiler, which cures a
library built against a newer glibc or libstdc++, provided ``g++`` and
``make`` are on that host. ``geometry/mesh.py`` then falls back to its
numpy inside test and says so in a warning, as the JAX package falls back
(silently) to its own.
"""
from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

NATIVE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native")
LIB_PATH = os.path.join(NATIVE_DIR, "libsphnative.so")

_lib = None
_error: str | None = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    f32 = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    i32 = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    u8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    lib.sph_density_grid.argtypes = [f32, ctypes.c_int64, f32, f32, i32,
                                     ctypes.c_float, ctypes.c_float, f32]
    lib.sph_density_grid.restype = None
    lib.marching_tetrahedra.argtypes = [f32, i32, f32, f32, ctypes.c_float,
                                        f32, ctypes.c_int64]
    lib.marching_tetrahedra.restype = ctypes.c_int64
    lib.mesh_inside.argtypes = [f64, ctypes.c_int64, i64, ctypes.c_int64,
                                f64, ctypes.c_int64, u8]
    lib.mesh_inside.restype = None
    return lib


def _load() -> ctypes.CDLL:
    """The bound library, built first if it is missing; raises what the
    build or the load raised."""
    global _lib, _error
    if _lib is not None:
        return _lib
    try:
        if not os.path.exists(LIB_PATH):
            subprocess.run(["make", "-C", NATIVE_DIR], check=True,
                           capture_output=True)
        _lib = _bind(ctypes.CDLL(LIB_PATH))
    except Exception as e:
        _error = f"{type(e).__name__}: {e}"
        raise
    _error = None
    return _lib


def _vec3(x, dtype, what: str) -> np.ndarray:
    v = np.ascontiguousarray(x, dtype).reshape(-1)
    if v.shape != (3,):
        raise ValueError(f"{what}: 3 entries, not {v.shape[0]}")
    return v


def _rows3(x, dtype, what: str) -> np.ndarray:
    a = np.ascontiguousarray(x, dtype)
    if a.ndim != 2 or a.shape[1] != 3:
        raise ValueError(f"{what}: shape (n, 3), not {a.shape}")
    return a


def density_grid(pos: np.ndarray, origin, cell_size, dims,
                 support_radius: float, particle_volume: float) -> np.ndarray:
    """(dims[0], dims[1], dims[2]) float32: sum over the particles of
    ``particle_volume * W(|x - pos|, support_radius)`` at the grid points
    ``origin + index * cell_size``."""
    lib = _load()
    pos = _rows3(pos, np.float32, "pos")
    origin = _vec3(origin, np.float32, "origin")
    cell = _vec3(cell_size, np.float32, "cell_size")
    dims = _vec3(dims, np.int32, "dims")
    if (dims < 1).any():
        raise ValueError(f"dims {dims.tolist()}: each at least 1")
    out = np.zeros(int(dims[0]) * int(dims[1]) * int(dims[2]), np.float32)
    lib.sph_density_grid(pos, pos.shape[0], origin, cell, dims,
                         support_radius, particle_volume, out)
    return out.reshape(dims[0], dims[1], dims[2])


def marching_tetrahedra(grid: np.ndarray, origin, cell_size, iso: float,
                        max_tris: int | None = None) -> np.ndarray:
    """(T, 3, 3) float32 triangle soup of ``grid`` at level ``iso``; at most
    ``max_tris`` triangles (by default twice the grid points, plus 1024)."""
    lib = _load()
    if np.ndim(grid) != 3:
        raise ValueError(f"grid: 3 dimensions, not {np.ndim(grid)}")
    dims = np.asarray(grid.shape, np.int32)
    flat = np.ascontiguousarray(grid, np.float32).ravel()
    origin = _vec3(origin, np.float32, "origin")
    cell = _vec3(cell_size, np.float32, "cell_size")
    if max_tris is None:
        max_tris = int(grid.size) * 2 + 1024
    if max_tris < 0:
        raise ValueError(f"max_tris {max_tris} < 0")
    out = np.empty(max_tris * 9, np.float32)
    n = lib.marching_tetrahedra(flat, dims, origin, cell, iso, out, max_tris)
    return out[: n * 9].reshape(int(n), 3, 3)


def mesh_inside(verts: np.ndarray, faces: np.ndarray,
                points: np.ndarray) -> np.ndarray:
    """(P,) bool: whether each point lies inside the closed mesh
    (``verts`` (V, 3), ``faces`` (F, 3) vertex indices)."""
    lib = _load()
    verts = _rows3(verts, np.float64, "verts")
    faces = _rows3(faces, np.int64, "faces")
    points = _rows3(points, np.float64, "points")
    if len(faces) and (faces.min() < 0 or faces.max() >= len(verts)):
        raise ValueError(f"faces index outside [0, {len(verts)})")
    out = np.zeros(points.shape[0], np.uint8)
    lib.mesh_inside(verts, verts.shape[0], faces, faces.shape[0],
                    points, points.shape[0], out)
    return out.astype(bool)


def available() -> bool:
    """Whether the library builds (if missing) and loads."""
    try:
        _load()
        return True
    except Exception:
        return False


def load_error() -> str | None:
    """Why the last attempt to build or load the library failed, or None."""
    return _error

"""The port's native helpers and offline pipeline against the JAX package's.

- ``sph_project_tpu_torch.native`` on tests/test_native.py's three cases
  (the density splat, marching tetrahedra on the sphere cloud, the inside
  test of a cube), each array bit-equal to ``sph_project_tpu.native``'s on
  the same inputs, and that file's own checks on the port's arrays;
- ``geometry.mesh.fill_lattice`` bit-equal in both packages on the six
  meshes of ``data/models_builtin/`` at pitch 0.02, voxel-centred and from
  the min bound, and the port's numpy ``inside_lattice`` equal to
  ``native.mesh_inside`` on those lattices (the fallback gives the same
  points);
- ``surface_reconstruction_torch.py``'s OBJ byte-equal to
  ``surface_reconstruction.py``'s, and ``render_torch.py``'s preview PNG
  byte-equal to ``render.py``'s (64 x 64, one worker), with the surface
  and with the raw particles, on a frame made from a seeded numpy cloud
  and written by the port's exporter. The JAX scripts run in a subprocess
  under ``JAX_PLATFORMS=cpu``.
"""
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

from test_torch_scene import ROOT  # noqa: F401  (one torch thread a process)
from test_native import _sphere_cloud
from test_rigid import write_cube_obj

from sph_project_tpu import native as jnative
from sph_project_tpu.geometry import mesh as jmesh

from sph_project_tpu_torch import native
from sph_project_tpu_torch.geometry import mesh
from sph_project_tpu_torch.io import exporters

MODELS = os.path.join(ROOT, "data", "models_builtin")
MESHES = sorted(f for f in os.listdir(MODELS) if f.endswith(".obj"))
PITCH = 0.02


def test_native_available():
    assert native.available(), native.load_error()
    assert native.load_error() is None
    assert native.LIB_PATH == os.path.join(ROOT, "native", "libsphnative.so")


def _splat_inputs(dims):
    origin = np.full(3, -0.01 * dims, np.float32)   # the grid's centre at 0
    return (_sphere_cloud(), origin, [0.02, 0.02, 0.02],
            np.array([dims] * 3, np.int32))


def test_density_grid_bit_equal():
    pts, origin, cell, dims = _splat_inputs(24)
    kw = dict(support_radius=0.04, particle_volume=0.8 * 0.02 ** 3)
    grid = native.density_grid(pts, origin, cell, dims, **kw)
    ref = jnative.density_grid(pts, origin, cell, dims, **kw)
    assert grid.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(grid, ref)
    # tests/test_native.py's checks: a normalised density, ~0.8 inside
    assert grid.shape == (24, 24, 24) and grid.min() >= 0.0
    assert grid[12, 12, 12] > 0.5 and grid[0, 0, 0] == 0.0


def test_marching_tetrahedra_bit_equal():
    pts, origin, cell, dims = _splat_inputs(26)
    grid = native.density_grid(pts, origin, cell, dims, 0.04,
                               0.8 * 0.02 ** 3)
    tris = native.marching_tetrahedra(grid, origin, cell, iso=0.45)
    ref = jnative.marching_tetrahedra(grid, origin, cell, iso=0.45)
    assert tris.dtype == ref.dtype == np.float32
    np.testing.assert_array_equal(tris, ref)
    # a closed surface near the sphere's radius (0.1)
    assert tris.shape[1:] == (3, 3) and tris.shape[0] > 100
    r = np.linalg.norm(tris.reshape(-1, 3), axis=1)
    assert r.max() < 0.1 + 0.04 + 0.02 and np.median(r) > 0.05
    capped = native.marching_tetrahedra(grid, origin, cell, 0.45, max_tris=7)
    np.testing.assert_array_equal(
        capped, jnative.marching_tetrahedra(grid, origin, cell, 0.45,
                                            max_tris=7))


def test_mesh_inside_bit_equal(tmp_path):
    verts, faces = mesh.load_obj(write_cube_obj(str(tmp_path / "cube.obj"),
                                                size=0.1))
    pts = np.random.RandomState(0).uniform(-0.1, 0.1, size=(500, 3))
    inside = native.mesh_inside(verts, faces, pts)
    ref = jnative.mesh_inside(verts, faces, pts)
    assert inside.dtype == ref.dtype == bool
    np.testing.assert_array_equal(inside, ref)
    on_surface = np.any(np.isclose(np.abs(pts), 0.05, atol=1e-6), axis=1)
    np.testing.assert_array_equal(inside[~on_surface],
                                  np.all(np.abs(pts) < 0.05, axis=1)[~on_surface])


def test_native_rejects_bad_shapes_and_indices():
    """What the C++ side would read out of bounds is refused before it is
    passed (the JAX module passes it as it is)."""
    cube = np.array([[0, 0, 0], [1, 0, 0], [0, 1, 0]], np.float64)
    pts = np.zeros((4, 3))
    with pytest.raises(ValueError, match="faces index"):
        native.mesh_inside(cube, np.array([[0, 1, 3]]), pts)
    with pytest.raises(ValueError, match="points"):
        native.mesh_inside(cube, np.array([[0, 1, 2]]), np.zeros((4, 2)))
    with pytest.raises(ValueError, match="dims"):
        native.density_grid(pts, [0, 0, 0], [1, 1, 1], [4, 4], 0.1, 1.0)
    with pytest.raises(ValueError, match="grid"):
        native.marching_tetrahedra(np.zeros((4, 4)), [0, 0, 0], [1, 1, 1],
                                   0.5)


def _lattice(verts, offset):
    lo, hi = verts.min(axis=0), verts.max(axis=0)
    start = lo + (0.5 * PITCH if offset else 0.0)
    axes = [np.arange(start[i], hi[i], PITCH) for i in range(3)]
    return np.stack(np.meshgrid(*axes, indexing="ij"), -1).reshape(-1, 3)


@pytest.mark.parametrize("offset", [True, False], ids=["centred", "min"])
@pytest.mark.parametrize("name", MESHES)
def test_fill_lattice_bit_equal(name, offset):
    verts, faces = mesh.load_obj(os.path.join(MODELS, name))
    jverts, jfaces = jmesh.load_obj(os.path.join(MODELS, name))
    np.testing.assert_array_equal(verts, jverts)
    np.testing.assert_array_equal(faces, jfaces)
    pts = mesh.fill_lattice(verts, faces, PITCH, offset_half_pitch=offset)
    ref = jmesh.fill_lattice(jverts, jfaces, PITCH, offset_half_pitch=offset)
    assert pts.dtype == ref.dtype == np.float32 and len(pts) > 0
    np.testing.assert_array_equal(pts, ref)


@pytest.mark.parametrize("offset", [True, False], ids=["centred", "min"])
@pytest.mark.parametrize("name", MESHES)
def test_inside_lattice_matches_native(name, offset):
    verts, faces = mesh.load_obj(os.path.join(MODELS, name))
    pts = _lattice(verts, offset)
    inside = native.mesh_inside(verts, faces, pts)
    assert inside.any()
    np.testing.assert_array_equal(mesh.inside_lattice(verts, faces, pts),
                                  inside)


# ---- the root scripts -------------------------------------------------------

def _run(script, *args):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, script, *args], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "FAILED" not in out.stdout and "done" in out.stdout, out.stdout
    return out.stdout


@pytest.fixture(scope="module")
def frames(tmp_path_factory):
    """A frame directory holding one particle PLY, written by the port's
    exporter from a seeded cloud (a jittered ball of radius 0.1 at spacing
    0.02), then copied once for each package's scripts; each copy surfaced
    by its package's reconstruction script."""
    base = tmp_path_factory.mktemp("frames")
    rng = np.random.default_rng(11)
    cloud = _sphere_cloud() + np.float32([0.5, 0.3, 0.5])
    cloud += rng.normal(0, 0.002, cloud.shape).astype(np.float32)
    src = base / "src" / "000000"
    os.makedirs(src)
    exporters.write_ply(str(src / "particle_object_1.ply"), cloud)
    dirs = {}
    for pkg, script in (("torch", "surface_reconstruction_torch.py"),
                        ("jax", "surface_reconstruction.py")):
        for kind in ("surface", "raw"):
            shutil.copytree(base / "src", base / pkg / kind)
        _run(script, "--input_dir", str(base / pkg / "surface"),
             "--num_workers", "1")
        dirs[pkg] = base / pkg
    return dirs


def test_surface_script_obj_byte_equal(frames):
    name = os.path.join("surface", "000000", "particle_object_1_surface.obj")
    port = (frames["torch"] / name).read_bytes()
    assert port == (frames["jax"] / name).read_bytes()
    v, f = mesh.load_obj(str(frames["torch"] / name))
    assert len(f) > 100 and np.isfinite(v).all()


@pytest.mark.parametrize("kind", ["surface", "raw"])
def test_render_script_png_byte_equal(frames, kind):
    args = ["--size", "64", "64", "--num_workers", "1"]
    _run("render_torch.py", "--input_dir", str(frames["torch"] / kind), *args)
    _run("render.py", "--input_dir", str(frames["jax"] / kind), *args)
    png = os.path.join(kind, "000000", "render.png")
    port = (frames["torch"] / png).read_bytes()
    assert port == (frames["jax"] / png).read_bytes()
    assert port.startswith(b"\x89PNG") and len(port) > 100

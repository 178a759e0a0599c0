"""Scene building: JSON config -> (Scene, SimState), on the host.

The JAX package's ``scene.py`` with the same parsing, seeding and packing, so
the particle arrays come out bit for bit the same. Left out:

- the TPU pair engines' window-cap estimators (``estimate_slab_sizes``,
  ``estimate_su``): the port's cell-list engine has no caps;
- the switch that turns the TPU sort kernel off for a large deferred entry
  (JAX ``scene.py`` :289-296): the port's gather permutes every row.

Objects with an ``entryTime`` above 0 are packed as ``MATERIAL_NONE`` rows
with their entry time and material beside them (the step activates them,
``sim.Plumbing.activate_entries``); ``gravitationUpper`` sets the emitter
height ``g_upper``.

Dynamic rigid bodies are sampled in their own frame and placed by their
(com, rot), as the JAX package places them (its ``scene.py`` :221-255); the
body table holds their mass, pose and velocity (:393-425).

The state is built on the CPU; ``Simulation`` moves it to its device.
"""
from __future__ import annotations

import math
import os
from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from .core.params import (MATERIAL_FLUID, MATERIAL_NONE, MATERIAL_RIGID,
                          SimParams, make_params)
from .core.state import RigidState, zeros_state
from .geometry import mesh as meshlib
from .geometry import shapes
from .utils.config import SimConfig

# a checkout of the reference project's assets, when one is named
ASSET_ROOT = os.environ.get("SPH_ASSET_ROOT", "")
# first-party procedural stand-ins for the reference's binary mesh assets
BUILTIN_MODELS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "data", "models_builtin")

def _resolve_path(path: str) -> str:
    if os.path.exists(path):
        return path
    alt = os.path.join(ASSET_ROOT, path.lstrip("./"))
    if ASSET_ROOT and os.path.exists(alt):
        return alt
    builtin = os.path.join(BUILTIN_MODELS, os.path.basename(path))
    if os.path.exists(builtin):
        return builtin
    raise FileNotFoundError(
        f"geometry file {path} (also tried {alt} and {builtin})")


@dataclass
class SceneObject:
    """Host-side metadata for one object (for export and inspection)."""
    object_id: int
    material: int
    is_dynamic: bool
    entry_time: float
    particle_num: int
    color: tuple = (255, 255, 255)
    visible: bool = True
    mesh_verts: np.ndarray | None = None
    mesh_faces: np.ndarray | None = None


@dataclass
class Scene:
    params: SimParams
    config: SimConfig
    objects: List[SceneObject] = field(default_factory=list)
    fluid_object_ids: List[int] = field(default_factory=list)
    rigid_object_ids: List[int] = field(default_factory=list)


def _euler_or_axis_rotation(body: dict, dynamic: bool) -> np.ndarray:
    angle = float(body.get("rotationAngle", 0.0)) / 360.0 * 2.0 * math.pi
    axis = np.asarray(body.get("rotationAxis", [0, 1, 0]), np.float64)
    if dynamic:
        # the Bullet path of the reference: Euler XYZ of axis * angle
        return meshlib.rotation_matrix_euler_xyz(axis * angle)
    # static bodies: trimesh axis-angle
    return meshlib.rotation_matrix_axis_angle(axis, angle)


def load_scene(scene_file: str | None = None, config: SimConfig | None = None,
               **param_overrides):
    """Build params + fully-seeded initial state (on the CPU) from a scene
    JSON. Returns ``(scene, state)``."""
    cfg = config if config is not None else SimConfig(scene_file)

    dim = len(cfg.get_cfg("domainEnd"))
    dx = cfg.get_cfg("particleRadius") or 0.01
    spacing = cfg.get_cfg("particleSpacing") or 2.0 * dx
    dh = cfg.get_cfg("supportRadius")
    g_upper = cfg.get_cfg("gravitationUpper")
    density0 = cfg.get_cfg("density0") or 1000.0
    add_domain_box = bool(cfg.get_cfg("addDomainBox"))
    box_thickness = 0.03 if add_domain_box else 0.0

    def _get(name, default):
        # explicit None test: a viscosity of 0.0 or a zero gravity vector is
        # a valid value and must not fall back to the default
        v = cfg.get_cfg(name)
        return default if v is None else v

    kw = dict(
        dim=dim,
        particle_radius=dx,
        particle_spacing=spacing,
        domain_start=tuple(_get("domainStart", (0.0,) * dim)),
        domain_end=tuple(cfg.get_cfg("domainEnd")),
        density0=density0,
        gravity=tuple(_get("gravitation", (0.0, -9.81, 0.0)[:dim])),
        dt=_get("timeStepSize", 1e-3),
        viscosity=_get("viscosity", 0.01),
        simulation_method=_get("simulationMethod", "dfsph"),
        viscosity_method=_get("viscosityMethod", "standard"),
        rigid_solver=_get("rigidSolver", "integrator"),
        wall_thickness=box_thickness,
    )
    if (cfg.get_cfg("simulationMethod") or "dfsph") == "pbf":
        kw["kernel_type"] = "poly6"
        ck = cfg.get_cfg("pbfCorrK")
        if ck is not None:
            kw["pbf_corr_k"] = ck
        cq = cfg.get_cfg("pbfCorrDeltaQ")
        if cq is not None:
            kw["pbf_corr_delta_q"] = cq
    for key, name, conv in (
            ("dfsphWarmStart", "dfsph_warm_start", bool),
            ("dfsphWarmStartDiv", "dfsph_warm_start_div", bool),
            ("dfsphWarmFactor", "dfsph_warm_factor", float),
            ("dfsphWarmFactorHi", "dfsph_warm_factor_hi", float),
            ("dfsphWarmGate", "dfsph_warm_gate", float),
            ("dfsphOmega", "dfsph_omega", float),
            ("dfsphWarmQuietCfl", "dfsph_warm_quiet_cfl", float),
            ("velCapCfl", "vel_cap_cfl", float),
            ("sortIncremental", "sort_incremental", bool)):
        v = cfg.get_cfg(key)
        if v is not None:
            kw[name] = conv(v)
    if dh is not None:
        kw["support_radius"] = dh
    if g_upper is not None:
        kw["g_upper"] = g_upper
    vb = cfg.get_cfg("viscosity_b")
    kw["viscosity_b"] = vb if vb is not None else kw["viscosity"]
    kw.update(param_overrides)

    # ---- collect every object's particles (host numpy) ---------------------
    chunks: list[dict] = []
    scene_objects: list[SceneObject] = []
    v0 = 0.8 * (2.0 * dx) ** dim

    def add_chunk(obj_id, pts, vel, dens, mat, dynamic, entry, color, visible,
                  rest_pos=None, mesh_vf=None):
        n = pts.shape[0]
        chunks.append(dict(
            obj_id=obj_id, pos=pts.astype(np.float32),
            vel=np.broadcast_to(np.asarray(vel, np.float32), (n, dim)).copy(),
            density=np.full(n, dens, np.float32),
            material=mat, dynamic=int(dynamic), entry=float(entry),
            rest_pos=(rest_pos if rest_pos is not None else pts).astype(np.float32),
        ))
        scene_objects.append(SceneObject(
            object_id=obj_id, material=mat, is_dynamic=bool(dynamic),
            entry_time=float(entry), particle_num=n, color=tuple(color),
            visible=bool(visible),
            mesh_verts=None if mesh_vf is None else mesh_vf[0],
            mesh_faces=None if mesh_vf is None else mesh_vf[1],
        ))

    fluid_ids, rigid_ids = [], []

    def _vec(v, default):
        # 2D scenes in the wild carry 3-vectors for translation/scale
        a = np.asarray(v if v is not None else default, np.float64)
        return a[:dim]

    for blk in cfg.get_fluid_blocks():
        offset = _vec(blk.get("translation"), [0.0] * dim)
        start = np.asarray(blk["start"], np.float64)[:dim] + offset
        end = np.asarray(blk["end"], np.float64)[:dim] + offset
        scale = _vec(blk.get("scale"), [1.0] * dim)
        pts = shapes.cube_lattice(start, (end - start) * scale, spacing)
        add_chunk(blk["objectId"], pts,
                  list(_vec(blk.get("velocity"), [0.0] * dim)),
                  blk.get("density", 1000.0), MATERIAL_FLUID, 1,
                  blk.get("entryTime", -1.0), blk.get("color", (50, 100, 200)),
                  blk.get("visible", 1))
        fluid_ids.append(blk["objectId"])

    for body in cfg.get_fluid_bodies():
        verts, faces = meshlib.load_obj(_resolve_path(body["geometryFile"]))
        verts = verts * np.asarray(body.get("scale", [1, 1, 1]), np.float64)
        angle = float(body.get("rotationAngle", 0.0)) / 360.0 * 2.0 * math.pi
        R = meshlib.rotation_matrix_axis_angle(
            np.asarray(body.get("rotationAxis", [0, 1, 0]), np.float64), angle)
        center = verts.mean(axis=0)
        verts = (verts - center) @ R.T + center
        verts = verts + np.asarray(body.get("translation", [0, 0, 0]), np.float64)
        pts = meshlib.fill_lattice(verts, faces, spacing, offset_half_pitch=False)
        add_chunk(body["objectId"], pts, body.get("velocity", [0.0] * dim),
                  body.get("density", 1000.0), MATERIAL_FLUID, 1,
                  body.get("entryTime", -1.0), body.get("color", (50, 100, 200)),
                  body.get("visible", 1))
        fluid_ids.append(body["objectId"])

    rigid_meta: dict[int, dict] = {}
    for body in cfg.get_rigid_bodies():
        obj_id = body["objectId"]
        dynamic = bool(body.get("isDynamic", False))
        verts, faces = meshlib.load_obj(_resolve_path(body["geometryFile"]))
        verts = verts * np.asarray(body.get("scale", [1, 1, 1]), np.float64)
        translation = np.asarray(body.get("translation", [0, 0, 0]), np.float64)
        R = _euler_or_axis_rotation(body, dynamic)
        if dynamic:
            # sampled in the body's frame, placed by (com, rot)
            body_pts = meshlib.fill_lattice(verts, faces, spacing)
            world_pts = body_pts @ R.T + translation
        else:
            center = verts.mean(axis=0)
            verts = (verts - center) @ R.T + center + translation
            body_pts = meshlib.fill_lattice(verts, faces, spacing)
            world_pts = body_pts
        vel = body.get("velocity", [0.0] * dim) if dynamic else [0.0] * dim
        add_chunk(obj_id, world_pts.astype(np.float32), vel,
                  body.get("density", 1000.0), MATERIAL_RIGID, dynamic,
                  body.get("entryTime", -1.0), body.get("color", (255, 255, 255)),
                  body.get("visible", 1),
                  rest_pos=body_pts.astype(np.float32),
                  mesh_vf=(verts, faces))
        rigid_ids.append(obj_id)
        rigid_meta[obj_id] = dict(
            dynamic=dynamic, translation=translation, rot=R,
            vel=np.asarray(vel, np.float64),
            mass=body.get("density", 1000.0) * v0 * world_pts.shape[0])

    if cfg.get_rigid_blocks():
        raise NotImplementedError("RigidBlocks (unimplemented in the reference too, "
                                  "base_container.py:106,346)")

    n_objects = len(chunks)
    domain_start = np.asarray(kw["domain_start"], np.float64)
    domain_end = np.asarray(kw["domain_end"], np.float64)
    if add_domain_box:
        pad = kw.get("support_radius", dx * (4.0 if dim == 3 else 3.0))
        box_lower = domain_start + pad
        box_size = (domain_end - domain_start) - 2 * pad
        pts = shapes.box_shell_lattice(box_lower, box_size, spacing, box_thickness)
        add_chunk(n_objects, pts, [0.0] * dim, density0, MATERIAL_RIGID, 0, -1.0,
                  (127, 127, 127), False)

    n_particles = sum(c["pos"].shape[0] for c in chunks)
    # emitters turn fluid rows into rigid placeholders
    kw["has_rigid"] = any(c["material"] == MATERIAL_RIGID for c in chunks) \
        or any(c["entry"] > 0 for c in chunks) or g_upper is not None
    kw["has_dynamic_rigid"] = any(
        c["material"] == MATERIAL_RIGID and c["dynamic"] for c in chunks)
    kw["has_entries"] = any(c["entry"] > 0 for c in chunks) or \
        g_upper is not None
    # one exact contact channel per dynamic rigid body; static geometry shares
    # one merged channel (rigid/integrator.py rigid_contact_data)
    if "contact_channels" not in param_overrides:
        kw["contact_channels"] = tuple(sorted(
            c["obj_id"] for c in chunks
            if c["material"] == MATERIAL_RIGID and c["dynamic"]))
    if "halo_plane_max" not in param_overrides:
        # max particles in one x-cell-plane of the seeded scene (kept so the
        # two packages resolve the same parameters)
        dh_eff = kw.get("support_radius", dx * (4.0 if dim == 3 else 3.0))
        xs = np.concatenate([c["pos"][:, 0] for c in chunks])
        planes = np.floor(
            (xs.astype(np.float64) - kw["domain_start"][0]) / dh_eff
        ).astype(np.int64)
        kw["halo_plane_max"] = int(np.bincount(
            planes - planes.min()).max()) if planes.size else 0
    params = make_params(n_particles, **kw)

    # ---- pack into the padded state ---------------------------------------
    n_pad = params.n_pad
    pos = np.zeros((n_pad, dim), np.float32)
    vel = np.zeros((n_pad, dim), np.float32)
    dens = np.zeros(n_pad, np.float32)
    mat = np.zeros(n_pad, np.int32)
    obj = np.full(n_pad, -1, np.int32)
    dyn = np.zeros(n_pad, np.int32)
    rest_pos = np.zeros((n_pad, dim), np.float32)
    entry_t = np.full(n_pad, -1.0, np.float32)
    entry_m = np.zeros(n_pad, np.int32)

    cursor = 0
    for c in chunks:
        n = c["pos"].shape[0]
        sl = slice(cursor, cursor + n)
        pos[sl] = c["pos"]
        vel[sl] = c["vel"]
        dens[sl] = c["density"]
        obj[sl] = c["obj_id"]
        dyn[sl] = c["dynamic"]
        rest_pos[sl] = c["rest_pos"]
        if c["entry"] > 0.0:
            entry_t[sl] = c["entry"]
            entry_m[sl] = c["material"]
            mat[sl] = MATERIAL_NONE
        else:
            mat[sl] = c["material"]
        cursor += n

    mass = (0.8 * params.particle_diameter ** dim) * dens  # V0 * density

    state = zeros_state(params)
    t = torch.from_numpy
    p = state.particles.replace(
        pos=t(pos), vel=t(vel), density=t(dens), mass=t(mass.astype(np.float32)),
        material=t(mat), object_id=t(obj), is_dynamic=t(dyn),
        rigid_rest_pos=t(rest_pos), entry_time=t(entry_t),
        entry_material=t(entry_m),
    )

    # ---- rigid body table ---------------------------------------------------
    O = params.max_objects
    r_mass = np.zeros(O, np.float32)
    r_com = np.zeros((O, dim), np.float32)
    r_com0 = np.zeros((O, dim), np.float32)
    r_rot = np.tile(np.eye(dim, dtype=np.float32), (O, 1, 1))
    r_vel = np.zeros((O, dim), np.float32)
    r_dyn = np.zeros(O, np.int32)
    r_mat = np.zeros(O, np.int32)
    r_entry = np.full(O, -1.0, np.float32)
    r_present = np.zeros(O, np.int32)
    for so in scene_objects:
        oid = so.object_id
        r_mat[oid] = so.material
        r_present[oid] = 1 if so.entry_time <= 0.0 else 0
        r_entry[oid] = so.entry_time
        if oid in rigid_meta:
            m = rigid_meta[oid]
            r_dyn[oid] = int(m["dynamic"])
            r_mass[oid] = m["mass"]
            if m["dynamic"]:
                r_com[oid] = m["translation"]
                r_rot[oid] = m["rot"].astype(np.float32)
                r_vel[oid] = m["vel"]

    rigid: RigidState = state.rigid.replace(
        mass=t(r_mass), com=t(r_com), com0=t(r_com0), rot=t(r_rot),
        vel=t(r_vel), is_dynamic=t(r_dyn), obj_material=t(r_mat),
        entry_time=t(r_entry), present=t(r_present))
    state = state.replace(particles=p, rigid=rigid)
    for oid in (cfg.get_cfg("invisibleObjects") or []):
        for so in scene_objects:
            if so.object_id == oid:
                so.visible = False
    scene = Scene(params=params, config=cfg, objects=scene_objects,
                  fluid_object_ids=fluid_ids, rigid_object_ids=rigid_ids)
    return scene, state


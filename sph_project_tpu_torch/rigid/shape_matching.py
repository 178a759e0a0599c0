"""The shape-matching rigid backend (Mueller et al. 2005).

The JAX package's ``rigid/shape_matching.py`` (line numbers below name its
functions), the counterpart of the reference's ShapeMatchingRigidSolver
(shipped there unused). Selected by ``rigid_solver="shape_matching"``: the
particles of each dynamic body integrate freely (gravity, the body's
accumulated force and, with unit inertia, its torque as a spin at each
particle's arm), are clamped to the inset domain walls, and are then placed
on the rigid transform that fits the moved cloud best, the rotation the
polar factor of the body's covariance. The DEM contact between bodies that
feeds the accumulated wrench is ``integrator.rigid_contact_wrench``.

Per-object sums are ``common.object_reduce`` (a fixed-order float32
product), reduced over the mesh under the spatial decomposition
(``common.global_tables``, :79 and :113-114), and reads of the body table
``common.object_gather``. The polar
factor takes ``torch.linalg.svd`` and ``torch.linalg.det`` of the (O, dim,
dim) covariances, as the JAX package takes ``jnp.linalg.svd`` and
``jnp.linalg.det`` outside any kernel; the products of small matrices are
sums of products, never a TF32 path.
"""
from __future__ import annotations

import torch

from ..core.params import MATERIAL_RIGID, SimParams
from ..core.state import ParticleState, RigidState, constant
from ..solvers.common import (cross, global_tables, matmul, matvec,
                              object_gather, object_index, object_reduce)


def _polar_rotation(A: torch.Tensor) -> torch.Tensor:
    """The rotation factor R of the polar decomposition A = R S, batched
    (:21): U V^T of the SVD, with U's last column scaled by det(U V^T) so
    that a reflection becomes a rotation."""
    U, _, Vh = torch.linalg.svd(A)
    det = torch.linalg.det(matmul(U, Vh))
    fix = torch.cat([torch.ones(det.shape + (A.shape[-1] - 1,),
                                dtype=A.dtype, device=A.device),
                     det[..., None]], -1)
    return matmul(U * fix[..., None, :], Vh)


def shape_matching_step(p: ParticleState, rigid: RigidState,
                        params: SimParams):
    """One projection (:34): integrate the dynamic rigid particles freely,
    clamp them to the walls, fit each body's rigid transform and place its
    particles on it, with the velocity of that motion; the walls take the
    velocity along every axis a body touched and damp the rest. Consumes and
    zeroes the accumulated force and torque. Returns (particles, bodies)."""
    O = params.max_objects
    dt = params.dt
    dim = params.dim
    dev = p.pos.device
    g = constant(tuple(params.gravity), torch.float32, dev)
    sel = (p.material == MATERIAL_RIGID) & (p.is_dynamic > 0) & \
        (p.object_id >= 0)
    obj = object_index(p, params)
    sel_v = sel[:, None]

    # free integration: gravity + the body force at the com + the torque as
    # a spin at each particle's arm (unit inertia)
    inv_m = torch.where(rigid.mass > 0,
                        1.0 / torch.clamp_min(rigid.mass, 1e-12),
                        torch.zeros_like(rigid.mass))
    tb = object_gather({"f": rigid.force * inv_m[:, None], "com": rigid.com,
                        "tq": rigid.torque}, obj)
    acc = g[None] + tb["f"]
    arm = p.pos - tb["com"]
    if dim == 3:
        spin = cross(tb["tq"], arm)
    else:
        w = tb["tq"][:, 0]
        spin = torch.stack([-w * arm[:, 1], w * arm[:, 0]], -1)
    vel = torch.where(sel_v, p.vel + dt * (acc + spin), p.vel)
    pos = torch.where(sel_v, p.pos + dt * vel, p.pos)

    # the walls before the fit, inset as the integrator's (:67)
    eps = params.padding + params.particle_diameter + params.wall_thickness
    lo = constant(tuple(params.domain_start), torch.float32, dev) + eps
    hi = constant(tuple(params.domain_end), torch.float32, dev) - eps
    clamped = torch.minimum(torch.maximum(pos, lo), hi)
    hit = (clamped != pos) & sel_v
    vel = torch.where(hit, torch.zeros_like(vel), vel)
    pos = torch.where(sel_v, clamped, pos)

    # per-body counts and centroids
    red = global_tables(object_reduce({"w": sel.to(torch.float32), "pos": pos,
                                       "rest": p.rigid_rest_pos}, obj, O,
                                      sel=sel), params)
    cnt = red["w"]
    cnt_safe = torch.clamp_min(cnt, 1.0)
    com = red["pos"] / cnt_safe[:, None]
    com0 = red["rest"] / cnt_safe[:, None]

    # the covariance A = sum (x - com)(q - com0)^T per body
    tc = object_gather({"com": com, "com0": com0}, obj)
    q = p.rigid_rest_pos - tc["com0"]
    x = pos - tc["com"]
    xq = (x[:, :, None] * q[:, None, :]).reshape(x.shape[0], -1)
    A = global_tables(object_reduce({"a": xq}, obj, O, sel=sel),
                      params)["a"].reshape(O, dim, dim)
    has = cnt > 0
    eye = torch.eye(dim, dtype=torch.float32, device=dev)[None]
    A = torch.where(has[:, None, None], A, eye)
    R = _polar_rotation(A)

    # the particles on the fitted transform, with the velocity of the motion
    goal = tc["com"] + matvec(object_gather({"r": R}, obj)["r"], q)
    new_vel = (goal - p.pos) / dt
    # restitution-0 walls: no velocity along an axis the body touched, the
    # rest damped by wall_friction (the integrator backend's walls)
    seg = torch.where(sel, obj, torch.full_like(obj, O))
    hit_axis = torch.zeros((O + 1, dim), dtype=torch.int32,
                           device=dev).scatter_reduce(
        0, seg[:, None].expand(-1, dim),
        hit.to(torch.int32), "amax")[:O]                          # (O, dim)
    hit_axis = global_tables({"h": hit_axis}, params, "max")["h"]
    body_hit = torch.any(hit_axis > 0, dim=-1)
    th = object_gather({"hx": hit_axis, "bh": body_hit}, obj)
    new_vel = torch.where(th["hx"] > 0, torch.zeros_like(new_vel), new_vel)
    new_vel = new_vel * torch.where(th["bh"], 1.0 - params.wall_friction,
                                    1.0)[:, None]
    p = p.replace(pos=torch.where(sel_v, goal, p.pos),
                  vel=torch.where(sel_v, new_vel, p.vel))
    active = (has & (rigid.is_dynamic > 0))[:, None]
    rigid = rigid.replace(
        com=torch.where(active, com, rigid.com),
        com0=torch.where(active, com0, rigid.com0),
        rot=torch.where(active[:, :, None], R, rigid.rot),
        vel=torch.where(active, (com - rigid.com) / dt, rigid.vel),
        force=torch.zeros_like(rigid.force),
        torque=torch.zeros_like(rigid.torque),
    )
    return p, rigid

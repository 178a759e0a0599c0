"""On-device rigid-body dynamics: integration and contact of dynamic bodies.

The JAX package's ``rigid/integrator.py`` (line numbers below name its
functions), integrator backend only. Bodies have unit inertia, as the
reference's URDFs give them, so omega_dot = torque. The order is Bullet's
semi-implicit Euler: forces -> velocities -> contact impulses -> positions ->
walls. Contact between bodies is an impulse solve over per-body contact
channels that one pair pass fills (``rigid_contact`` in ``ops/pair_kernels``);
the walls are a projection and a velocity clamp on each body's particle
extent. Everything stays on the device: nothing here reads a value on the
host, and the loop over ``contact_iters`` sweeps is over a parameter. Under
the spatial decomposition the contact tables and the extents are reduced
over the mesh (``common.global_tables``, :202-204 and :355-357), so every
rank steps the bodies alike.

In 2D a body turns in the plane: its angular velocity and torque are (O, 1)
and every cross product is ``common.pair_cross``'s scalar. The
shape-matching backend's DEM contact wrench (:func:`rigid_contact_wrench`)
is here too; its step is ``rigid/shape_matching.py``.
"""
from __future__ import annotations

import torch

from ..core.params import MATERIAL_RIGID, SimParams
from ..core.state import ParticleState, RigidState, constant
from ..ops import pair_kernels
from ..ops.pairs import PairEnv
from ..solvers.common import (global_tables, matmul, matvec, object_gather,
                              object_index, object_reduce, pair_cross,
                              reduce_wrench)


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(x * x, dim=-1))


def _rodrigues(omega: torch.Tensor, dt: float) -> torch.Tensor:
    """Rotation matrices of the incremental rotations omega * dt, (O, 3, 3)
    (:31)."""
    theta = _norm(omega)[:, None] * dt                              # (O, 1)
    axis = omega / torch.clamp_min(theta / dt, 1e-12)
    x, y, z = axis[:, 0], axis[:, 1], axis[:, 2]
    zero = torch.zeros_like(x)
    K = torch.stack([torch.stack([zero, -z, y], -1),
                     torch.stack([z, zero, -x], -1),
                     torch.stack([-y, x, zero], -1)], -2)            # (O, 3, 3)
    th = theta[..., None]
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)[None]
    return eye + torch.sin(th) * K + (1.0 - torch.cos(th)) * matmul(K, K)


def body_dynamic(rigid: RigidState) -> torch.Tensor:
    """(O,) bodies that integrate: dynamic, present and of rigid material."""
    return (rigid.is_dynamic > 0) & (rigid.present > 0) & \
        (rigid.obj_material == MATERIAL_RIGID)


def dynamic_rigid_mask(p: ParticleState, rigid: RigidState,
                       params: SimParams) -> torch.Tensor:
    """Particles of dynamic rigid bodies whose object is rigid (the JAX
    package's ``sim.dynamic_rigid_mask`` :177)."""
    obj_mat = rigid.obj_material[object_index(p, params)]
    return (p.material == MATERIAL_RIGID) & (p.is_dynamic > 0) & \
        (obj_mat == MATERIAL_RIGID)


def channel_table(rigid: RigidState, params: SimParams) -> torch.Tensor:
    """(max_objects,) i32: each object's contact channel, its index in
    ``params.contact_channels``; the last channel for static rigid objects,
    which all share it; -1 for any other object."""
    C = len(pair_kernels.contact_tags(params))
    table = [-1] * params.max_objects
    for c, oid in enumerate(params.contact_channels):
        table[oid] = c
    # made once per parameter set: a copy from the host cannot be captured
    chan = constant(tuple(table), torch.int32, rigid.mass.device)
    static = (rigid.obj_material == MATERIAL_RIGID) & (rigid.is_dynamic == 0)
    return torch.where(static & (chan < 0), torch.full_like(chan, C - 1),
                       chan).contiguous()


def rigid_contact_wrench(p: ParticleState, rigid: RigidState, env: PairEnv,
                         params: SimParams):
    """The DEM contact between different rigid bodies of the shape-matching
    backend (:47): per dynamic rigid particle the spring-damper force of the
    ``rigid_dem`` pair pass, its torque about the body's com, both summed
    per body. Returns (force (O, dim), torque (O, 3) or (O, 1))."""
    force_pp = pair_kernels.run(
        "rigid_dem", env,
        {"pos": p.pos, "vel": p.vel, "material": p.material,
         "object_id": p.object_id},
        params, produce=dynamic_rigid_mask(p, rigid, params))["f"]
    com_i = object_gather({"com": rigid.com},
                          object_index(p, params))["com"]
    torque_pp = pair_cross(p.pos - com_i, force_pp, params.dim)
    return reduce_wrench(force_pp, torque_pp, p, params)


def rigid_contact_data(p: ParticleState, rigid: RigidState, env: PairEnv,
                       params: SimParams) -> dict:
    """Per-particle, per-channel contact sums between rigid bodies (:106):
    on every particle of a dynamic body, for each channel, the
    penetration-weighted weight ``cw_<tag>`` (N,) and normal ``cn_<tag>``
    (N, dim) over the neighbours of that channel's body (or of any static
    geometry) within one particle diameter. One pair pass, produced only on
    the dynamic-rigid rows."""
    return pair_kernels.run(
        "rigid_contact", env,
        {"pos": p.pos, "material": p.material, "object_id": p.object_id,
         "chan": channel_table(rigid, params)},
        params, produce=dynamic_rigid_mask(p, rigid, params))


# sub-slots per body of the extents' scatter: rows spread over them by index,
# so that no slot takes more than N / EXTENT_SLOTS atomic updates (one slot
# per body took all 590k rows of dragon_bath, 0.68 ms per scatter on the H100)
EXTENT_SLOTS = 1024


def _extents(x: torch.Tensor, seg: torch.Tensor, O: int):
    """(O, dim) least and greatest of the rows of ``x`` per segment in [0, O],
    the empty ones at +-1e9; segment O takes the rows of no body."""
    big = 1e9
    dim = x.shape[1]
    slot = (seg * EXTENT_SLOTS + torch.arange(
        seg.shape[0], device=seg.device) % EXTENT_SLOTS)[:, None].expand(
            -1, dim)
    shape = ((O + 1) * EXTENT_SLOTS, dim)
    lo = torch.full(shape, big, device=x.device).scatter_reduce(
        0, slot, x, "amin")
    hi = torch.full(shape, -big, device=x.device).scatter_reduce(
        0, slot, x, "amax")
    return (lo.view(O + 1, EXTENT_SLOTS, dim).amin(1)[:O],
            hi.view(O + 1, EXTENT_SLOTS, dim).amax(1)[:O])


def _to_bodies(onehot: torch.Tensor, vals: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """Sums of the rows of ``vals`` (R, d) where ``mask``, per body of
    ``onehot`` (R, O): a fixed-order reduction, the same from run to run."""
    vals = torch.where(mask[:, None], vals, torch.zeros_like(vals))
    return (onehot[:, :, None] * vals[:, None, :]).sum(0)


def resolve_body_contacts(p: ParticleState, rigid: RigidState,
                          vel: torch.Tensor, omega: torch.Tensor,
                          contact: dict, params: SimParams):
    """Body-pair impulse contact with Coulomb friction (:160): the contact
    records reduced by the particle's own body into an (O, C) table of
    ordered pairs (row: the body that owns the particles; column: the touched
    dynamic body or the merged static channel), then ``contact_iters``
    sequential-impulse sweeps at each pair's weighted contact point and one
    mass-split positional de-penetration. Dynamic-dynamic pairs appear twice,
    so impulses apply at half strength. Returns (vel, omega, d_com)."""
    O = params.max_objects
    dim = params.dim
    tags = pair_kernels.contact_tags(params)
    C = len(tags)
    dev = vel.device
    packed = {}
    for tag in tags:
        w_c = contact[f"cw_{tag}"]
        packed[f"w_{tag}"] = w_c
        packed[f"n_{tag}"] = contact[f"cn_{tag}"]
        packed[f"p_{tag}"] = w_c[:, None] * p.pos
        packed[f"c_{tag}"] = (w_c > 1e-12).to(torch.float32)
    red = global_tables(object_reduce(packed, object_index(p, params), O),
                        params)
    W = torch.stack([red[f"w_{t}"] for t in tags], -1).reshape(O * C)
    N = torch.stack([red[f"n_{t}"] for t in tags], 1).reshape(O * C, dim)
    Pt = torch.stack([red[f"p_{t}"] for t in tags], 1).reshape(O * C, dim)
    cnt = torch.stack([red[f"c_{t}"] for t in tags], -1).reshape(O * C)

    active = W > 1e-12
    Ws = torch.clamp_min(W, 1e-12)
    n_hat = N / torch.clamp_min(_norm(N), 1e-12)[:, None]   # points toward a
    point = Pt / Ws[:, None]
    pen = Ws / torch.clamp_min(cnt, 1.0)                     # mean penetration

    ia = torch.arange(O * C, device=dev) // C
    # column -> touched body; the static channel maps to body 0, whose
    # inverse mass and inertia are forced to zero there
    ib = constant(tuple(params.contact_channels) + (0,), torch.int64,
                  dev).repeat(O)
    b_static = constant((False,) * (C - 1) + (True,), torch.bool,
                        dev).repeat(O)
    dyn = body_dynamic(rigid)
    mass = rigid.mass
    zero = torch.zeros_like(W)
    inv_ma = torch.where(dyn[ia] & (mass[ia] > 0),
                         1.0 / torch.clamp_min(mass[ia], 1e-12), zero)
    inv_mb = torch.where(dyn[ib] & (mass[ib] > 0) & ~b_static,
                         1.0 / torch.clamp_min(mass[ib], 1e-12), zero)
    inv_Ia = dyn[ia].to(torch.float32)                       # unit inertia
    inv_Ib = (dyn[ib] & ~b_static).to(torch.float32)
    # no self pairs (a dynamic channel exists for every row)
    active = active & ~((ia == ib) & ~b_static)

    r_a = point - rigid.com[ia]
    r_b = point - rigid.com[ib]
    ra_x_n = pair_cross(r_a, n_hat, dim)
    rb_x_n = pair_cross(r_b, n_hat, dim)
    K = inv_ma + inv_mb + torch.sum(ra_x_n * ra_x_n, -1) * inv_Ia + \
        torch.sum(rb_x_n * rb_x_n, -1) * inv_Ib
    ok = active & (K > 1e-12)
    e = params.contact_restitution
    mu = params.contact_friction
    onehot_a = (ia[:, None] == torch.arange(O, device=dev)).to(torch.float32)
    onehot_b = (ib[:, None] == torch.arange(O, device=dev)).to(torch.float32)

    def point_vel(v, om, idx, r):
        if dim == 3:
            return v[idx] + pair_cross(om[idx], r, dim)
        w = om[idx][:, 0]
        return v[idx] + torch.stack([-w * r[:, 1], w * r[:, 0]], -1)

    jn_acc = torch.zeros_like(W)
    for _ in range(max(params.contact_iters, 1)):
        va = point_vel(vel, omega, ia, r_a)
        vb = torch.where(b_static[:, None], torch.zeros_like(r_b),
                         point_vel(vel, omega, ib, r_b))
        vrel = va - vb
        vn = torch.sum(vrel * n_hat, -1)                     # < 0: closing
        j = torch.where(ok & (vn < 0.0),
                        -(1.0 + e) * vn / torch.clamp_min(K, 1e-12), zero)
        j = 0.5 * j                                          # ordered-pair dup
        jn_acc = jn_acc + j
        # Coulomb friction against the tangential point velocity, clamped by
        # mu * the accumulated normal impulse
        vt = vrel - vn[:, None] * n_hat
        vt_len = _norm(vt)
        t_hat = vt / torch.clamp_min(vt_len, 1e-9)[:, None]
        ra_x_t = pair_cross(r_a, t_hat, dim)
        rb_x_t = pair_cross(r_b, t_hat, dim)
        Kt = inv_ma + inv_mb + torch.sum(ra_x_t * ra_x_t, -1) * inv_Ia + \
            torch.sum(rb_x_t * rb_x_t, -1) * inv_Ib
        jt = torch.where(ok & (Kt > 1e-12),
                         0.5 * vt_len / torch.clamp_min(Kt, 1e-12), zero)
        jt = torch.minimum(jt, mu * jn_acc)
        imp = j[:, None] * n_hat - jt[:, None] * t_hat
        dwa = inv_Ia[:, None] * pair_cross(r_a, imp, dim)
        dwb = (-inv_Ib[:, None]) * pair_cross(r_b, imp, dim)
        vel = vel + _to_bodies(onehot_a, imp * inv_ma[:, None], ok) \
            + _to_bodies(onehot_b, -imp * inv_mb[:, None], ok)
        omega = omega + _to_bodies(onehot_a, dwa, ok) \
            + _to_bodies(onehot_b, dwb, ok)

    # positional de-penetration, mass-split, half per ordered pair
    inv_sum = torch.clamp_min(inv_ma + inv_mb, 1e-12)
    push = torch.where(ok, 0.5 * 0.5 * pen, zero)            # relax 0.5
    dca = (push * inv_ma / inv_sum)[:, None] * n_hat
    dcb = -(push * inv_mb / inv_sum)[:, None] * n_hat
    d_com = _to_bodies(onehot_a, dca, ok) + _to_bodies(onehot_b, dcb, ok)
    return vel, omega, d_com


def rigid_body_step(p: ParticleState, rigid: RigidState, params: SimParams,
                    contact: dict | None = None) -> RigidState:
    """Integrate the dynamic bodies one dt, resolve their contacts and walls,
    and zero the accumulated SPH force and torque (:301)."""
    dt = params.dt
    dev = rigid.vel.device
    g = constant(tuple(params.gravity), torch.float32, dev)
    dyn = body_dynamic(rigid)
    inv_m = torch.where(rigid.mass > 0,
                        1.0 / torch.clamp_min(rigid.mass, 1e-12),
                        torch.zeros_like(rigid.mass))
    vel = rigid.vel + dt * (g[None] + rigid.force * inv_m[:, None])
    omega = rigid.omega + dt * rigid.torque        # unit inertia
    d_com = 0.0
    if contact is not None:
        vel, omega, d_com = resolve_body_contacts(p, rigid, vel, omega,
                                                  contact, params)
    com = rigid.com + dt * vel + d_com
    if params.dim == 3:
        rot = matmul(_rodrigues(omega, dt), rigid.rot)
    else:
        th = omega[:, 0] * dt
        c, s = torch.cos(th), torch.sin(th)
        drot = torch.stack([torch.stack([c, -s], -1),
                            torch.stack([s, c], -1)], -2)
        rot = matmul(drot, rigid.rot)

    # walls: the reference's Bullet walls, inset by eps from the domain
    eps = params.padding + params.particle_diameter + params.wall_thickness
    lo = constant(tuple(params.domain_start), torch.float32, dev) + eps
    hi = constant(tuple(params.domain_end), torch.float32, dev) - eps
    # each body's particle extent in its new pose x = com + R q
    O = params.max_objects
    obj = object_index(p, params)
    is_body = (p.material == MATERIAL_RIGID) & (p.is_dynamic > 0) & \
        (p.object_id >= 0)
    t = object_gather({"com0": rigid.com0, "com": com, "rot": rot}, obj)
    x_new = t["com"] + matvec(t["rot"], p.rigid_rest_pos - t["com0"])
    bmin, bmax = _extents(x_new, torch.where(is_body, obj,
                                             torch.full_like(obj, O)), O)
    bmin = global_tables({"b": bmin}, params, "min")["b"]
    bmax = global_tables({"b": bmax}, params, "max")["b"]
    pen_lo = torch.clamp_min(lo[None] - bmin, 0.0)
    pen_hi = torch.clamp_min(bmax - hi[None], 0.0)
    has_particles = bmin[:, 0] < 1e9
    correction = torch.where((dyn & has_particles)[:, None], pen_lo - pen_hi,
                             torch.zeros_like(pen_lo))
    com = com + correction
    # no inward normal velocity on contact (restitution 0, like Bullet's
    # default); tangential and angular motion damped for stable stacking
    contact_lo = pen_lo > 0.0
    contact_hi = pen_hi > 0.0
    vel = torch.where(contact_lo, torch.clamp_min(vel, 0.0), vel)
    vel = torch.where(contact_hi, torch.clamp_max(vel, 0.0), vel)
    any_contact = torch.any(contact_lo | contact_hi, dim=-1)
    damp = torch.where(any_contact, 1.0 - params.wall_friction, 1.0)
    vel = vel * damp[:, None]
    omega = omega * damp[:, None]

    keep = dyn[:, None]
    return rigid.replace(
        com=torch.where(keep, com, rigid.com),
        vel=torch.where(keep, vel, rigid.vel),
        omega=torch.where(keep, omega, rigid.omega),
        rot=torch.where(keep[:, :, None], rot, rigid.rot),
        force=torch.zeros_like(rigid.force),
        torque=torch.zeros_like(rigid.torque),
    )

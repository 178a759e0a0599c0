"""Shared SPH operators of the ported steps, over the pair kernels.

The subset of the JAX package's ``solvers/common.py`` that DFSPH, WCSPH,
PCISPH, IISPH and PBF steps with standard or implicit viscosity over fluid,
static walls, dynamic rigid bodies and emitters run (line numbers name the
JAX original). The kernel kind (``params.kernel_type``) reaches every pass
through the pair bodies and :mod:`ops.kernels`; PBF's passes run in 2D too. Per-particle
arithmetic is plain tensor code; every neighbour sum goes through
``ops.pair_kernels.run``.

Per-object tables are read per particle by plain indexing (``object_gather``:
exact, as the JAX one-hot product is). Per-object sums (``object_reduce``)
are the JAX package's float32 one-hot product: its order is fixed, so a
trajectory is the same from run to run on the card, where float atomics
(``index_add_``) would add in another order every time. A product of small
3x3 matrices is written out as sums of products, never a batched matmul.

Under the spatial decomposition (``params.spmd_axis`` set, see
``parallel/spatial.py``) each rank holds a slice of the particles, and the
reductions over particles end in an all-reduce over the mesh the axis names:
:func:`global_sum`, :func:`global_max` and :func:`global_tables` (the
per-object wrench, contact and extent tables).
"""
from __future__ import annotations

import torch

from ..core.params import MATERIAL_FLUID, MATERIAL_RIGID, SimParams
from ..core.state import ParticleState, RigidState, constant
from ..ops import kernels
from ..ops import pair_kernels
from ..ops.pairs import PairEnv
from ..parallel import collectives


def global_sum(x: torch.Tensor, params: SimParams) -> torch.Tensor:
    """Sum over all particles (:49), of every rank's under ``spmd_axis``.
    Float inputs are added in float64 and the total rounded to float32
    once. A float32 sum rounds in an order that depends on how the rows are
    split (over ranks, or over a reduction's threads); the float64 totals
    of two splits differ by at most about n * 1e-16 relative, so they round
    to the same float32 value unless one lies that close to a float32
    rounding boundary. The corrector errors and the CG's dots then come out
    alike on one device and on a mesh, in all but that rare case, where the
    two can still differ in the last bit and the trajectories part.

    This holds on one device too, so there the port departs from the JAX
    package, which adds in float32: a total may differ from its in the last
    bit."""
    if not x.is_floating_point():
        s = torch.sum(x)
    else:
        s = torch.sum(x, dtype=torch.float64)
    if params.spmd_axis:
        s = collectives.all_reduce(s, "sum",
                                   collectives.mesh_of(params.spmd_axis))
    return s.to(torch.float32) if x.is_floating_point() else s


def loop_start(iterations: int, dev):
    """A solver loop's carried (iterations, error) at entry: an int32 count
    and a float32 +inf error (the JAX loops' ``jnp.int32(0)`` and
    ``jnp.float32(jnp.inf)``), made on ``dev``."""
    return (torch.full((), iterations, dtype=torch.int32, device=dev),
            torch.full((), float("inf"), dtype=torch.float32, device=dev))


def global_max(x: torch.Tensor, params: SimParams) -> torch.Tensor:
    """:59."""
    m = torch.max(x)
    if params.spmd_axis:
        m = collectives.all_reduce(m, "max",
                                   collectives.mesh_of(params.spmd_axis))
    return m


def global_tables(tables: dict, params: SimParams, op: str = "sum") -> dict:
    """Per-object tables of this rank's rows reduced over the mesh (``op``:
    sum, max, min; :66 ``global_wrench``, and the psum / pmin / pmax of the
    rigid modules), one all-reduce for the dict; as they are on one
    device."""
    if not params.spmd_axis:
        return tables
    return collectives.all_reduce_tables(
        tables, op, collectives.mesh_of(params.spmd_axis))


def _fluid(p: ParticleState) -> torch.Tensor:
    return p.material == MATERIAL_FLUID


def rigid_dyn(p: ParticleState) -> torch.Tensor:
    """Rows of dynamic rigid particles, whose wrench sums are read."""
    return (p.material == MATERIAL_RIGID) & (p.is_dynamic > 0)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Cross product of 3-vectors in the last axis."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], -1)


def pair_cross(a: torch.Tensor, b: torch.Tensor, dim: int) -> torch.Tensor:
    """:func:`cross` in 3D; in 2D the scalar torque a0 b1 - a1 b0, (..., 1)
    (:75)."""
    if dim == 3:
        return cross(a, b)
    return (a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0])[..., None]


def matvec(m: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``m @ v`` per row for (..., d, d) and (..., d), as sums of products."""
    return (m * v[..., None, :]).sum(-1)


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``a @ b`` for small (..., d, d) matrices, as sums of products."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def object_index(p: ParticleState, params: SimParams) -> torch.Tensor:
    """Each row's object id clipped into the body table (:170)."""
    return torch.clamp(p.object_id, 0, params.max_objects - 1).long()


def object_gather(tables: dict, obj: torch.Tensor) -> dict:
    """``{k: t[obj]}`` for small per-object tables (:92)."""
    return {k: t[obj] for k, t in tables.items()}


def object_reduce(vals: dict, obj: torch.Tensor, O: int,
                  sel: torch.Tensor | None = None) -> dict:
    """Per-object sums of per-particle rows, (N,) or (N, d) (:124): one
    float32 product of the transposed one-hot of ``obj`` with the packed
    rows. Rows with ``sel`` False contribute nothing. The product runs in
    full float32: TF32 must be off for matrix products on the card."""
    if torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError("object_reduce needs float32 matrix products: "
                           "torch.backends.cuda.matmul.allow_tf32 is set")
    onehot = obj[:, None] == torch.arange(O, device=obj.device)[None]
    if sel is not None:
        onehot = onehot & sel[:, None]
    names = sorted(vals)
    cols = [vals[k].reshape(vals[k].shape[0], -1).to(torch.float32)
            for k in names]
    out = onehot.to(torch.float32).T @ torch.cat(cols, 1)
    res, off = {}, 0
    for k, c in zip(names, cols):
        res[k] = out[:, off:off + c.shape[1]].reshape(
            (O,) + tuple(vals[k].shape[1:]))
        off += c.shape[1]
    return res


def reduce_wrench(force_pp: torch.Tensor, torque_pp: torch.Tensor,
                  p: ParticleState, params: SimParams):
    """Per-rigid-particle wrenches summed into per-object wrenches (:151)."""
    sel = rigid_dyn(p) & (p.object_id >= 0)
    out = global_tables(object_reduce({"f": force_pp, "t": torque_pp},
                                      object_index(p, params),
                                      params.max_objects, sel=sel), params)
    return out["f"], out["t"]


def wrench_of(fpp: torch.Tensor, p: ParticleState, rigid: RigidState,
              params: SimParams):
    """(force, torque) per object from per-rigid-row force sums whose arm is
    the row's offset from its body's com (:440-445)."""
    com_i = rigid.com[object_index(p, params)]
    torque_pp = pair_cross(p.pos - com_i, fpp, params.dim)
    return reduce_wrench(fpp, torque_pp, p, params)


def wrench_flags(params: SimParams) -> int:
    """The pair bodies' flag that adds the dynamic-rigid outputs."""
    return pair_kernels.RIGID if params.has_dynamic_rigid else 0


def compute_rigid_particle_volume(p: ParticleState, env: PairEnv,
                                  params: SimParams) -> ParticleState:
    """Per-step Akinci volumes of the dynamic rigid particles (:188) from
    their current positions, on the environment of the last sort: a body
    moves rigidly, so every same-object pair within the radius now was one
    then too, and the engine's candidates still hold it."""
    s = pair_kernels.run("rigid_volume", env,
                         {"pos": p.pos, "object_id": p.object_id}, params,
                         produce=rigid_dyn(p))["s"]
    return apply_rigid_volume(p, s, params)


def apply_rigid_volume(p: ParticleState, s: torch.Tensor,
                       params: SimParams) -> ParticleState:
    """Fold a same-object kernel sum into the pseudo-volumes and masses of
    the dynamic rigid particles at or below g_upper (:210); static walls keep
    the volumes of prepare."""
    denom = kernels.W0(params.support_radius, params.dim,
                       params.kernel_type) + s
    vol = 1.0 / torch.clamp_min(denom, 1e-30)
    sel = rigid_dyn(p) & (p.pos[:, 1] <= params.g_upper)
    return p.replace(
        rest_volume=torch.where(sel, vol, p.rest_volume),
        mass=torch.where(sel, params.density0 * vol, p.mass),
    )


def renew_rigid_particle_state(p: ParticleState, rigid: RigidState,
                               params: SimParams) -> ParticleState:
    """x = com + R q, v = v_body + omega x (R q) for dynamic rigid particles
    (:628)."""
    t = object_gather({"com0": rigid.com0, "com": rigid.com, "rot": rigid.rot,
                       "omega": rigid.omega, "vel": rigid.vel,
                       "dyn": rigid.is_dynamic}, object_index(p, params))
    sel = rigid_dyn(p) & (t["dyn"] > 0) & (p.object_id >= 0)
    rotq = matvec(t["rot"], p.rigid_rest_pos - t["com0"])
    new_pos = t["com"] + rotq
    if params.dim == 3:
        spin = cross(t["omega"], rotq)
    else:
        w = t["omega"][:, 0]
        spin = torch.stack([-w * rotq[:, 1], w * rotq[:, 0]], -1)
    new_vel = t["vel"] + spin
    return p.replace(pos=torch.where(sel[:, None], new_pos, p.pos),
                     vel=torch.where(sel[:, None], new_vel, p.vel))


def compute_rigid_volume_fixedk(p: ParticleState, env: PairEnv,
                                params: SimParams) -> ParticleState:
    """Prepare-time Akinci volumes of the rigid particles at or below g_upper
    (:230): V_b = 1 / (W(0) + sum over same-object neighbours of W). Emitter
    placeholders, rigid rows above g_upper, keep their fluid volume and
    mass. The JAX package takes the sum over its fixed-K neighbour list;
    here it is one pass of the pair engine, over the selected rows."""
    sel = (p.material == MATERIAL_RIGID) & (p.pos[:, 1] <= params.g_upper)
    s = pair_kernels.run("rigid_volume", env,
                         {"pos": p.pos, "object_id": p.object_id}, params,
                         produce=sel)["s"]
    denom = kernels.W0(params.support_radius, params.dim,
                       params.kernel_type) + s
    vol = 1.0 / torch.clamp_min(denom, 1e-30)
    return p.replace(
        rest_volume=torch.where(sel, vol, p.rest_volume),
        mass=torch.where(sel, params.density0 * vol, p.mass),
    )


def compute_density(p: ParticleState, env: PairEnv,
                    params: SimParams) -> torch.Tensor:
    """rho_i = rho0 (V_i W(0) + sum_j V_j W_ij) for fluid rows (:261)."""
    s = pair_kernels.run("density", env,
                         {"pos": p.pos, "rest_volume": p.rest_volume},
                         params)["s"]
    dens = (p.rest_volume * kernels.W0(params.support_radius, params.dim,
                                       params.kernel_type) + s) * params.density0
    return torch.where(_fluid(p), dens, p.density)


def gravity_acceleration(p: ParticleState, params: SimParams) -> torch.Tensor:
    """Assign (not add) g to fluid particles (:280)."""
    g = constant(tuple(params.gravity), torch.float32, p.pos.device)
    return torch.where(_fluid(p)[:, None], g[None, :], torch.zeros_like(p.acc))


def _inv_rho(p: ParticleState) -> torch.Tensor:
    return 1.0 / torch.where(p.density > 0, p.density,
                             torch.ones_like(p.density))


def nonpressure_fields(p: ParticleState) -> dict:
    """The fields the non-pressure pair body reads."""
    return {"pos": p.pos, "vel": p.vel, "material": p.material,
            "mass": p.mass, "rest_volume": p.rest_volume,
            "inv_rho": _inv_rho(p), "is_dynamic": p.is_dynamic}


def nonpressure_reduce(out: dict, p: ParticleState, rigid: RigidState,
                       params: SimParams):
    """The non-pressure sums ``st``, ``acc`` and, with dynamic rigid bodies,
    the viscosity wrench ``fpp`` as (acceleration, rigid force, rigid torque)
    (:431)."""
    fluid_i = _fluid(p)[:, None]
    a_st = -params.surface_tension / torch.clamp_min(p.mass, 1e-12)[:, None] \
        * out["st"]
    a = torch.where(fluid_i, a_st + out["acc"] / params.density0,
                    torch.zeros_like(p.acc))
    if not params.has_dynamic_rigid:
        return a, torch.zeros_like(rigid.force), torch.zeros_like(rigid.torque)
    return (a, *wrench_of(out["fpp"], p, rigid, params))


def nonpressure_fused(p: ParticleState, rigid: RigidState, env: PairEnv,
                      params: SimParams):
    """Surface tension + standard viscosity (+ the viscosity wrench on
    dynamic rigid rows) in one pair pass (:448, with :380
    _nonpressure_outputs). Returns (acceleration, rigid force, rigid
    torque)."""
    out = pair_kernels.run("nonpressure", env, nonpressure_fields(p), params,
                           flags=wrench_flags(params))
    return nonpressure_reduce(out, p, rigid, params)


def pressure_acceleration(p: ParticleState, rigid: RigidState, env: PairEnv,
                          params: SimParams,
                          pressure: torch.Tensor | None = None,
                          with_wrench: bool = False):
    """a_i = -sum_j m_j (p_i/rho_i^2 + p_j/rho_j^2) gradW (fluid j), the
    mirrored rigid term with rho0 (rigid j), on fluid dynamic rows, and with
    ``with_wrench`` the pressure force and torque on each dynamic body, the
    torque summed per pair about the fluid particle's position (:479).
    p/rho^2 is taken once per particle (:496). Returns (acceleration, rigid
    force, rigid torque)."""
    if pressure is None:
        pressure = p.pressure
    p_rho2 = pressure / torch.clamp_min(p.density * p.density, 1e-12)
    fields = {"pos": p.pos, "material": p.material, "mass": p.mass,
              "rest_volume": p.rest_volume, "p_rho2": p_rho2}
    if with_wrench:
        fields.update(is_dynamic=p.is_dynamic, object_id=p.object_id,
                      com=rigid.com.contiguous())
    out = pair_kernels.run("pressure", env, fields, params,
                           flags=pair_kernels.RIGID if with_wrench else 0)
    keep = _fluid(p) & (p.is_dynamic > 0)
    a = torch.where(keep[:, None], out["acc"], torch.zeros_like(out["acc"]))
    if not with_wrench:
        return a, torch.zeros_like(rigid.force), torch.zeros_like(rigid.torque)
    return (a, *reduce_wrench(out["fpp"], out["tpp"], p, params))


def update_fluid_velocity(p: ParticleState, params: SimParams) -> ParticleState:
    """:560."""
    return p.replace(vel=torch.where(_fluid(p)[:, None],
                                     p.vel + params.dt * p.acc, p.vel))


def update_fluid_position(p: ParticleState, rigid: RigidState,
                          params: SimParams) -> ParticleState:
    """Advance fluid positions (:565), after the CFL speed cap of
    ``params.vel_cap_cfl`` particle diameters per step. Emitter placeholders
    (non-fluid rows of a fluid object above g_upper) advect at their own
    velocity and turn fluid once they sink to g_upper or below."""
    fluid = _fluid(p)
    vel = p.vel
    if params.vel_cap_cfl > 0:
        cap = constant(params.vel_cap_cfl * params.particle_diameter
                       / params.dt, torch.float32, vel.device)
        sp2 = torch.sum(vel * vel, dim=-1, keepdim=True)
        scale = torch.where(sp2 > cap * cap,
                            cap / torch.sqrt(torch.clamp_min(sp2, 1e-30)),
                            torch.ones_like(sp2))
        vel = torch.where(fluid[:, None], vel * scale, vel)
    obj_mat = rigid.obj_material[object_index(p, params)]
    obj_is_fluid = (obj_mat == MATERIAL_FLUID) & (p.object_id >= 0)
    emitter = ~fluid & (p.pos[:, 1] > params.g_upper) & obj_is_fluid
    move = (fluid | emitter)[:, None]
    new_pos = torch.where(move, p.pos + params.dt * vel, p.pos)
    became_fluid = emitter & (new_pos[:, 1] <= params.g_upper)
    material = torch.where(became_fluid, MATERIAL_FLUID, p.material)
    return p.replace(pos=new_pos, vel=vel, material=material)


def prepare_emitter(p: ParticleState, params: SimParams) -> ParticleState:
    """Fluid particles above g_upper become rigid placeholders (:596)."""
    flip = _fluid(p) & (p.pos[:, 1] > params.g_upper)
    return p.replace(material=torch.where(flip, MATERIAL_RIGID, p.material))


def enforce_domain_boundary(p: ParticleState, params: SimParams,
                            material: int = MATERIAL_FLUID) -> ParticleState:
    """Clamp particles of ``material`` into the padded domain and reflect the
    normal velocity with restitution loss c_f = 0.5 (:603)."""
    dev = p.pos.device
    lo = constant(tuple(params.domain_start), torch.float32,
                  dev) + params.padding
    hi = constant(tuple(params.domain_end), torch.float32,
                  dev) - params.padding
    sel = (p.material == material) & (p.is_dynamic > 0)
    over = p.pos > hi
    under = p.pos <= lo
    normal = over.to(torch.float32) - under.to(torch.float32)
    new_pos = torch.minimum(torch.maximum(p.pos, lo), hi)
    nlen = torch.linalg.vector_norm(normal, dim=-1)
    hit = sel & (nlen > 1e-6)
    n_unit = normal / torch.clamp_min(nlen, 1e-12)[:, None]
    c_f = 0.5
    v_dot_n = torch.sum(p.vel * n_unit, dim=-1)
    new_vel = p.vel - (1.0 + c_f) * v_dot_n[:, None] * n_unit
    pos = torch.where(sel[:, None], new_pos, p.pos)
    vel = torch.where(hit[:, None], new_vel, p.vel)
    return p.replace(pos=pos, vel=vel)

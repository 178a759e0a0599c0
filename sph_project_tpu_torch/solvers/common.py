"""Shared SPH operators of the ported steps, over the pair kernels.

The subset of the JAX package's ``solvers/common.py`` that DFSPH, WCSPH,
PCISPH and IISPH steps with standard viscosity over fluid and static walls
run (line numbers name the JAX original). Per-particle arithmetic is plain
tensor code; every neighbour sum goes through ``ops.pair_kernels.run``.
"""
from __future__ import annotations

import torch

from ..core.params import MATERIAL_FLUID, MATERIAL_RIGID, SimParams
from ..core.state import ParticleState, RigidState
from ..ops import kernels
from ..ops import pair_kernels
from ..ops.pairs import PairEnv


def global_sum(x: torch.Tensor, params: SimParams) -> torch.Tensor:
    """Sum over all particles (:49). Float inputs sum in float32."""
    return torch.sum(x)


def global_max(x: torch.Tensor, params: SimParams) -> torch.Tensor:
    """:59."""
    return torch.max(x)


def _fluid(p: ParticleState) -> torch.Tensor:
    return p.material == MATERIAL_FLUID


def compute_rigid_volume_fixedk(p: ParticleState, env: PairEnv,
                                params: SimParams) -> ParticleState:
    """Prepare-time Akinci volumes of all rigid particles (:230):
    V_b = 1 / (W(0) + sum over same-object neighbours of W). The JAX package
    takes the sum over its fixed-K neighbour list; here it is one pass of the
    pair engine, over the rigid rows."""
    sel = p.material == MATERIAL_RIGID
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
    g = torch.tensor(params.gravity, dtype=torch.float32, device=p.pos.device)
    return torch.where(_fluid(p)[:, None], g[None, :], torch.zeros_like(p.acc))


def _inv_rho(p: ParticleState) -> torch.Tensor:
    return 1.0 / torch.where(p.density > 0, p.density,
                             torch.ones_like(p.density))


def nonpressure_fields(p: ParticleState) -> dict:
    """The fields the non-pressure pair body reads."""
    return {"pos": p.pos, "vel": p.vel, "material": p.material,
            "mass": p.mass, "rest_volume": p.rest_volume,
            "inv_rho": _inv_rho(p)}


def nonpressure_reduce(out: dict, p: ParticleState, rigid: RigidState,
                       params: SimParams):
    """The non-pressure sums ``st`` and ``acc`` as (acceleration, rigid force,
    rigid torque) (:431); the wrench is zero without dynamic rigid bodies."""
    fluid_i = _fluid(p)[:, None]
    a_st = -params.surface_tension / torch.clamp_min(p.mass, 1e-12)[:, None] \
        * out["st"]
    a = torch.where(fluid_i, a_st + out["acc"] / params.density0,
                    torch.zeros_like(p.acc))
    return a, torch.zeros_like(rigid.force), torch.zeros_like(rigid.torque)


def nonpressure_fused(p: ParticleState, rigid: RigidState, env: PairEnv,
                      params: SimParams):
    """Surface tension + standard viscosity in one pair pass (:448, with
    :380 _nonpressure_outputs). Returns (acceleration, rigid force, rigid
    torque)."""
    out = pair_kernels.run("nonpressure", env, nonpressure_fields(p), params)
    return nonpressure_reduce(out, p, rigid, params)


def pressure_acceleration(p: ParticleState, env: PairEnv, params: SimParams,
                          pressure: torch.Tensor | None = None
                          ) -> torch.Tensor:
    """a_i = -sum_j m_j (p_i/rho_i^2 + p_j/rho_j^2) gradW (fluid j), the
    mirrored rigid term with rho0 (rigid j), on fluid dynamic rows (:479,
    ``with_wrench=False``: the wrench exists only with dynamic rigid bodies).
    p/rho^2 is taken once per particle (:496)."""
    if pressure is None:
        pressure = p.pressure
    p_rho2 = pressure / torch.clamp_min(p.density * p.density, 1e-12)
    out = pair_kernels.run("pressure", env,
                           {"pos": p.pos, "material": p.material,
                            "mass": p.mass, "rest_volume": p.rest_volume,
                            "p_rho2": p_rho2}, params)
    keep = _fluid(p) & (p.is_dynamic > 0)
    return torch.where(keep[:, None], out["acc"], torch.zeros_like(out["acc"]))


def update_fluid_velocity(p: ParticleState, params: SimParams) -> ParticleState:
    """:560."""
    return p.replace(vel=torch.where(_fluid(p)[:, None],
                                     p.vel + params.dt * p.acc, p.vel))


def update_fluid_position(p: ParticleState,
                          params: SimParams) -> ParticleState:
    """Advance fluid positions (:565), after the CFL speed cap of
    ``params.vel_cap_cfl`` particle diameters per step. The emitter branch
    of the JAX original is not ported (ROADMAP Queue A.12)."""
    fluid = _fluid(p)
    vel = p.vel
    if params.vel_cap_cfl > 0:
        cap = torch.tensor(params.vel_cap_cfl * params.particle_diameter
                           / params.dt, dtype=torch.float32,
                           device=vel.device)
        sp2 = torch.sum(vel * vel, dim=-1, keepdim=True)
        scale = torch.where(sp2 > cap * cap,
                            cap / torch.sqrt(torch.clamp_min(sp2, 1e-30)),
                            torch.ones_like(sp2))
        vel = torch.where(fluid[:, None], vel * scale, vel)
    new_pos = torch.where(fluid[:, None], p.pos + params.dt * vel, p.pos)
    return p.replace(pos=new_pos, vel=vel)


def enforce_domain_boundary(p: ParticleState, params: SimParams,
                            material: int = MATERIAL_FLUID) -> ParticleState:
    """Clamp particles of ``material`` into the padded domain and reflect the
    normal velocity with restitution loss c_f = 0.5 (:603)."""
    dev = p.pos.device
    lo = torch.tensor(params.domain_start, dtype=torch.float32,
                      device=dev) + params.padding
    hi = torch.tensor(params.domain_end, dtype=torch.float32,
                      device=dev) - params.padding
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

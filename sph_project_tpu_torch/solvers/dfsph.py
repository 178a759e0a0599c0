"""DFSPH, cold path: constant-density and divergence-free correctors.

The JAX package's ``solvers/dfsph.py`` (line numbers below name its
functions) for the main path: standard viscosity, no dynamic rigid bodies, no
warm start. The corrector loops keep the JAX loop conditions (at least one
iteration, then until the error averaged over ALL active particles, walls
included, is under tolerance or the iteration cap is hit). They are Python
loops that read the error on the host once per iteration.
"""
from __future__ import annotations

import torch

from ..core.params import MATERIAL_FLUID, MATERIAL_NONE, SimParams
from ..core.state import ParticleState, RigidState, SimState
from ..ops import kernels
from ..ops import pair_kernels
from ..ops.pairs import PairEnv
from . import common

_WARM = ("the DFSPH warm start is not ported yet "
         "(ROADMAP Queue A.8, DFSPH warm start)")


def _alpha_from_sums(sum_sq, vec, p: ParticleState) -> torch.Tensor:
    denom = sum_sq + torch.sum(vec * vec, dim=-1)
    alpha = torch.where(denom > 1e-5, 1.0 / torch.clamp_min(denom, 1e-30),
                        torch.zeros_like(denom))
    return torch.where(p.material == MATERIAL_FLUID, alpha,
                       torch.zeros_like(alpha))


def compute_alpha(p: ParticleState, env: PairEnv,
                  params: SimParams) -> torch.Tensor:
    """alpha_i = 1 / (|sum_j V_j gradW|^2 + sum_{fluid j} |V_j gradW|^2),
    zero when the denominator is tiny (:32)."""
    out = pair_kernels.run("alpha", env,
                           {"pos": p.pos, "rest_volume": p.rest_volume,
                            "material": p.material}, params)
    return _alpha_from_sums(out["sum_sq"], out["vec"], p)


def _deficiency_guard(s, cnt, p: ParticleState, params: SimParams):
    adv = torch.clamp_min(s, 0.0)
    min_nbrs = 20 if params.dim == 3 else 7
    adv = torch.where(cnt < min_nbrs, torch.zeros_like(adv), adv)
    return torch.where(p.material == MATERIAL_FLUID, adv, torch.zeros_like(adv))


def density_alpha_divergence(p: ParticleState, env: PairEnv,
                             params: SimParams):
    """Density, alpha and the divergence solver's initial density derivative
    in one pair pass (:90). Returns (density, alpha, deriv0)."""
    out = pair_kernels.run("density_alpha_divergence", env,
                           {"pos": p.pos, "vel": p.vel,
                            "rest_volume": p.rest_volume,
                            "material": p.material}, params)
    dens = (p.rest_volume * kernels.W0(params.support_radius, params.dim,
                                       params.kernel_type)
            + out["sd"]) * params.density0
    dens = torch.where(p.material == MATERIAL_FLUID, dens, p.density)
    alpha = _alpha_from_sums(out["sum_sq"], out["vec"], p)
    deriv0 = _deficiency_guard(out["sv"], out["cnt"], p, params)
    return dens, alpha, deriv0


def _divergence_sum(p: ParticleState, vel: torch.Tensor, env: PairEnv,
                    params: SimParams, with_count: bool = False):
    """sum_j V_j (v_i - v_j) . gradW_ij, optionally with the neighbour
    count (:148)."""
    out = pair_kernels.run("divergence", env,
                           {"pos": p.pos, "vel": vel,
                            "rest_volume": p.rest_volume}, params,
                           flags=1 if with_count else 0)
    if with_count:
        return out["s"], out["cnt"]
    return out["s"]


def compute_density_derivative(p, vel, env, params) -> torch.Tensor:
    """(D rho/Dt)/rho0, clamped positive; zero on particle deficiency (:174)."""
    s, cnt = _divergence_sum(p, vel, env, params, with_count=True)
    return _deficiency_guard(s, cnt, p, params)


def compute_density_star(p, vel, env, params) -> torch.Tensor:
    """rho*/rho0 = rho/rho0 + dt * divergence sum, clamped >= 1 (:184)."""
    s = _divergence_sum(p, vel, env, params)
    star = torch.clamp_min(p.density / params.density0 + params.dt * s, 1.0)
    return torch.where(p.material == MATERIAL_FLUID, star,
                       torch.zeros_like(star))


def _correction(p: ParticleState, rigid: RigidState, kappa: torch.Tensor,
                env: PairEnv, params: SimParams):
    """Velocity correction of one corrector iteration (:280, with :223
    _correction_outputs and :260 _correction_reduce). Returns (dv, rigid
    force, rigid torque); the wrench is zero without dynamic rigid bodies."""
    k_rho = kappa / torch.clamp_min(p.density, 1e-12)
    out = pair_kernels.run("correction", env,
                           {"pos": p.pos, "material": p.material,
                            "rest_volume": p.rest_volume, "kappa": kappa,
                            "k_rho": k_rho}, params)
    fluid_i = p.material == MATERIAL_FLUID
    dv = torch.where(fluid_i[:, None], out["dv"], torch.zeros_like(out["dv"]))
    return dv, torch.zeros_like(rigid.force), torch.zeros_like(rigid.torque)


def _avg_over_active(x: torch.Tensor, p: ParticleState,
                     params: SimParams) -> torch.Tensor:
    """The reference averages solver errors over ALL active particles, walls
    included (:345)."""
    n = torch.clamp_min(common.global_sum(p.material != MATERIAL_NONE, params), 1)
    return common.global_sum(x, params) / n


def correct_density_error(p: ParticleState, rigid: RigidState,
                          alpha: torch.Tensor, env: PairEnv,
                          params: SimParams):
    """Constant-density solver, cold (:353). Returns (p, rigid, iterations,
    error) with the error as a float32 tensor."""
    fluid_one = (p.material == MATERIAL_FLUID).to(torch.float32)
    vel = p.vel
    rf = torch.zeros_like(rigid.force)
    rt = torch.zeros_like(rigid.torque)
    star = compute_density_star(p, vel, env, params)
    err = torch.tensor(float("inf"), dtype=torch.float32)
    itr = 0
    while itr < 1 or (float(err) > params.dfsph_max_error
                      and itr < params.dfsph_max_iter):
        kappa = (star - 1.0) * alpha / params.dt
        if params.dfsph_omega != 1.0:
            kappa = kappa * params.dfsph_omega
        dv, f, tq = _correction(p, rigid, kappa, env, params)
        vel = vel + dv
        star = compute_density_star(p, vel, env, params)
        err = _avg_over_active(star - fluid_one, p, params)
        rf, rt = rf + f, rt + tq
        itr += 1
    rigid = rigid.replace(force=rigid.force + rf, torque=rigid.torque + rt)
    return p.replace(vel=vel), rigid, itr, err


def correct_divergence_error(p: ParticleState, rigid: RigidState,
                             alpha: torch.Tensor, env: PairEnv,
                             params: SimParams, deriv0: torch.Tensor = None):
    """Divergence-free solver, cold (:432). ``deriv0``: the initial density
    derivative when the caller already has it (density_alpha_divergence)."""
    eta = params.dfsph_max_error_v * params.density0 / params.dt
    vel = p.vel
    rf = torch.zeros_like(rigid.force)
    rt = torch.zeros_like(rigid.torque)
    deriv = deriv0 if deriv0 is not None else \
        compute_density_derivative(p, vel, env, params)
    err = torch.tensor(float("inf"), dtype=torch.float32)
    itr = 0
    while itr < 1 or (float(err) > eta and itr < params.dfsph_max_iter_v):
        kappa_v = deriv * alpha
        dv, f, tq = _correction(p, rigid, kappa_v, env, params)
        vel = vel + dv
        deriv = compute_density_derivative(p, vel, env, params)
        err = _avg_over_active(params.density0 * deriv, p, params)
        rf, rt = rf + f, rt + tq
        itr += 1
    rigid = rigid.replace(force=rigid.force + rf, torque=rigid.torque + rt)
    return p.replace(vel=vel), rigid, itr, err


def step(state: SimState, params: SimParams, plumbing):
    """One DFSPH step (:581). Density, alpha and the pair environment for the
    start of the step come from the end of the previous one (``prepare``
    seeds them)."""
    if params.dfsph_warm_start or params.dfsph_warm_start_div:
        raise NotImplementedError(_WARM)
    p, rigid = state.particles, state.rigid
    env0 = state.cached_neighbors

    p, rigid = plumbing.non_pressure_acceleration(p, rigid, env0, params)
    p = common.update_fluid_velocity(p, params)
    p, rigid, itr_d, err_d = correct_density_error(
        p, rigid, state.dfsph_alpha, env0, params)
    p = common.update_fluid_position(p, params)
    p = common.enforce_domain_boundary(p, params, MATERIAL_FLUID)
    state = state.replace(particles=p, rigid=rigid)

    state, env = plumbing.neighbor_prep(state, params)
    p = state.particles
    dens, alpha, deriv0 = density_alpha_divergence(p, env, params)
    p = p.replace(density=dens)
    p, rigid, itr_v, err_v = correct_divergence_error(
        p, state.rigid, alpha, env, params, deriv0=deriv0)

    state = state.replace(
        particles=p, rigid=rigid, dfsph_alpha=alpha, cached_neighbors=env,
        t=state.t + params.dt, step_count=state.step_count + 1,
    )
    dev = p.pos.device
    diag = plumbing.diagnostics(state, env, params, extra=dict(
        solver_iters=torch.tensor(itr_d, dtype=torch.int32, device=dev),
        solver_err=err_d.to(dev) * params.density0,
        div_iters=torch.tensor(itr_v, dtype=torch.int32, device=dev),
        div_err=err_v.to(dev),
    ))
    return state, diag

"""DFSPH: constant-density and divergence-free correctors, cold and warm.

The JAX package's ``solvers/dfsph.py`` (line numbers below name its
functions) for standard viscosity, with the fluid->rigid wrenches of dynamic
bodies carried through both correctors (``rf``, ``rt``). The corrector
loops keep the JAX loop conditions (cold: at least one iteration, then until
the error averaged over ALL active particles, walls included, is under
tolerance or the iteration cap is hit; warm: the correction from the carried
stiffness counts as the first iteration and the loop-entry error is real).
Each is an ``ops.graph_loop.while_loop``, as each is a ``lax.while_loop``
in the JAX package: a WHILE node of the captured step on the card, a host
loop reading its flag once an iteration elsewhere. The iteration counts are
int32 device tensors from the loops' carries.
"""
from __future__ import annotations

import torch

from ..core.params import MATERIAL_FLUID, MATERIAL_NONE, SimParams
from ..core.state import ParticleState, RigidState, SimState, constant
from ..ops import graph_loop
from ..ops import kernels
from ..ops import pair_kernels
from ..ops.pairs import PairEnv
from . import common


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
    in one pair pass (:90), and with dynamic rigid bodies the same-object
    kernel sum of their pseudo-volumes (positions do not move between the
    sort and the step's end). Returns (density, alpha, deriv0, svol or
    None)."""
    out = pair_kernels.run("density_alpha_divergence", env,
                           {"pos": p.pos, "vel": p.vel,
                            "rest_volume": p.rest_volume,
                            "material": p.material,
                            "object_id": p.object_id}, params,
                           flags=common.wrench_flags(params))
    dens = (p.rest_volume * kernels.W0(params.support_radius, params.dim,
                                       params.kernel_type)
            + out["sd"]) * params.density0
    dens = torch.where(p.material == MATERIAL_FLUID, dens, p.density)
    alpha = _alpha_from_sums(out["sum_sq"], out["vec"], p)
    deriv0 = _deficiency_guard(out["sv"], out["cnt"], p, params)
    return dens, alpha, deriv0, out.get("svol")


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


def warm_factor(p: ParticleState, params: SimParams) -> torch.Tensor:
    """This step's warm-start strength, a scalar or per particle (:191):
    ``dfsph_warm_factor``, or ``dfsph_warm_factor_hi`` where that is armed
    and both gates are open: the carried largest fluid density is within
    ``dfsph_warm_gate`` of rest, and the particle itself moves less than
    ``dfsph_warm_quiet_cfl`` diameters this step."""
    wf = constant(params.dfsph_warm_factor, torch.float32, p.pos.device)
    if params.dfsph_warm_factor_hi > 0.0:
        fluid_i = p.material == MATERIAL_FLUID
        rho_mx = common.global_max(
            torch.where(fluid_i, p.density, torch.zeros_like(p.density)),
            params)
        quiet_g = rho_mx <= params.dfsph_warm_gate * params.density0
        v2 = torch.sum(p.vel * p.vel, dim=-1)
        v_lim = (params.dfsph_warm_quiet_cfl * params.particle_diameter
                 / params.dt)
        quiet_i = v2 <= constant(v_lim * v_lim, torch.float32, v2.device)
        hi = constant(params.dfsph_warm_factor_hi, torch.float32, v2.device)
        wf = torch.where(quiet_g & quiet_i, hi, wf)
    return wf


def _warm_kappa(p: ParticleState, carried: torch.Tensor,
                params: SimParams) -> torch.Tensor:
    """The stiffness the warm correction starts from: the carried one scaled
    by this step's warm factor, clamped at 0, on fluid rows (:387, :461,
    :507). The factor is evaluated here and nowhere else, once per warm
    solver and step, on the state that solver starts from."""
    kappa_w = torch.clamp_min(warm_factor(p, params) * carried, 0.0)
    return torch.where(p.material == MATERIAL_FLUID, kappa_w,
                       torch.zeros_like(kappa_w))


def _correction_fields(p: ParticleState, kappa: torch.Tensor) -> dict:
    """The fields the correction pair body reads."""
    return {"pos": p.pos, "material": p.material,
            "rest_volume": p.rest_volume, "kappa": kappa,
            "k_rho": kappa / torch.clamp_min(p.density, 1e-12),
            "is_dynamic": p.is_dynamic}


def _correction_reduce(out: dict, p: ParticleState, rigid: RigidState,
                       params: SimParams, pre: str = ""):
    """The correction sums as (dv on fluid rows, rigid force, rigid torque)
    (:260); the wrench is zero without dynamic rigid bodies."""
    fluid_i = p.material == MATERIAL_FLUID
    dv = out[f"{pre}dv"]
    dv = torch.where(fluid_i[:, None], dv, torch.zeros_like(dv))
    if not params.has_dynamic_rigid:
        return dv, torch.zeros_like(rigid.force), torch.zeros_like(rigid.torque)
    return (dv, *common.wrench_of(out[f"{pre}fp"], p, rigid, params))


def _correction(p: ParticleState, rigid: RigidState, kappa: torch.Tensor,
                env: PairEnv, params: SimParams):
    """Velocity correction and fluid->rigid wrench of one corrector
    iteration (:280, with :223 _correction_outputs). Returns (dv, rigid
    force, rigid torque)."""
    out = pair_kernels.run("correction", env, _correction_fields(p, kappa),
                           params, flags=common.wrench_flags(params))
    return _correction_reduce(out, p, rigid, params)


def nonpressure_warm_fused(p: ParticleState, rigid: RigidState,
                           kappa_w: torch.Tensor, env: PairEnv,
                           params: SimParams):
    """Surface tension + standard viscosity + the warm-start density
    correction in one pair pass (:306). The warm correction reads positions,
    stiffness and density, never velocity, so its sums equal those of a pass
    of its own. Returns (acceleration, viscous force, viscous torque, dv,
    warm force, warm torque)."""
    fields = common.nonpressure_fields(p)
    fields.update(_correction_fields(p, kappa_w))
    out = pair_kernels.run("nonpressure_warm", env, fields, params,
                           flags=common.wrench_flags(params))
    a, vf, vt = common.nonpressure_reduce(out, p, rigid, params)
    dv, wf, wt = _correction_reduce(out, p, rigid, params, pre="w")
    return a, vf, vt, dv, wf, wt


def _avg_over_active(x: torch.Tensor, p: ParticleState,
                     params: SimParams) -> torch.Tensor:
    """The reference averages solver errors over ALL active particles, walls
    included (:345)."""
    n = torch.clamp_min(common.global_sum(p.material != MATERIAL_NONE, params), 1)
    return common.global_sum(x, params) / n


def correct_density_error(p: ParticleState, rigid: RigidState,
                          alpha: torch.Tensor, env: PairEnv,
                          params: SimParams, kappa0: torch.Tensor = None,
                          warm_pre: tuple = None):
    """Constant-density solver (:353). ``kappa0``: the previous step's
    accumulated stiffness; the warm path applies one correction from it
    before the first density probe. ``warm_pre`` = (kappa_w, dv, force,
    torque): that correction, already computed by an earlier fused pass
    (:func:`nonpressure_warm_fused`). Returns (p, rigid, iterations, error,
    accumulated stiffness) with the iterations an int32 and the error a
    float32 tensor."""
    dev = p.pos.device
    fluid_one = (p.material == MATERIAL_FLUID).to(torch.float32)
    vel = p.vel
    rf = torch.zeros_like(rigid.force)
    rt = torch.zeros_like(rigid.torque)
    kacc = torch.zeros_like(alpha)
    # the warm correction counts as the first iteration
    itr, err = common.loop_start(
        int(warm_pre is not None or kappa0 is not None), dev)
    if warm_pre is None and kappa0 is not None:
        kappa_w = _warm_kappa(p, kappa0, params)
        warm_pre = (kappa_w, *_correction(p, rigid, kappa_w, env, params))
    if warm_pre is not None:
        kacc, dv, rf, rt = warm_pre
        vel = vel + dv
    star = compute_density_star(p, vel, env, params)
    if warm_pre is not None:
        # the warm correction may already meet the tolerance
        err = _avg_over_active(star - fluid_one, p, params)

    def cond(c):
        _, _, err, itr, _, _, _ = c
        return (itr < 1) | ((err > params.dfsph_max_error)
                            & (itr < params.dfsph_max_iter))

    def body(c):
        vel, star, _, itr, rf, rt, kacc = c
        kappa = (star - 1.0) * alpha / params.dt
        if params.dfsph_omega != 1.0:
            kappa = kappa * params.dfsph_omega
        dv, f, tq = _correction(p, rigid, kappa, env, params)
        vel = vel + dv
        star = compute_density_star(p, vel, env, params)
        err = _avg_over_active(star - fluid_one, p, params)
        return vel, star, err, itr + 1, rf + f, rt + tq, kacc + kappa

    vel, _, err, itr, rf, rt, kacc = graph_loop.while_loop(
        cond, body, (vel, star, err, itr, rf, rt, kacc))
    rigid = rigid.replace(force=rigid.force + rf, torque=rigid.torque + rt)
    return p.replace(vel=vel), rigid, itr, err, kacc


def correct_divergence_error(p: ParticleState, rigid: RigidState,
                             alpha: torch.Tensor, env: PairEnv,
                             params: SimParams, deriv0: torch.Tensor = None,
                             kappa_v0: torch.Tensor = None):
    """Divergence-free solver (:432). ``deriv0``: the initial density
    derivative when the caller already has it (density_alpha_divergence).
    ``kappa_v0``: the previous step's accumulated divergence stiffness; the
    warm path applies one correction from it and probes the derivative again
    before the loop. Returns (p, rigid, iterations, error, accumulated
    stiffness)."""
    dev = p.pos.device
    eta = params.dfsph_max_error_v * params.density0 / params.dt
    vel = p.vel
    rf = torch.zeros_like(rigid.force)
    rt = torch.zeros_like(rigid.torque)
    kacc = torch.zeros_like(alpha)
    itr, err = common.loop_start(int(kappa_v0 is not None), dev)
    if kappa_v0 is not None:
        kacc = _warm_kappa(p, kappa_v0, params)
        dv, rf, rt = _correction(p, rigid, kacc, env, params)
        vel = vel + dv
        deriv0 = compute_density_derivative(p, vel, env, params)
        err = _avg_over_active(params.density0 * deriv0, p, params)
    deriv = deriv0 if deriv0 is not None else \
        compute_density_derivative(p, vel, env, params)

    def cond(c):
        _, _, err, itr, _, _, _ = c
        return (itr < 1) | ((err > eta) & (itr < params.dfsph_max_iter_v))

    def body(c):
        vel, deriv, _, itr, rf, rt, kacc = c
        kappa_v = deriv * alpha
        dv, f, tq = _correction(p, rigid, kappa_v, env, params)
        vel = vel + dv
        deriv = compute_density_derivative(p, vel, env, params)
        err = _avg_over_active(params.density0 * deriv, p, params)
        return vel, deriv, err, itr + 1, rf + f, rt + tq, kacc + kappa_v

    vel, _, err, itr, rf, rt, kacc = graph_loop.while_loop(
        cond, body, (vel, deriv, err, itr, rf, rt, kacc))
    rigid = rigid.replace(force=rigid.force + rf, torque=rigid.torque + rt)
    return p.replace(vel=vel), rigid, itr, err, kacc


def _nonpressure_and_density_solve(p: ParticleState, rigid: RigidState,
                                   state: SimState, env: PairEnv,
                                   params: SimParams, plumbing):
    """Non-pressure accelerations, the velocity update and the
    constant-density solve (:499). With the warm start and standard
    viscosity the warm correction rides the non-pressure pass."""
    alpha = state.dfsph_alpha
    if params.dfsph_warm_start and params.viscosity_method == "standard":
        kappa_w = _warm_kappa(p, state.dfsph_kappa, params)
        a_np, vf, vt, dv, wf, wt = nonpressure_warm_fused(
            p, rigid, kappa_w, env, params)
        rigid = rigid.replace(force=rigid.force + vf, torque=rigid.torque + vt)
        p = p.replace(acc=common.gravity_acceleration(p, params) + a_np)
        p = common.update_fluid_velocity(p, params)
        return correct_density_error(p, rigid, alpha, env, params,
                                     warm_pre=(kappa_w, dv, wf, wt))
    p, rigid = plumbing.non_pressure_acceleration(p, rigid, env, state,
                                                  params)
    p = common.update_fluid_velocity(p, params)
    return correct_density_error(
        p, rigid, alpha, env, params,
        kappa0=state.dfsph_kappa if params.dfsph_warm_start else None)


def _first_half(state: SimState, env: PairEnv, params: SimParams,
                plumbing):
    """The step up to the resort (:581-600): the non-pressure accelerations
    and the constant-density solve on ``env``, the advection, the rigid
    stage and the domain clamp. Returns (state, its diagnostics)."""
    p, rigid = state.particles, state.rigid
    p, rigid, itr_d, err_d, kacc = _nonpressure_and_density_solve(
        p, rigid, state, env, params, plumbing)
    p = common.update_fluid_position(p, rigid, params)
    state = state.replace(particles=p, rigid=rigid)
    if params.dfsph_warm_start:
        state = state.replace(dfsph_kappa=kacc)
    state = plumbing.rigid_mid(state, env, params)
    p = common.enforce_domain_boundary(state.particles, params,
                                       MATERIAL_FLUID)
    return state.replace(particles=p), dict(
        solver_iters=itr_d, solver_err=err_d * params.density0)


def _second_half(state: SimState, params: SimParams, plumbing,
                 extra: dict | None = None):
    """The step from the resort on (:601-626): the new pair environment,
    density, alpha and the divergence-free solve, then the step's end.
    Returns (state, environment, diagnostics, with ``extra`` before this
    half's)."""
    state, env = plumbing.neighbor_prep(state, params)
    p = state.particles
    dens, alpha, deriv0, svol = density_alpha_divergence(p, env, params)
    p = p.replace(density=dens)
    p, rigid, itr_v, err_v, kacc_v = correct_divergence_error(
        p, state.rigid, alpha, env, params, deriv0=deriv0,
        kappa_v0=state.dfsph_kappa_v if params.dfsph_warm_start_div else None)
    # the step's end (:612): rigid volumes from the sum the pass above took
    if params.has_dynamic_rigid:
        p = common.apply_rigid_volume(p, svol, params)

    state = state.replace(
        particles=p, rigid=rigid, dfsph_alpha=alpha,
        t=state.t + params.dt, step_count=state.step_count + 1,
    )
    if params.dfsph_warm_start_div:
        state = state.replace(dfsph_kappa_v=kacc_v)
    diag = plumbing.diagnostics(state, env, params, extra=dict(
        extra or {}, div_iters=itr_v, div_err=err_v))
    return state, env, diag


def step(state: SimState, params: SimParams, plumbing):
    """One DFSPH step (:581). Density, alpha and the pair environment for the
    start of the step come from the end of the previous one (``prepare``
    seeds them)."""
    state, diag_a = _first_half(state, state.cached_neighbors, params,
                                plumbing)
    state, env, diag = _second_half(state, params, plumbing, extra=diag_a)
    return state.replace(cached_neighbors=env), diag


def segment_a(state: SimState, params: SimParams, plumbing):
    """The first half of a step (:528) for a step that cannot keep its pair
    environment across the step boundary (the spatial decomposition, which
    resorts before each half): the environment built anew, then density and
    alpha on it. They are those the previous step ended with (or
    ``prepare`` made), bit for bit: the positions have not moved since, and
    the fused pass adds each sum's terms as the density and alpha passes
    do, in the same order. Returns (state, diagnostics of this half)."""
    state, env = plumbing.neighbor_prep(state, params)
    dens, alpha, _, _ = density_alpha_divergence(state.particles, env, params)
    state = state.replace(particles=state.particles.replace(density=dens),
                          dfsph_alpha=alpha)
    return _first_half(state, env, params, plumbing)


def segment_b(state: SimState, params: SimParams, plumbing):
    """The second half of a step (:556): the divergence-free solve and the
    step's end, after a resort. Returns (state, diagnostics of this
    half)."""
    state, _, diag = _second_half(state, params, plumbing)
    return state, diag

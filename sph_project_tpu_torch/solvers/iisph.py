"""IISPH: implicit incompressible SPH, relaxed Jacobi on the pressure.

The JAX package's ``solvers/iisph.py`` (line numbers below name its
functions), with its quirks: d_ii divides the rigid-neighbour term by the
PREVIOUS step's advected density of row i (carried across the sort as
``iisph_density_star``; zero before the first step, so that term starts at
1e12 through the clamp); omega, eta and the iteration cap from the params.
The pressure loop keeps the JAX loop condition (at least one iteration, then
until the error is under ``iisph_eta`` or ``iisph_max_iter`` is reached): an
``ops.graph_loop.while_loop``, a WHILE node of the captured step on the card.
"""
from __future__ import annotations

import torch

from ..core.params import MATERIAL_FLUID, SimParams
from ..core.state import ParticleState, SimState
from ..ops import graph_loop
from ..ops import pair_kernels
from ..ops.pairs import PairEnv
from . import common


def _dpi(p: ParticleState, params: SimParams) -> torch.Tensor:
    """rho0 V_i / max(rho_i^2, 1e-12) (:50, :91)."""
    return params.density0 * p.rest_volume / torch.clamp_min(
        torch.square(p.density), 1e-12)


def compute_dii(p: ParticleState, density_star_prev: torch.Tensor,
                env: PairEnv, params: SimParams) -> torch.Tensor:
    """d_ii (:22), (N, 3)."""
    inv_star2 = 1.0 / torch.clamp_min(torch.square(density_star_prev), 1e-12)
    return pair_kernels.run("iisph_dii", env,
                            {"pos": p.pos, "material": p.material,
                             "density": p.density,
                             "rest_volume": p.rest_volume,
                             "inv_star2": inv_star2}, params)["dii"]


def compute_aii(p: ParticleState, dii: torch.Tensor, dpi: torch.Tensor,
                env: PairEnv, params: SimParams) -> torch.Tensor:
    """a_ii = dt^2 sum_j rho0 V_j (d_ii - d_ji) . gradW (:47)."""
    s = pair_kernels.run("iisph_aii", env,
                         {"pos": p.pos, "rest_volume": p.rest_volume,
                          "dii": dii, "dpi": dpi}, params)["s"]
    return s * params.dt * params.dt


def compute_density_star(p: ParticleState, env: PairEnv,
                         params: SimParams) -> torch.Tensor:
    """The advected density rho + dt sum_j rho0 V_j (v_i - v_j) . gradW on
    fluid rows (:67)."""
    s = pair_kernels.run("iisph_density_star", env,
                         {"pos": p.pos, "vel": p.vel,
                          "rest_volume": p.rest_volume}, params)["s"]
    return torch.where(p.material == MATERIAL_FLUID,
                       p.density + params.dt * s, p.density)


def refine(p: ParticleState, dii: torch.Tensor, aii: torch.Tensor,
           dpi: torch.Tensor, density_star: torch.Tensor, env: PairEnv,
           params: SimParams):
    """The relaxed-Jacobi pressure iteration (:86): two pair passes per
    iteration (dij_pj, then sum_i). Returns (pressure, iterations, final
    error)."""
    fluid_i = p.material == MATERIAL_FLUID
    nf = torch.clamp_min(common.global_sum(fluid_i, params), 1)
    si = params.density0 - density_star
    can = torch.abs(aii) > 1e-10
    aii_safe = torch.where(can, aii, torch.ones_like(aii))
    base = {"pos": p.pos, "material": p.material, "density": p.density,
            "rest_volume": p.rest_volume, "dii": dii, "dpi": dpi}
    zero = torch.zeros_like(p.pressure)

    def cond(c):
        _, itr, err = c
        return (itr < 1) | ((err >= params.iisph_eta)
                            & (itr < params.iisph_max_iter))

    def body(c):
        pressure, itr, _ = c
        fields = dict(base, pressure=pressure)
        fields["dij_pj"] = pair_kernels.run("iisph_dij_pj", env, fields,
                                            params)["dp"]
        sum_i = pair_kernels.run("iisph_sum_i", env, fields, params)["s"] \
            * params.dt * params.dt
        new_p = (1.0 - params.iisph_omega) * pressure + \
            params.iisph_omega / aii_safe * (si - sum_i)
        new_p = torch.where(can, torch.clamp_min(new_p, 0.0), zero)
        new_p = torch.where(fluid_i, new_p, zero)
        resid = torch.where(fluid_i & (new_p > 1e-10),
                            aii * new_p + sum_i - si, zero)
        err = common.global_sum(resid, params) / nf / params.density0
        return new_p, itr + 1, err

    pressure, itr, err = graph_loop.while_loop(cond, body, (
        torch.zeros_like(p.pressure), *common.loop_start(0, p.pos.device)))
    return pressure, itr, err


def step(state: SimState, params: SimParams, plumbing):
    """One IISPH step (:168)."""
    state, env = plumbing.neighbor_prep(state, params)
    p, rigid = state.particles, state.rigid
    p = p.replace(density=common.compute_density(p, env, params),
                  pressure=torch.zeros_like(p.pressure))
    p, rigid = plumbing.non_pressure_acceleration(p, rigid, env, state,
                                                  params)
    p = common.update_fluid_velocity(p, params)

    dpi = _dpi(p, params)
    dii = compute_dii(p, state.iisph_density_star, env, params)
    aii = compute_aii(p, dii, dpi, env, params)
    density_star = compute_density_star(p, env, params)
    pressure, itr, err = refine(p, dii, aii, dpi, density_star, env, params)
    p = p.replace(pressure=pressure)

    acc, rf, rt = common.pressure_acceleration(
        p, rigid, env, params, with_wrench=params.has_dynamic_rigid)
    rigid = rigid.replace(force=rigid.force + rf, torque=rigid.torque + rt)
    p = common.update_fluid_velocity(p.replace(acc=acc), params)
    p = common.update_fluid_position(p, rigid, params)

    state = plumbing.rigid_and_tail(
        state.replace(particles=p, rigid=rigid,
                      iisph_density_star=density_star), env, params)
    return state, plumbing.diagnostics(state, env, params, extra=dict(
        solver_iters=itr, solver_err=err * params.density0))

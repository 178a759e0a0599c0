"""PBF: position-based fluids.

The JAX package's ``solvers/pbf.py`` (line numbers below name its
functions): the poly6 / spiky kernels (``params.kernel_type == "poly6"``
swaps them into every shared pass: ``ops.kernels`` and the pair bodies),
lambda from the density constraint, the s_corr anti-clustering term, a fixed
``params.pbf_iters`` (5) Jacobi position iterations, and the velocity from
the position change. 2D and 3D.

Moved-position candidacy: the iterations move the particles, but every pass
of the step runs on the environment of the step's sort. A row's candidates
are the particles of the 3^dim cells around its cell at that sort (the
step-start grid), and the distance test is taken at the moved positions.
This is what the JAX docstring and the float64 oracle name as the
reference's semantics, and what both CUDA pair kernels walk. The JAX
package's own engines admit supersets that depend on the engine (its slab
executor any row-matched candidate of the block's window, its TPU kernel the
sub-block's hull of x-planes and y-rows); a pass agrees with theirs exactly
where no pair within h at the moved positions lies outside the step-start
stencil (``tests/test_torch_pbf.py`` counts them).
"""
from __future__ import annotations

import torch

from ..core.params import MATERIAL_FLUID, SimParams
from ..core.state import ParticleState, SimState
from ..ops import kernels
from ..ops import pair_kernels
from ..ops.pairs import PairEnv
from . import common

LAMBDA_EPS = 100.0          # the reference's epsilon of the constraint


def compute_density_moving(p: ParticleState, env: PairEnv, params: SimParams,
                           produce: torch.Tensor) -> torch.Tensor:
    """Density at the moved positions ``p.pos`` over the step's environment
    (:33); rows other than fluid keep their density."""
    s = pair_kernels.run("pbf_density", env,
                         {"pos": p.pos, "rest_volume": p.rest_volume},
                         params, produce=produce)["s"]
    dens = (p.rest_volume * kernels.W0(params.support_radius, params.dim,
                                       params.kernel_type) + s) * params.density0
    return torch.where(p.material == MATERIAL_FLUID, dens, p.density)


def compute_lambda(p: ParticleState, dens: torch.Tensor, env: PairEnv,
                   params: SimParams, produce: torch.Tensor) -> torch.Tensor:
    """lambda_i = -C_i / (sum |grad|^2 + |sum grad|^2 + eps) (:50); the
    constraint is left unclamped, as in the reference."""
    out = pair_kernels.run("pbf_lambda", env,
                           {"pos": p.pos, "material": p.material,
                            "mass": p.mass, "rest_volume": p.rest_volume,
                            "density": dens}, params, produce=produce)
    denom = out["sum_sq"] + torch.sum(out["vec"] * out["vec"], dim=-1) + \
        LAMBDA_EPS
    constraint = dens / params.density0 - 1.0
    lam = -constraint / denom
    return torch.where(p.material == MATERIAL_FLUID, lam, torch.zeros_like(lam))


def fix_position(p: ParticleState, lam: torch.Tensor, env: PairEnv,
                 params: SimParams, produce: torch.Tensor) -> torch.Tensor:
    """dx_i = sum_j (lam_i + lam_j + s_corr) gradW m_j / rho0 (:79)."""
    out = pair_kernels.run("pbf_fix", env,
                           {"pos": p.pos, "material": p.material,
                            "mass": p.mass, "rest_volume": p.rest_volume,
                            "lam": lam}, params, produce=produce)
    dx = out["dx"] / params.density0
    return torch.where((p.material == MATERIAL_FLUID)[:, None], dx,
                       torch.zeros_like(dx))


def step(state: SimState, params: SimParams, plumbing):
    """One PBF step (:113): no rigid solve and no entries, as in the
    reference's PBF path; with dynamic bodies, their volumes at the end."""
    state, env = plumbing.neighbor_prep(state, params)
    p, rigid = state.particles, state.rigid
    p, rigid = plumbing.non_pressure_acceleration(p, rigid, env, state,
                                                  params)
    p = common.update_fluid_velocity(p, params)
    old_pos = p.pos
    p = common.update_fluid_position(p, rigid, params)
    p = common.enforce_domain_boundary(p, params, MATERIAL_FLUID)

    # the rows read: the fluid after the advection (an emitter placeholder
    # that sank to g_upper is fluid now)
    fluid = p.material == MATERIAL_FLUID
    for _ in range(params.pbf_iters):
        dens = compute_density_moving(p, env, params, fluid)
        lam = compute_lambda(p, dens, env, params, fluid)
        dx = fix_position(p, lam, env, params, fluid)
        p = p.replace(pos=p.pos + dx, density=dens)

    p = common.enforce_domain_boundary(p, params, MATERIAL_FLUID)
    p = p.replace(vel=torch.where(fluid[:, None], (p.pos - old_pos) / params.dt,
                                  p.vel))
    if params.has_dynamic_rigid:
        p = common.compute_rigid_particle_volume(p, env, params)
    state = state.replace(particles=p, rigid=rigid, t=state.t + params.dt,
                          step_count=state.step_count + 1)
    dev = p.pos.device
    diag = plumbing.diagnostics(state, env, params, extra=dict(
        solver_iters=torch.full((), params.pbf_iters, dtype=torch.int32,
                                device=dev),
        solver_err=torch.zeros((), dtype=torch.float32, device=dev)))
    return state, diag

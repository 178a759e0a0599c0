"""WCSPH: weakly-compressible SPH with the Tait equation of state.

The JAX package's ``solvers/wcsph.py`` (line numbers below name its
functions): gamma 7 and stiffness 50000 from the params, density clamped to
>= rho0 before the EOS and written back, one feed-forward pass.
"""
from __future__ import annotations

import torch

from ..core.params import MATERIAL_FLUID, SimParams
from ..core.state import ParticleState, SimState
from . import common


def compute_pressure(p: ParticleState, params: SimParams) -> ParticleState:
    """Tait EOS; also writes back the clamped density (:19)."""
    fluid = p.material == MATERIAL_FLUID
    rho = torch.clamp_min(p.density, params.density0)
    pressure = params.wcsph_stiffness * (
        torch.pow(rho / params.density0, params.wcsph_gamma) - 1.0)
    return p.replace(density=torch.where(fluid, rho, p.density),
                     pressure=torch.where(fluid, pressure, p.pressure))


def step(state: SimState, params: SimParams, plumbing):
    """One WCSPH step (:31)."""
    state, env = plumbing.neighbor_prep(state, params)
    p, rigid = state.particles, state.rigid
    p = p.replace(density=common.compute_density(p, env, params))
    p, rigid = plumbing.non_pressure_acceleration(p, rigid, env, params)
    p = common.update_fluid_velocity(p, params)

    p = compute_pressure(p, params)
    acc, rf, rt = common.pressure_acceleration(
        p, rigid, env, params, with_wrench=params.has_dynamic_rigid)
    rigid = rigid.replace(force=rigid.force + rf, torque=rigid.torque + rt)
    p = common.update_fluid_velocity(p.replace(acc=acc), params)
    p = common.update_fluid_position(p, params)

    state = plumbing.rigid_and_tail(state.replace(particles=p, rigid=rigid),
                                    env, params)
    return state, plumbing.diagnostics(state, env, params)

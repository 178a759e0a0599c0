"""PCISPH: predictive-corrective incompressible SPH.

The JAX package's ``solvers/pcisph.py`` (line numbers below name its
functions). The prediction-correction loop keeps the JAX loop condition (at
least one iteration, then until the density error measured at the start of
an iteration is under ``pcisph_eta`` or ``pcisph_max_iter`` is reached): an
``ops.graph_loop.while_loop``, a WHILE node of the captured step on the card.
"""
from __future__ import annotations

import functools
import itertools
import math

import numpy as np
import torch

from ..core.params import MATERIAL_FLUID, SimParams
from ..core.state import ParticleState, RigidState, SimState
from ..ops import graph_loop
from ..ops import pair_kernels
from ..ops.pairs import PairEnv
from . import common


@functools.lru_cache(maxsize=16)
def compute_pcisph_k(params: SimParams) -> float:
    """The stiffness k_PCI from ideal-lattice kernel-gradient sums (:29),
    on the host in float64, once per parameter set; the lattice has
    ``params.dim`` dimensions."""
    h = params.support_radius
    dim = params.dim
    diam = params.particle_diameter * 0.97
    max_i = int(h / diam) + 1
    sum_grad = np.zeros(dim)
    sum_grad2 = 0.0
    k = 8.0 / math.pi if dim == 3 else 40.0 / 7.0 / math.pi
    k = 6.0 * k / h ** dim
    rng = range(-max_i, max_i + 1)
    for idx in itertools.product(rng, repeat=dim):
        x = -np.asarray(idx, np.float64) * diam
        r = np.linalg.norm(x)
        q = r / h
        if r < h and r > 1e-5:
            if q <= 0.5:
                c = k * q * (3.0 * q - 2.0)
            else:
                c = -k * (1.0 - q) ** 2
            g = c * x / (r * h)
            sum_grad += g
            sum_grad2 += float(g @ g)
    denom = float(sum_grad @ sum_grad) + sum_grad2
    dtv = params.dt * params.v0
    return -0.5 / (dtv * dtv) / denom


def density_star_predicted(p: ParticleState, pred: torch.Tensor,
                           env: PairEnv, params: SimParams):
    """rho* from the predicted fluid positions; rigid neighbours keep theirs,
    and the candidates are those of the sorted positions (:65). Returns
    (rho* on fluid rows, the mean positive density error of the fluid, as a
    float32 tensor)."""
    ratio = pair_kernels.run("pcisph_density_pred", env,
                             {"pos": p.pos, "pred": pred,
                              "material": p.material,
                              "rest_volume": p.rest_volume}, params)["s"]
    fluid_i = p.material == MATERIAL_FLUID
    zero = torch.zeros_like(ratio)
    star = torch.where(fluid_i, ratio * params.density0, zero)
    nf = torch.clamp_min(common.global_sum(fluid_i, params), 1)
    err = common.global_sum(
        torch.where(fluid_i, torch.clamp_min(ratio - 1.0, 0.0), zero),
        params) / nf
    return star, err


def refine(p: ParticleState, rigid: RigidState, env: PairEnv,
           params: SimParams, k_pci: float):
    """The prediction-correction loop (:97). Returns (pressure, iterations,
    final density error)."""
    fluid_i = p.material == MATERIAL_FLUID
    fluid = fluid_i[:, None]
    pressure = torch.zeros_like(p.pressure)
    pred_v = torch.where(fluid, p.vel + params.dt * p.acc, p.vel)
    pred_x = torch.where(fluid, p.pos + params.dt * pred_v, p.pos)

    def cond(c):
        _, _, _, itr, err = c
        return (itr < 1) | ((err >= params.pcisph_eta)
                            & (itr < params.pcisph_max_iter))

    def body(c):
        pressure, pred_v, pred_x, itr, _ = c
        star, err = density_star_predicted(p, pred_x, env, params)
        pressure = pressure + k_pci * (params.density0 - star)
        pressure = torch.where(fluid_i, torch.clamp_min(pressure, 0.0),
                               torch.zeros_like(pressure))
        p_acc, _, _ = common.pressure_acceleration(p, rigid, env, params,
                                                   pressure=pressure)
        pred_v = torch.where(fluid, p.vel + params.dt * (p.acc + p_acc),
                             pred_v)
        pred_x = torch.where(fluid, p.pos + params.dt * pred_v, pred_x)
        return pressure, pred_v, pred_x, itr + 1, err

    pressure, _, _, itr, err = graph_loop.while_loop(cond, body, (
        pressure, pred_v, pred_x, *common.loop_start(0, p.pos.device)))
    return pressure, itr, err


def step(state: SimState, params: SimParams, plumbing):
    """One PCISPH step (:130)."""
    k_pci = compute_pcisph_k(params)
    state, env = plumbing.neighbor_prep(state, params)
    p, rigid = state.particles, state.rigid
    p = p.replace(density=common.compute_density(p, env, params))
    p, rigid = plumbing.non_pressure_acceleration(p, rigid, env, state,
                                                  params)

    pressure, itr, err = refine(p, rigid, env, params, k_pci)
    p = common.update_fluid_velocity(p.replace(pressure=pressure), params)
    acc, rf, rt = common.pressure_acceleration(
        p, rigid, env, params, with_wrench=params.has_dynamic_rigid)
    rigid = rigid.replace(force=rigid.force + rf, torque=rigid.torque + rt)
    p = common.update_fluid_velocity(p.replace(acc=acc), params)
    p = common.update_fluid_position(p, rigid, params)

    state = plumbing.rigid_and_tail(state.replace(particles=p, rigid=rigid),
                                    env, params)
    return state, plumbing.diagnostics(state, env, params, extra=dict(
        solver_iters=itr, solver_err=err * params.density0))

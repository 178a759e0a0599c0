"""Simulation orchestration: the per-step sort, prepare, the step, the driver.

The JAX package's ``sim.py`` for the ported methods, DFSPH, WCSPH, PCISPH
and IISPH (line numbers name its functions). PyTorch runs eagerly, so there
is no jit and no scan: ``step`` runs one step and ``run`` loops over it.
Every tensor of the state lives on the simulation's device, and the device
defaults to ``"cuda"``; on a host without CUDA, ask for ``device="cpu"``
explicitly.
"""
from __future__ import annotations

import importlib

import torch

from .core.params import MATERIAL_FLUID, MATERIAL_NONE, SimParams
from .core.state import ParticleState, RigidState, SimState
from .ops import neighbors as nblib
from .ops import pairs
from .ops import permute as permlib
from .solvers import common


# the ported simulation methods, each the name of its module in .solvers
METHODS = ("dfsph", "wcsph", "pcisph", "iisph")


def _check_ported(params: SimParams) -> None:
    if params.simulation_method not in METHODS:
        raise NotImplementedError(
            f"simulation method {params.simulation_method} is not ported yet "
            "(ROADMAP Queue A.9b)")
    if params.viscosity_method != "standard":
        raise NotImplementedError("implicit viscosity is not ported yet "
                                  "(ROADMAP Queue A.10)")
    if params.has_entries:
        raise NotImplementedError("deferred entries and emitters are not "
                                  "ported yet (ROADMAP Queue A.12)")


def permuted_keys(params: SimParams) -> tuple:
    """Per-particle arrays that carry across the sort (:25): (fields of the
    particles, fields of the state itself: IISPH's advected density and the
    DFSPH warm-start carries)."""
    keys = ("pos", "vel", "mass", "rest_volume", "density", "material",
            "object_id", "is_dynamic")
    if params.has_rigid:
        keys += ("rigid_rest_pos",)
    extras = ()
    if params.simulation_method == "iisph":
        extras += ("iisph_density_star",)
    if params.dfsph_warm_start:
        extras += ("dfsph_kappa",)
    if params.dfsph_warm_start_div:
        extras += ("dfsph_kappa_v",)
    return keys, extras


def sort_state(state: SimState, params: SimParams):
    """Sort the carried per-particle arrays by grid cell (:56). The cell ids
    ride through the same fused gather, so the sorted ids are the ones the
    sort used. Returns (sorted state, sorted cell ids, permutation)."""
    p = state.particles
    active = p.material != MATERIAL_NONE
    cells = nblib.flat_cell_ids(p.pos, active, params)
    perm = nblib.sort_permutation(cells)
    keys, extras = permuted_keys(params)
    arrays = {k: getattr(p, k) for k in keys}
    arrays.update({k: getattr(state, k) for k in extras})
    arrays["cells"] = cells
    out = permlib.permute_fields(perm, arrays)
    cells_sorted = out.pop("cells")
    state = state.replace(**{k: out.pop(k) for k in extras})
    return state.replace(particles=p.replace(**out)), cells_sorted, perm


def produces_output(p: ParticleState, rigid: RigidState,
                    params: SimParams) -> torch.Tensor:
    """Rows whose pair sums are ever read (:159): the fluid rows, as there
    are no dynamic rigid bodies on this path."""
    if params.has_dynamic_rigid:
        raise NotImplementedError("dynamic rigid bodies are not ported yet "
                                  "(ROADMAP Queue A.11, rigid bodies)")
    return p.material == MATERIAL_FLUID


def build_env(cells_sorted: torch.Tensor, produce: torch.Tensor,
              params: SimParams) -> pairs.PairEnv:
    """The pair environment of the scene's engine over one sorted layout
    (:188)."""
    if params.resolved_pair_backend() == "pallas":
        return pairs.make_slab_env(cells_sorted, produce, params)
    return pairs.make_pair_env(cells_sorted, produce, params)


class Plumbing:
    """Shared step stages (:215)."""

    @staticmethod
    def neighbor_prep(state: SimState, params: SimParams):
        """Sort every carried array by grid cell and build the pair
        environment (:221)."""
        state, cells_sorted, _ = sort_state(state, params)
        produce = produces_output(state.particles, state.rigid, params)
        return state, build_env(cells_sorted, produce, params)

    @staticmethod
    def non_pressure_acceleration(p: ParticleState, rigid: RigidState,
                                  env: pairs.PairEnv, params: SimParams):
        """Gravity (assign) + surface tension + standard viscosity (:256)."""
        acc = common.gravity_acceleration(p, params)
        a_v, rf, rt = common.nonpressure_fused(p, rigid, env, params)
        rigid = rigid.replace(force=rigid.force + rf, torque=rigid.torque + rt)
        return p.replace(acc=acc + a_v), rigid

    @staticmethod
    def rigid_and_tail(state: SimState, params: SimParams) -> SimState:
        """The feed-forward methods' step ending (:341) with static walls
        only: the domain clamp of the fluid, then time and step count."""
        p = common.enforce_domain_boundary(state.particles, params,
                                           MATERIAL_FLUID)
        return state.replace(particles=p, t=state.t + params.dt,
                             step_count=state.step_count + 1)

    @staticmethod
    def diagnostics(state: SimState, env: pairs.PairEnv, params: SimParams,
                    extra: dict | None = None) -> dict:
        """Per-step diagnostics, the keys of the JAX package (:364). The
        overflow and incremental-sort counters are 0 by construction: the
        port has no window or sort caps and always sorts in full."""
        p = state.particles
        dev = p.pos.device
        fluid = p.material == MATERIAL_FLUID
        nf = torch.clamp_min(common.global_sum(fluid, params), 1)
        zero_f = torch.zeros((), dtype=torch.float32, device=dev)
        zero_i = torch.zeros((), dtype=torch.int32, device=dev)
        cap2 = (0.999 * (params.vel_cap_cfl * params.particle_diameter
                         / params.dt)) ** 2
        d = dict(
            fluid_num=common.global_sum(fluid, params).to(torch.int32),
            density_avg=common.global_sum(
                torch.where(fluid, p.density, zero_f), params) / nf,
            density_max=common.global_max(
                torch.where(fluid, p.density, zero_f), params),
            vel_max=common.global_max(
                torch.where(fluid[:, None], torch.abs(p.vel), zero_f), params),
            vel_capped=(common.global_sum(
                fluid & (torch.sum(p.vel * p.vel, dim=-1) >= cap2),
                params).to(torch.int32)
                if params.vel_cap_cfl > 0 else zero_i),
            neighbor_overflow=zero_i,
            sort_overflow_inc=zero_i,
            sort_crossers=zero_i,
            sort_inc_taken=zero_i,
            sort_overflow=zero_i,
        )
        if extra:
            d.update(extra)
        return d


def get_step_fn(params: SimParams):
    """The step function of the scene's method (:403), with the overflow
    accumulators carried in the state (:427-442)."""
    _check_ported(params)
    solver = importlib.import_module(f".solvers.{params.simulation_method}",
                                     __package__)

    def step_with_overflow_accounting(state: SimState):
        state, diag = solver.step(state, params, Plumbing)
        so = diag["sort_overflow"]
        wo = diag["neighbor_overflow"] - so
        sort_acc = state.sort_overflow_acc + so
        win_max = torch.maximum(state.window_overflow_max, wo)
        state = state.replace(sort_overflow_acc=sort_acc,
                              window_overflow_max=win_max)
        diag["sort_overflow_acc"] = sort_acc
        diag["window_overflow_max"] = win_max
        return state, diag

    return step_with_overflow_accounting


def prepare(state: SimState, params: SimParams) -> SimState:
    """Initial setup (:447): sort, the Akinci volumes of the rigid particles,
    then, for DFSPH only, density and alpha. Every object of a loadable scene
    is present from t = 0, so there is nothing to activate."""
    _check_ported(params)
    state, env = Plumbing.neighbor_prep(state, params)
    p = state.particles
    if params.has_rigid:
        p = common.compute_rigid_volume_fixedk(p, env, params)
    state = state.replace(particles=p, cached_neighbors=env)
    if params.simulation_method != "dfsph":
        return state
    from .solvers import dfsph
    p = p.replace(density=common.compute_density(p, env, params))
    alpha = dfsph.compute_alpha(p, env, params)
    return state.replace(particles=p, dfsph_alpha=alpha)


class Simulation:
    """User-facing driver: prepares the state on ``device`` and steps it.

    ``device`` defaults to ``"cuda"``, where every pair pass and every sort
    runs through the CUDA kernels of ``csrc/``; on a host without CUDA this
    raises instead of carrying on on the CPU. ``device="cpu"`` runs the
    plain PyTorch versions of the kernels. ``params.pair_backend`` picks the
    pair engine on either device (``SimParams.resolved_pair_backend``)."""

    def __init__(self, scene, state: SimState, device="cuda"):
        device = torch.device(device)
        if device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("Simulation(device='cuda'): CUDA is not "
                               "available on this host; pass device='cpu' "
                               "to run the plain PyTorch path")
        self.scene = scene
        self.params = scene.params
        self.device = device
        self._step = get_step_fn(self.params)
        self.state = prepare(state.to(device), self.params)

    def step(self) -> dict:
        """One step; returns the diagnostics as 0-dim tensors."""
        self.state, diag = self._step(self.state)
        return diag

    def run(self, n_steps: int) -> dict:
        """``n_steps`` steps; returns the diagnostics stacked per step."""
        diags = [self.step() for _ in range(n_steps)]
        return {k: torch.stack([d[k] for d in diags]) for k in diags[0]}

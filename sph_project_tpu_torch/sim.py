"""Simulation orchestration: the per-step sort, prepare, the step, the driver.

The JAX package's ``sim.py`` for the ported methods, DFSPH, WCSPH, PCISPH
and IISPH, with standard or implicit viscosity, over fluid, static walls,
dynamic rigid bodies with the integrator backend, deferred entries and
emitters (line numbers name its functions). PyTorch runs eagerly,
so there is no jit and no scan: ``step`` runs one step and ``run`` loops over
it. Every tensor of the state lives on the simulation's device, and the
device defaults to ``"cuda"``; on a host without CUDA, ask for
``device="cpu"`` explicitly.
"""
from __future__ import annotations

import importlib

import torch

from .core.params import (MATERIAL_FLUID, MATERIAL_NONE, MATERIAL_RIGID,
                          SimParams)
from .core.state import ParticleState, RigidState, SimState
from .ops import neighbors as nblib
from .ops import pairs
from .ops import permute as permlib
from .rigid import integrator as rigidlib
from .solvers import common


# the ported simulation methods, each the name of its module in .solvers
METHODS = ("dfsph", "wcsph", "pcisph", "iisph")


def _check_ported(params: SimParams) -> None:
    if params.simulation_method not in METHODS:
        raise NotImplementedError(
            f"simulation method {params.simulation_method} is not ported yet "
            "(ROADMAP Queue A.9b)")
    if params.viscosity_method not in ("standard", "implicit"):
        raise NotImplementedError(params.viscosity_method)
    if params.has_dynamic_rigid and params.rigid_solver != "integrator":
        raise NotImplementedError(
            f"rigid_solver={params.rigid_solver!r} is not ported yet "
            "(ROADMAP Queue A.11b, shape matching)")


def permuted_keys(params: SimParams) -> tuple:
    """Per-particle arrays that carry across the sort (:25): (fields of the
    particles, fields of the state itself: the implicit viscosity's warm
    start, IISPH's advected density and the DFSPH warm-start carries)."""
    keys = ("pos", "vel", "mass", "rest_volume", "density", "material",
            "object_id", "is_dynamic")
    if params.has_rigid:
        keys += ("rigid_rest_pos",)
    if params.has_entries:
        keys += ("entry_time", "entry_material")
    extras = ()
    if params.viscosity_method == "implicit":
        extras += ("visc_x",)
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
    sort used. The gather is a full permutation of every row, so a burst of
    deferred entries needs no other path (the JAX package turns its sort
    kernel off for one, ``scene.py`` :289-296). Returns (sorted state,
    sorted cell ids, permutation)."""
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
    """Rows whose pair sums are ever read (:159): the fluid rows and the
    particles of dynamic rigid bodies, never emitter placeholders (rigid
    rows of a fluid object)."""
    fluid = p.material == MATERIAL_FLUID
    if not params.has_dynamic_rigid:
        return fluid
    obj_mat = rigid.obj_material[common.object_index(p, params)]
    return fluid | ((p.is_dynamic > 0) & (obj_mat == MATERIAL_RIGID))


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
                                  env: pairs.PairEnv, state: SimState,
                                  params: SimParams):
        """Gravity (assign) + surface tension + viscosity (:256), standard
        or implicit. The implicit solve's new ``visc_x`` goes no further, as
        in the JAX package (:269-275, which returns only the particles and
        bodies): every solve starts from x0 = v."""
        acc = common.gravity_acceleration(p, params)
        if params.viscosity_method == "implicit":
            from .solvers import viscosity_cg
            p, rigid, _ = viscosity_cg.implicit_viscosity_solve(
                p.replace(acc=acc), rigid, state, env, params)
            return p, rigid
        a_v, rf, rt = common.nonpressure_fused(p, rigid, env, params)
        rigid = rigid.replace(force=rigid.force + rf, torque=rigid.torque + rt)
        return p.replace(acc=acc + a_v), rigid

    @staticmethod
    def activate_entries(state: SimState, params: SimParams) -> SimState:
        """Objects whose entry time has come join as mask flips (:280):
        particles take their entry material, bodies become present. Without
        deferred entries in the scene there is nothing to flip: the loader
        made every object present and gave no row an entry material."""
        if not params.has_entries:
            return state
        p, rigid = state.particles, state.rigid
        t = state.t
        enter = (p.material == MATERIAL_NONE) & \
            (p.entry_material != MATERIAL_NONE) & (p.entry_time <= t)
        p = p.replace(material=torch.where(enter, p.entry_material,
                                           p.material))
        r_enter = (rigid.present == 0) & (rigid.entry_time <= t) & \
            (rigid.obj_material != MATERIAL_NONE)
        rigid = rigid.replace(present=torch.where(
            r_enter, torch.ones_like(rigid.present), rigid.present))
        return state.replace(particles=p, rigid=rigid)

    @staticmethod
    def rigid_mid(state: SimState, env: pairs.PairEnv,
                  params: SimParams) -> SimState:
        """Rigid dynamics mid-step (:295, integrator backend): the contact
        pass over the dynamic bodies' particles on ``env`` (whose sort their
        positions still match), the body step, which consumes the
        accumulated wrench, the entries whose time has come (every step,
        under every method), then the particles placed at their bodies' new
        poses."""
        if not params.has_dynamic_rigid:
            return Plumbing.activate_entries(state, params)
        p, rigid = state.particles, state.rigid
        contact = (rigidlib.rigid_contact_data(p, rigid, env, params)
                   if params.contact_channels else None)
        rigid = rigidlib.rigid_body_step(p, rigid, params, contact=contact)
        state = Plumbing.activate_entries(state.replace(rigid=rigid), params)
        p = common.renew_rigid_particle_state(state.particles, state.rigid,
                                              params)
        return state.replace(particles=p)

    @staticmethod
    def rigid_and_tail(state: SimState, env: pairs.PairEnv,
                       params: SimParams) -> SimState:
        """The feed-forward methods' step ending (:341): rigid_mid, the
        domain clamp of the fluid, the dynamic rigid particles' volumes at
        their new positions (on ``env``, sorted before they moved), then
        time and step count."""
        state = Plumbing.rigid_mid(state, env, params)
        p = common.enforce_domain_boundary(state.particles, params,
                                           MATERIAL_FLUID)
        if params.has_dynamic_rigid:
            p = common.compute_rigid_particle_volume(p, env, params)
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
    """Initial setup (:447): the objects present at t = 0 activated, fluid
    above g_upper made emitter placeholders, the dynamic rigid particles
    placed at their bodies' poses, sort, the Akinci volumes of the rigid
    particles, then, for DFSPH only, density and alpha."""
    _check_ported(params)
    state = Plumbing.activate_entries(state, params)
    state = state.replace(particles=common.prepare_emitter(state.particles,
                                                           params))
    if params.has_dynamic_rigid:
        state = state.replace(particles=common.renew_rigid_particle_state(
            state.particles, state.rigid, params))
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

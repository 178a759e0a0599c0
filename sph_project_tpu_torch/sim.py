"""Simulation orchestration: the per-step sort, prepare, the step, the driver.

The JAX package's ``sim.py`` for the ported methods, DFSPH, WCSPH, PCISPH,
IISPH and PBF, with standard or implicit viscosity, under the cubic spline
or the poly6 kernel, in 3D and 2D, over fluid, static walls, dynamic rigid
bodies with the integrator or the shape-matching backend, deferred entries
and emitters (line numbers name its functions). On the card
:class:`Simulation` captures the step into a CUDA graph, its solver loops
conditional WHILE nodes (``ops/graph_loop.py``): the counterpart of the JAX
package's ``jax.jit`` step with ``lax.while_loop`` solvers, and ``run`` of
its ``lax.scan``. On the CPU the same step runs eagerly. Every tensor of the
state lives on the simulation's device, and the device defaults to
``"cuda"``; on a host without CUDA, ask for ``device="cpu"`` explicitly.
"""
from __future__ import annotations

import dataclasses
import importlib
import time

import torch

from .core.params import (MATERIAL_FLUID, MATERIAL_NONE, MATERIAL_RIGID,
                          SimParams)
from .core.state import ParticleState, RigidState, SimState
from .ops import graph_loop
from .ops import neighbors as nblib
from .ops import pairs
from .ops import permute as permlib
from .rigid import integrator as rigidlib
from .rigid import shape_matching as smlib
from .solvers import common
from .solvers import viscosity_cg


# the ported simulation methods, each the name of its module in .solvers
METHODS = ("dfsph", "wcsph", "pcisph", "iisph", "pbf")


def _check_ported(params: SimParams) -> None:
    method = params.simulation_method
    if method not in METHODS:
        raise NotImplementedError(f"simulation method {method} is unknown")
    if params.viscosity_method not in ("standard", "implicit"):
        raise NotImplementedError(params.viscosity_method)


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
        """Rigid dynamics mid-step (:295), over the dynamic bodies'
        particles on ``env`` (whose sort their positions still match), then
        the entries whose time has come (every step, under every method).
        The integrator backend: the contact pass, the body step, which
        consumes the accumulated wrench, then the particles placed at their
        bodies' new poses. The shape-matching backend: the DEM contact
        wrench added to the accumulated one, then the projection, which
        places the particles itself."""
        if not params.has_dynamic_rigid:
            return Plumbing.activate_entries(state, params)
        p, rigid = state.particles, state.rigid
        if params.rigid_solver == "shape_matching":
            cf, ct = rigidlib.rigid_contact_wrench(p, rigid, env, params)
            rigid = rigid.replace(force=rigid.force + cf,
                                  torque=rigid.torque + ct)
            p, rigid = smlib.shape_matching_step(p, rigid, params)
            return Plumbing.activate_entries(
                state.replace(particles=p, rigid=rigid), params)
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
        sort counters are 0 by construction: the port has no window or sort
        caps and always sorts in full. ``neighbor_overflow`` is 0 on one
        device (the environments have no caps) and, under the spatial
        decomposition, the halo's shortfall (``env.overflow``) summed over
        the ranks (:384)."""
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
            neighbor_overflow=(common.global_sum(env.overflow, params).to(
                torch.int32) if params.spmd_axis else zero_i),
            sort_overflow_inc=zero_i,
            sort_crossers=zero_i,
            sort_inc_taken=zero_i,
            sort_overflow=zero_i,
        )
        if extra:
            d.update(extra)
        return d


def graphed(params: SimParams) -> bool:
    """Whether :class:`Simulation` captures the step of ``params`` on the
    card: every configuration but the shape-matching rigid backend, whose
    ``torch.linalg.svd`` reads its convergence flags on the host."""
    return not (params.has_dynamic_rigid
                and params.rigid_solver == "shape_matching")


def get_step_fn(params: SimParams, plumbing=None):
    """The step function of the scene's method (:403), with the overflow
    accumulators carried in the state (:427-442). ``plumbing`` replaces
    :class:`Plumbing` (the spatial decomposition's, in
    ``parallel/spatial.py``)."""
    _check_ported(params)
    plumbing = plumbing or Plumbing
    solver = importlib.import_module(f".solvers.{params.simulation_method}",
                                     __package__)

    def step_with_overflow_accounting(state: SimState):
        state, diag = solver.step(state, params, plumbing)
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


def _tensors(tree, path=()):
    """``(path, tensor)`` for every tensor of a state, its pair environment's
    included, in field order."""
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if isinstance(v, torch.Tensor):
            yield path + (f.name,), v
        elif dataclasses.is_dataclass(v):
            yield from _tensors(v, path + (f.name,))


def _cloned(tree):
    """A copy of a state (or environment) whose every tensor is a fresh
    buffer of its own."""
    out = {}
    for f in dataclasses.fields(tree):
        v = getattr(tree, f.name)
        if isinstance(v, torch.Tensor):
            v = v.clone()
        elif dataclasses.is_dataclass(v):
            v = _cloned(v)
        out[f.name] = v
    return dataclasses.replace(tree, **out)


def copy_state(dst: SimState, src: SimState) -> None:
    """Write every tensor of ``src`` into its counterpart in ``dst`` (same
    structure, shapes and dtypes, else it raises), as if all at once: a
    value that shares memory with another buffer of ``dst`` is copied aside
    first."""
    dst_t, src_t = list(_tensors(dst)), list(_tensors(src))
    if len(dst_t) != len(src_t) or \
            type(dst.cached_neighbors) is not type(src.cached_neighbors):
        raise ValueError("copy_state: the states differ in structure")
    held = {d.untyped_storage().data_ptr() for _, d in dst_t}
    moves = []
    for (pd, d), (ps, v) in zip(dst_t, src_t):
        if pd != ps or d.shape != v.shape or d.dtype != v.dtype:
            raise ValueError(f"copy_state: {'.'.join(ps)} is {v.dtype} "
                             f"{tuple(v.shape)}, the buffer "
                             f"{'.'.join(pd)} {d.dtype} {tuple(d.shape)}")
        if v is not d:
            shared = v.untyped_storage().data_ptr() in held
            moves.append((d, v.clone() if shared else v))
    for d, v in moves:
        d.copy_(v)


class Simulation:
    """User-facing driver: prepares the state on ``device`` and steps it.

    ``device`` defaults to ``"cuda"``, where every pair pass and every sort
    runs through the CUDA kernels of ``csrc/``; on a host without CUDA this
    raises instead of carrying on on the CPU. ``device="cpu"`` runs the
    plain PyTorch versions of the kernels. ``params.pair_backend`` picks the
    pair engine on either device (``SimParams.resolved_pair_backend``).

    On the card the step is one captured device program, as the JAX
    package's is one ``jax.jit`` program (``sim.py`` :474): after ``prepare``
    one eager step runs on a copy of the state (libraries loaded, kernel
    attributes set, the allocator warm; its result dropped), then
    ``ops.graph_loop.capture`` records the step, with every solver loop a
    conditional WHILE node, on static buffers: :attr:`state`'s tensors. A
    replay reads them and writes the next state back into them, so a step
    overwrites the tensors of the state before it (clone what must be kept),
    and assigning :attr:`state` copies into them. ``step`` replays once,
    ``run(n)`` n times with no host read, as ``lax.scan`` runs the JAX
    package's (:501). A capture that fails raises. The shape-matching rigid
    backend steps eagerly on the card: its polar factor
    (``torch.linalg.svd``) checks its result on the host. On the CPU the
    step runs eagerly through the same code, its loops on the host."""

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
        self._graph = None
        self._state = prepare(state.to(device), self.params)
        self.warmup_ms = self.capture_ms = 0.0
        if device.type == "cuda" and graphed(self.params):
            self._capture()

    @property
    def state(self) -> SimState:
        return self._state

    @state.setter
    def state(self, value: SimState) -> None:
        if self._graph is None:
            self._state = value
        else:
            copy_state(self._state, value)

    def _capture(self) -> None:
        """The warm-up step on a copy of the state, then the capture."""
        t0 = time.perf_counter()
        with graph_loop.uncounted(), graph_loop.warming():
            self._step(_cloned(self._state))
        torch.cuda.synchronize(self.device)
        t1 = time.perf_counter()
        static = _cloned(self._state)

        def step():
            new, diag = self._step(static)
            copy_state(static, new)
            keys = sorted(diag)
            bad = [k for k in keys if diag[k].dim() != 0 or diag[k].dtype
                   not in (torch.int32, torch.float32)]
            if bad:
                raise ValueError(f"diagnostics {bad} are not 0-dim int32 or "
                                 f"float32 tensors")
            # one row of 32-bit words, the float32 keys' bits kept
            row = torch.stack([diag[k].view(torch.int32) for k in keys])
            return keys, [diag[k].dtype for k in keys], row

        viscosity_cg.last_solve.clear()
        self._graph, self._counts, (keys, dtypes, self._row) = \
            graph_loop.capture(step, self.device)
        self._keys, self._dtypes = keys, dtypes
        # the implicit solve's numbers of a replay are the graph's tensors
        self._last_solve = dict(viscosity_cg.last_solve)
        self._state = static
        self.warmup_ms = (t1 - t0) * 1e3
        self.capture_ms = (time.perf_counter() - t1) * 1e3

    def _unpack(self, rows: torch.Tensor) -> dict:
        """The diagnostics of packed rows (``(..., keys)`` int32 words)."""
        return {k: rows[..., i].view(dt)
                for i, (k, dt) in enumerate(zip(self._keys, self._dtypes))}

    def _replay(self) -> None:
        self._graph.replay()
        self._counts.replayed()
        viscosity_cg.last_solve.update(self._last_solve)

    def step(self) -> dict:
        """One step; returns the diagnostics as 0-dim tensors."""
        if self._graph is None:
            self._state, diag = self._step(self._state)
            return diag
        self._replay()
        return self._unpack(self._row.clone())

    def run(self, n_steps: int) -> dict:
        """``n_steps`` steps; returns the diagnostics stacked per step. On
        the card the replays write each step's diagnostics into one device
        buffer, and nothing is read on the host."""
        if self._graph is None:
            diags = [self.step() for _ in range(n_steps)]
            return {k: torch.stack([d[k] for d in diags]) for k in diags[0]}
        rows = torch.empty((n_steps, len(self._keys)), dtype=torch.int32,
                           device=self.device)
        for i in range(n_steps):
            self._replay()
            rows[i].copy_(self._row)
        return self._unpack(rows)

"""Static simulation parameters.

The same fields and derivation rules as the JAX package's
``sph_project_tpu/core/params.py``, so a scene resolves to identical constants
(including the ``n_pad`` rule) and states bridge between the two packages row
for row. ``pair_backend`` keeps the JAX package's value strings, so the same
override selects the counterpart engine in both packages (see
``resolved_pair_backend``); ``pair_block`` sizes the slab-window engine's
blocks. The TPU engines' other sizing fields (``pair_slab*``, ``pair_chunk``,
``pair_wtile``, ``pair_dma_*``) are inert here: the port's kernels walk every
window to its true length. They are kept only so the two parameter sets stay
comparable field by field.

The fields mirror the scene ``Configuration`` schema of the reference
(``SPH/containers/base_container.py:10-66`` and
``SPH/fluid_solvers/base_solver.py:9-54`` in jason-huang03/SPH_Project), but are
resolved once on the host instead of being scattered over runtime objects.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

MATERIAL_NONE = 0  # slot is inactive (padding or not-yet-entered object)
MATERIAL_FLUID = 1
MATERIAL_RIGID = 2


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@dataclasses.dataclass(frozen=True)
class SimParams:
    """Static simulation constants (hashable, resolved once on the host)."""

    dim: int = 3
    # geometry
    particle_radius: float = 0.01          # dx in the reference
    support_radius: float = 0.04           # dh = 4*dx (3D) / 3*dx (2D)
    particle_spacing: float = 0.02         # lattice pitch = 2*dx by default
    v0: float = 0.8 * 0.02 ** 3            # rest volume 0.8*(2 dx)^dim
    domain_start: Tuple[float, ...] = (0.0, 0.0, 0.0)
    domain_end: Tuple[float, ...] = (1.0, 1.0, 1.0)
    grid_num: Tuple[int, ...] = (25, 25, 25)   # ceil(domain_size / dh)
    padding: float = 0.04                  # = dh, boundary clamp inset

    # physics
    density0: float = 1000.0
    gravity: Tuple[float, ...] = (0.0, -9.81, 0.0)
    dt: float = 1e-3
    viscosity: float = 0.01
    viscosity_b: float = 0.01
    surface_tension: float = 0.01
    g_upper: float = 10000.0               # emitter threshold height

    # solver selection / tolerances (reference defaults)
    simulation_method: str = "dfsph"
    viscosity_method: str = "standard"
    kernel_type: str = "cubic"             # "poly6" for PBF (PBF.py:21-47)
    wcsph_gamma: float = 7.0
    wcsph_stiffness: float = 50000.0
    dfsph_max_iter: int = 1000
    dfsph_max_iter_v: int = 1000
    dfsph_max_error: float = 1e-4
    dfsph_max_error_v: float = 1e-3
    dfsph_eps: float = 1e-5
    # warm-start the constant-density corrector from the previous step's
    # accumulated stiffness (Bender & Koschier, "Divergence-Free SPH" §
    # warm start; the reference solver is cold every step). Replaces the
    # star0 probe pass + usually one corrector iteration at settled state;
    # converges to the SAME tolerance, so physics quality is unchanged but
    # trajectories differ microscopically from the cold reference algorithm
    # — default OFF for reference parity. Scene key: dfsphWarmStart.
    dfsph_warm_start: bool = False
    # warm-start the DIVERGENCE-free corrector from the previous step's
    # accumulated kappa_v, same pattern as dfsph_warm_start. Adds one
    # correction + one derivative probe before the loop, so it only pays
    # off where the cold solver iterates a lot — quasi-static pileups
    # (the nine-rigid scene runs 10+ divergence iterations settled); the
    # fluid-only headline converges in 1, where this stays OFF. Same
    # tolerance, so physics quality is unchanged.
    # Scene key: dfsphWarmStartDiv.
    dfsph_warm_start_div: bool = False
    # warm-start strength: the pre-loop correction starts from
    # ``factor * kappa_prev``. 0.5 is the conservative classic (Bender &
    # Koschier); at settled state kappa is nearly constant step-to-step, so
    # a stronger factor can remove a whole corrector iteration at the SAME
    # exit tolerance. The avg-error exit tolerance is unchanged, but it does
    # NOT bound per-particle overshoot — local density spikes can hide under
    # a passing average (see CAUTION).
    # CAUTION (hardware-measured): 1.0 is stable on small settled scenes but
    # DIVERGED at the 1.23M headline scene mid-settle (rho_max 4170, mass
    # sort overflow — .hwq_results/bench_r4g_warm_wf1.log); the overshoot
    # compounds while the free surface is still falling. Keep 0.5 unless the
    # scene is near-hydrostatic. Scene key: dfsphWarmFactor.
    dfsph_warm_factor: float = 0.5
    # ADAPTIVE warm strength (round 5): when > 0, the warm factor switches
    # to this value on steps whose carried density field is quiescent
    # (max fluid density <= dfsph_warm_gate * density0), and falls back to
    # dfsph_warm_factor otherwise. Rationale (warm_diag_r5b.log +
    # warm_diag_headline_r5b.log): a full-strength guess saves 1-3
    # corrector iterations in settled/pileup regimes, and the wf=1.0
    # divergence mode only arms while impacts are compressing the fluid —
    # exactly when rho_max exceeds the gate and the factor drops back to
    # the conservative default. During free fall kappa_prev ~ 0, so the
    # open gate is harmless there. Costs one n-sized masked max per step.
    # Scene keys: dfsphWarmFactorHi, dfsphWarmGate. Default off.
    dfsph_warm_factor_hi: float = 0.0
    dfsph_warm_gate: float = 1.03
    # Per-particle arm of the adaptive gate: only particles moving less
    # than this fraction of a particle diameter per step get the hi factor.
    # The r5d 2000-step run (bench_r5d_warmhi_settle2000.log) showed the
    # GLOBAL gate alone is insufficient at deep rest: a stale carry on one
    # quiet-looking particle takes a full-strength kick, ejects (vel_max
    # 73-90 at hydrostatic rest), and the ejections eventually overflow a
    # plane's pad budget (sort overflow 10139 -> gate refusal). Fast or
    # oscillating particles now fall back to dfsph_warm_factor locally;
    # the bulk at rest (|v| dt << diameter) still gets the full carry.
    dfsph_warm_quiet_cfl: float = 0.25
    # Over-relaxation (SOR) on the constant-density corrector's stiffness
    # update (round 5). At TRUE hydrostatic settle the headline scene runs
    # 10-19 density iterations per step with loop-entry error only ~1.2-1.8x
    # the exit tolerance (warm_diag_headline_r5b.log): the Jacobi-style
    # kappa update propagates pressure one neighborhood hop per iteration,
    # so a ~45-cell-deep column crawls. omega scales each iteration's kappa
    # (and the accumulated warm carry sees the applied value). 1.0 is the
    # reference algorithm; the usable range is scene-dependent — the exit
    # test is on the REAL density error either way, so convergence quality
    # is unchanged, only the path. Density solver only (the divergence
    # solver converges in ~1 iteration everywhere measured).
    # Scene key: dfsphOmega.
    dfsph_omega: float = 1.0
    # CFL speed cap on fluid advection (round 5, engineering guard; 0
    # disables). The dam-break slam chaotically fires runaway particles —
    # the DEFAULT algorithm measured a 2562 m/s fluid particle at the
    # headline slam (bench_r5f_warm05_settle2000.log, step 300), 77x the
    # per-step CFL bound and ~500x the physical impact speed sqrt(2gh).
    # Such particles are numerically meaningless under a fixed dt, and
    # their flight through sparse space blows the pair engine's window
    # unions (93,985 truncated candidates in one step, r5g). The cap
    # rescales any fluid velocity above vel_cap_cfl particle diameters
    # per step at position-update time; diagnostics count the particles
    # at the cap (vel_capped), so it is never silent. DEVIATION from the
    # reference (base_solver.py:651-666 advects uncapped) — affects only
    # already-CFL-invalid outliers; the reference's own GGUI-era runs
    # simply tolerated the corruption invisibly. Scene key: velCapCfl.
    vel_cap_cfl: float = 1.0
    pcisph_max_iter: int = 1000
    pcisph_eta: float = 1e-3
    iisph_max_iter: int = 20
    iisph_eta: float = 1e-3
    iisph_omega: float = 0.2
    pbf_iters: int = 5
    # s_corr anti-clustering (PBF.py:12-14 defaults). The reference only
    # ever runs PBF in 2D (its 3D container allocates size-0 fields); at 3D
    # water scales (r=0.01) the reference constants make s_corr dominate the
    # constraint term ~6x and the fluid disperses — 3D scenes can tune or
    # disable it via Configuration pbfCorrK / pbfCorrDeltaQ
    pbf_corr_k: float = 0.001
    pbf_corr_delta_q: float = 0.3
    cg_tol: float = 1e-6
    cg_max_iter: int = 1000

    # capacities (static shapes)
    n_particles: int = 0                   # active slots (<= n_pad)
    n_pad: int = 0                         # padded particle capacity
    max_objects: int = 32                  # reference: max_num_object=20
    neighbor_cap: int = 64                 # K: neighbors kept per particle
    cell_cap: int = 24                     # C: candidates read per grid cell
    build_chunk: int = 16384               # particles per neighbor-build chunk
    # dense pair engine (ops/pairs.py)
    pair_block: int = 256                  # B: particles per block
    pair_slab: int = 512                   # S: window cap per stencil segment
    pair_chunk: int = 8                    # blocks per lax.map chunk (memory cap)
    pair_wtile: int = 768                  # window-axis tile for the Pallas path
    # "auto": kernel-side-DMA engine (pair_dma.py) on TPU, chunked-JAX slab
    # engine elsewhere; explicit values: "pallas_dma" / "pallas" / "jax"
    pair_backend: str = "auto"
    # outlier bucketing: blocks whose windows exceed pair_slab rerun with
    # pair_slab_big windows (0 disables); M = NB // pair_big_frac slots
    pair_slab_big: int = 0
    pair_big_frac: int = 16
    # kernel-side-DMA engine (ops/pair_dma.py; pair_backend == "pallas_dma")
    pair_dma_group: int = 8                # G: sub-blocks (of B=64) per superblock
    pair_dma_su: int = 16384               # per-superblock window VMEM lane budget

    # spatial multi-chip execution (parallel/spatial.py): when set, the step
    # runs inside shard_map over this mesh axis — global reductions psum, the
    # pair engine sees halo-extended local arrays
    spmd_axis: str | None = None
    # max particles in any single x-cell-plane of the SEEDED scene (set at
    # scene build); parallel/spatial.halo_width derives the halo size from it
    # (one plane of reach + growth margin) instead of a VMEM-budget proxy
    halo_plane_max: int = 0

    # rigid contact model (replaces Bullet; see rigid/integrator.py)
    has_rigid: bool = True                 # static: scene contains rigid particles
    # static: any rigid BODY is dynamic. Wall-only scenes (the headline
    # dam break: fluid + static domain-box shell) skip the whole dynamic
    # machinery — body integration, per-particle (com, rot) renewal
    # gathers, per-pass wrench outputs + segment reductions, per-step
    # pseudo-volume recompute — all of which are masked no-ops for static
    # geometry (apply_rigid_volume/renew select is_dynamic>0 rows only)
    has_dynamic_rigid: bool = True
    has_entries: bool = True               # static: deferred entryTime / emitter
    # one-hot MXU permute kernel for the per-step sort; scenes whose deferred
    # entries exceed the kernel's sparse-fix budget use exact gathers instead
    sort_kernel: bool = True
    # build the per-step sort permutation incrementally from the previous
    # layout (cell-crossers only) instead of a full stable argsort. HYBRID:
    # the step counts the crossers exactly and lax.cond-selects the full
    # stable argsort whenever they exceed the static budget (the coherent
    # fall moves ~n_fluid records in one step), so the incremental branch's
    # record-zeroing overflow is structurally unreachable. Default off until
    # hardware-validated (see tools/inc_sort_diag.py and ROADMAP).
    sort_incremental: bool = False
    # crosser budget override for the incremental sort: 0 = auto
    # (max(4096, n_pad//4)); tests force the full-sort branch with tiny
    # values, tuning can shrink the K-sized mover sort
    sort_inc_budget: int = 0
    rigid_solver: str = "integrator"       # "integrator" | "shape_matching"
    contact_restitution: float = 0.0       # body-pair impulse contact (Bullet default)
    contact_stiffness: float = 1e5         # DEM spring (shape-matching backend)
    contact_damping: float = 0.1
    # object ids of DYNAMIC rigid bodies: each gets its own exact contact
    # channel in the pair pass (rigid/integrator.py rigid_contact_data), so a
    # particle touching several bodies at once keeps separate records; all
    # static rigid geometry shares one merged channel (inv mass 0 — the
    # impulse math cannot tell static bodies apart)
    contact_channels: tuple = ()
    contact_iters: int = 4                 # sequential-impulse sweeps per step
    contact_friction: float = 0.5          # Coulomb mu (Bullet's URDF default)
    wall_friction: float = 0.1
    wall_thickness: float = 0.0            # domain_box_thickness (0.03 w/ addDomainBox)

    def resolved_pair_backend(self) -> str:
        """The pair engine of this parameter set: ``"pallas_dma"`` (also
        ``"auto"``) is the cell-list kernel, ``"pallas"`` the slab-window
        kernel, the counterparts of the JAX package's engines of those names.
        Its chunked-JAX executor (``"jax"``) has no engine here: the plain
        PyTorch versions run for tensors on the CPU."""
        if self.pair_backend in ("auto", "pallas_dma"):
            return "pallas_dma"
        if self.pair_backend == "pallas":
            return "pallas"
        if self.pair_backend == "jax":
            raise ValueError(
                'pair_backend="jax" has no counterpart in the port; run the '
                'plain PyTorch versions with Simulation(..., device="cpu")')
        raise ValueError(f"unknown pair_backend {self.pair_backend!r}")

    @property
    def num_cells(self) -> int:
        n = 1
        for g in self.grid_num:
            n *= g
        return n

    @property
    def cubic_k(self) -> float:
        """Cubic-spline normalization constant (reference base_solver.py:56-78)."""
        if self.dim == 1:
            k = 4.0 / 3.0
        elif self.dim == 2:
            k = 40.0 / 7.0 / math.pi
        else:
            k = 8.0 / math.pi
        return k / self.support_radius ** self.dim

    @property
    def particle_diameter(self) -> float:
        return 2.0 * self.particle_radius


def make_params(n_particles: int, **kw) -> SimParams:
    """Build SimParams, deriving dependent quantities the way the reference does."""
    dim = kw.pop("dim", 3)
    dx = kw.pop("particle_radius", 0.01)
    dh = kw.pop("support_radius", None)
    if dh is None:
        dh = dx * (4.0 if dim == 3 else 3.0)
    spacing = kw.pop("particle_spacing", None)
    if spacing is None:
        spacing = 2.0 * dx
    domain_start = tuple(kw.pop("domain_start", (0.0,) * dim))
    domain_end = tuple(kw.pop("domain_end", (1.0,) * dim))
    grid_num = tuple(
        int(math.ceil((e - s) / dh)) for s, e in zip(domain_start, domain_end)
    )
    blk = kw.get("pair_block", 256)
    # + per-x-plane padding budget for the DMA engine's plane-padded layout
    # (ops/neighbors.py plane_padded_permutation): each of the gx planes and
    # the sentinel tail may round up to the next 64-slot boundary
    plane_budget = (grid_num[0] + 1) * 64
    n_pad = _round_up(max(n_particles, 1) + plane_budget, max(1024, blk))
    if "pair_dma_group" not in kw:
        # adaptive superblock: small scenes get small superblocks so the
        # per-superblock plane hull stays within the DMA engine's P_CAP
        g2 = 1
        while g2 < 8 and 64 * (g2 * 2) * 8 <= n_pad:
            g2 *= 2
        kw["pair_dma_group"] = g2
    return SimParams(
        dim=dim,
        particle_radius=dx,
        support_radius=dh,
        particle_spacing=spacing,
        v0=0.8 * (2.0 * dx) ** dim,
        domain_start=domain_start,
        domain_end=domain_end,
        grid_num=grid_num,
        padding=dh,
        n_particles=n_particles,
        n_pad=n_pad,
        **kw,
    )

"""Plain PyTorch reference of one step of the benchmark's configurations.

An implementation of the reference project's formulas (jason-huang03/
SPH_Project: the cubic spline, ``base_solver.py:56-103``; density summation,
``:521-541``; surface tension and standard viscosity, ``:202-278``; the DFSPH
alpha factor and both correctors, ``DFSPH.py:22-319``; the boundary clamp,
``:603-665``; Akinci boundary volumes) with static walls, and the implicit
viscosity of Weiler et al. 2018 (block-Jacobi preconditioned CG). The
formulas are those of the float64 test oracle ``tests/oracle.py``, frozen
here and extended with walls, computed over an explicit list of pairs built
from a cell grid and summed in blocks, so that two million rows fit on one
card.

It imports nothing of the measured program. Of the snapshot it is handed
(``benchmark/harness.py`` states what a reference is handed) it reads the
positions, velocities and materials, and works out everything else again:
the wall volumes, the densities and alpha factors at the start of the step,
the neighbours before and after the advection, and the step itself. Every
quantity is computed in ``dtype`` (float64 for the reference; a lower
precision for the control).
"""
from __future__ import annotations

import dataclasses
import math

import torch

FLUID, RIGID = 1, 2


@dataclasses.dataclass(frozen=True)
class Physics:
    """The constants of one configuration, derived from its scene file the
    way the reference project derives them."""
    dim: int
    radius: float
    h: float
    v0: float
    rho0: float
    fluid_density: float
    gravity: tuple
    dt: float
    viscosity: float
    viscosity_b: float
    viscosity_method: str
    surface_tension: float
    domain_start: tuple
    domain_end: tuple
    grid_num: tuple
    max_error: float
    max_error_v: float
    max_iter: int
    max_iter_v: int
    eps: float
    vel_cap_cfl: float
    cg_tol: float
    cg_max_iter: int

    @property
    def diameter(self) -> float:
        return 2.0 * self.radius

    @property
    def padding(self) -> float:
        return self.h


# What this reference models: a DFSPH step, cold, with standard or implicit
# viscosity, over fluid present from the start and static walls. A scene key
# or an override outside these sets is refused, not ignored.
SCENE_KEYS = {"Configuration", "FluidBlocks", "FluidBodies"}
CONFIGURATION_KEYS = {
    "domainStart", "domainEnd", "addDomainBox", "particleRadius",
    "supportRadius", "density0", "gravitation", "simulationMethod",
    "viscosityMethod", "viscosity", "viscosity_b", "timeStepSize", "fps",
    "totalTime", "exportFrame", "exportPly", "exportObj"}
OVERRIDE_KEYS = {"pair_backend"}
VISCOSITY_METHODS = ("standard", "implicit")


def modelled(config: dict) -> None:
    """Raise ``ValueError`` where the configuration asks for what the
    reference does not model: another solver, rigid bodies, emitters or
    late entries, warm starts or any other option it does not read."""
    scene = config["scene"]
    c = scene["Configuration"]
    bad = [f"scene key {k}" for k in sorted(set(scene) - SCENE_KEYS)]
    bad += [f"Configuration key {k}"
            for k in sorted(set(c) - CONFIGURATION_KEYS)]
    bad += [f"override {k}"
            for k in sorted(set(config.get("overrides", {})) - OVERRIDE_KEYS)]
    if c.get("simulationMethod", "dfsph") != "dfsph":
        bad.append(f"simulationMethod {c['simulationMethod']}")
    if c.get("viscosityMethod", "standard") not in VISCOSITY_METHODS:
        bad.append(f"viscosityMethod {c['viscosityMethod']}")
    fluids = scene.get("FluidBlocks", []) + scene.get("FluidBodies", [])
    if any(b.get("entryTime", -1.0) > 0 for b in fluids):
        bad.append("a fluid that enters after the start")
    if bad:
        raise ValueError("the reference does not model: " + ", ".join(bad))


def physics_of(config: dict) -> Physics:
    """The :class:`Physics` of a configuration file's ``scene`` and
    ``constants``; raises ``ValueError`` on what :func:`modelled`
    refuses."""
    modelled(config)
    c = config["scene"]["Configuration"]
    k = config["constants"]
    dim = len(c["domainEnd"])
    r = c.get("particleRadius", 0.01)
    h = c.get("supportRadius") or r * (4.0 if dim == 3 else 3.0)
    start = tuple(float(x) for x in c.get("domainStart", (0.0,) * dim))
    end = tuple(float(x) for x in c["domainEnd"])
    blocks = config["scene"].get("FluidBlocks", []) + \
        config["scene"].get("FluidBodies", [])
    dens = {b.get("density", 1000.0) for b in blocks}
    if len(dens) != 1:
        raise ValueError("the reference takes one fluid density")
    visc = c.get("viscosity", 0.01)
    return Physics(
        dim=dim, radius=r, h=h, v0=0.8 * (2.0 * r) ** dim,
        rho0=c.get("density0", 1000.0), fluid_density=dens.pop(),
        gravity=tuple(c.get("gravitation", (0.0, -9.81, 0.0)[:dim])),
        dt=c.get("timeStepSize", 1e-3), viscosity=visc,
        viscosity_b=c.get("viscosity_b", visc),
        viscosity_method=c.get("viscosityMethod", "standard"),
        surface_tension=k["surface_tension"], domain_start=start,
        domain_end=end,
        grid_num=tuple(int(math.ceil((e - s) / h))
                       for s, e in zip(start, end)),
        max_error=k["dfsph_max_error"], max_error_v=k["dfsph_max_error_v"],
        max_iter=k["dfsph_max_iter"], max_iter_v=k["dfsph_max_iter_v"],
        eps=k["dfsph_eps"], vel_cap_cfl=k["vel_cap_cfl"],
        cg_tol=k["cg_tol"], cg_max_iter=k["cg_max_iter"])


# ---- the cubic spline (base_solver.py:56-103) ------------------------------

def _sigma(ph: Physics) -> float:
    k = 8.0 / math.pi if ph.dim == 3 else 40.0 / 7.0 / math.pi
    return k / ph.h ** ph.dim


def kernel_w(r: torch.Tensor, ph: Physics) -> torch.Tensor:
    q = r / ph.h
    w = torch.where(q <= 0.5, 6.0 * (q ** 3 - q ** 2) + 1.0,
                    2.0 * (1.0 - torch.clamp_max(q, 1.0)) ** 3)
    return _sigma(ph) * torch.where(q < 1.0, w, torch.zeros_like(w))


def kernel_gw(r: torch.Tensor, ph: Physics) -> torch.Tensor:
    """The coefficient c of grad W = c * (x_i - x_j)."""
    q = r / ph.h
    k6 = 6.0 * _sigma(ph)
    c = torch.where(q <= 0.5, k6 * q * (3.0 * q - 2.0),
                    -k6 * (1.0 - torch.clamp_max(q, 1.0)) ** 2)
    ok = (q < 1.0) & (r > 1e-12)
    return torch.where(ok, c / (torch.clamp_min(r, 1e-12) * ph.h),
                       torch.zeros_like(c))


# ---- neighbours --------------------------------------------------------------

def _offsets(dim: int, device) -> torch.Tensor:
    g = torch.meshgrid(*[torch.arange(-1, 2, device=device)] * dim,
                       indexing="ij")
    return torch.stack([x.reshape(-1) for x in g], 1)


def close_pairs(query: torch.Tensor, points: torch.Tensor, radius: float,
                block: int = 1 << 16, same: bool = True):
    """Every (q, p) with |query[q] - points[p]|^2 < radius^2 (and q != p
    when ``same``), found over a grid of cells of side ``radius``. Returns
    (q index, p index, squared distance), int64, int64 and the points'
    dtype."""
    dev = points.device
    lo = torch.minimum(query.min(0).values, points.min(0).values) - radius
    cell_p = torch.floor((points - lo) / radius).long()
    cell_q = torch.floor((query - lo) / radius).long()
    g = torch.maximum(cell_p.max(0).values, cell_q.max(0).values) + 2
    strides = torch.ones_like(g)
    for d in range(g.numel() - 2, -1, -1):
        strides[d] = strides[d + 1] * g[d + 1]
    flat = (cell_p * strides).sum(1)
    order = torch.sort(flat, stable=True).indices
    counts = torch.bincount(flat, minlength=int(g.prod()))
    starts = torch.cumsum(counts, 0) - counts
    offs = _offsets(points.shape[1], dev)
    qs, ps, ds = [], [], []
    r2 = radius * radius
    for b0 in range(0, query.shape[0], block):
        rows = torch.arange(b0, min(b0 + block, query.shape[0]), device=dev)
        nc = cell_q[rows][:, None, :] + offs[None]
        nf = torch.clamp((nc * strides).sum(-1), 0, counts.numel() - 1)
        cnt = counts[nf]
        st = starts[nf]
        m = int(cnt.max()) if cnt.numel() else 0
        if m == 0:
            continue
        k = torch.arange(m, device=dev)
        slot = torch.clamp(st[..., None] + k, max=points.shape[0] - 1)
        ok = k < cnt[..., None]
        cand = order[slot]
        diff = points[cand] - query[rows][:, None, None, :]
        d2 = (diff * diff).sum(-1)
        keep = ok & (d2 < r2)
        if same:
            keep &= cand != rows[:, None, None]
        qi = rows[:, None, None].expand_as(cand)[keep]
        qs.append(qi)
        ps.append(cand[keep])
        ds.append(d2[keep])
    if not qs:
        e = torch.zeros(0, dtype=torch.long, device=dev)
        return e, e, torch.zeros(0, dtype=points.dtype, device=dev)
    return torch.cat(qs), torch.cat(ps), torch.cat(ds)


class Pairs:
    """The pairs within the support radius of every active row, with their
    geometry: R = x_i - x_j, r, W(r) and the gradient coefficient."""

    def __init__(self, x: torch.Tensor, active: torch.Tensor, ph: Physics):
        idx = torch.nonzero(active).flatten()
        xa = x[idx]
        qi, pj, d2 = close_pairs(xa, xa, ph.h)
        self.i, self.j = idx[qi], idx[pj]
        self.n = x.shape[0]
        self.R = x[self.i] - x[self.j]
        self.d2 = (self.R * self.R).sum(1)
        self.r = torch.sqrt(self.d2)
        self.W = kernel_w(self.r, ph)
        self.gw = kernel_gw(self.r, ph)

    def sum(self, vals: torch.Tensor) -> torch.Tensor:
        """Per-row sums over each row's pairs of per-pair values (P,) or
        (P, d)."""
        out = torch.zeros((self.n,) + tuple(vals.shape[1:]), dtype=vals.dtype,
                          device=vals.device)
        return out.index_add_(0, self.i, vals)

    def count(self) -> torch.Tensor:
        return torch.bincount(self.i, minlength=self.n)


# ---- one step -------------------------------------------------------------

def wall_volumes(pr: Pairs, mat: torch.Tensor, ph: Physics) -> torch.Tensor:
    """Akinci pseudo-volumes of the wall particles: 1 / (W(0) + sum over
    wall neighbours of W); every wall row is one object."""
    wall_pair = (mat[pr.i] == RIGID) & (mat[pr.j] == RIGID)
    s = pr.sum(torch.where(wall_pair, pr.W, torch.zeros_like(pr.W)))
    w0 = kernel_w(torch.zeros((), dtype=s.dtype, device=s.device), ph)
    return 1.0 / (w0 + s)


def density(pr: Pairs, V, mat, ph: Physics):
    w0 = kernel_w(torch.zeros((), dtype=V.dtype, device=V.device), ph)
    s = pr.sum(V[pr.j] * pr.W)
    return torch.where(mat == FLUID, ph.rho0 * (V * w0 + s),
                       torch.zeros_like(s))


def alpha(pr: Pairs, V, mat, ph: Physics):
    c = -V[pr.j] * pr.gw
    fj = (mat[pr.j] == FLUID).to(c.dtype)
    vec = pr.sum(c[:, None] * pr.R)
    sum_sq = pr.sum(fj * c * c * pr.d2)
    denom = sum_sq + (vec * vec).sum(1)
    a = torch.where(denom > 1e-5, 1.0 / torch.clamp_min(denom, 1e-30),
                    torch.zeros_like(denom))
    return torch.where(mat == FLUID, a, torch.zeros_like(a))


def divergence(pr: Pairs, vel, V, mat):
    """sum_j V_j (v_i - v_j) . grad W_ij, and the neighbour count."""
    dvR = ((vel[pr.i] - vel[pr.j]) * pr.R).sum(1)
    return pr.sum(V[pr.j] * dvR * pr.gw), pr.count()


def nonpressure(pr: Pairs, vel, V, m, rho, mat, ph: Physics):
    """Surface tension and standard viscosity (base_solver.py:202-278) on
    the fluid rows, as accelerations."""
    d2c = 2.0 * (ph.dim + 2)
    fj = mat[pr.j] == FLUID
    rj = mat[pr.j] == RIGID
    w_diam = kernel_w(torch.full((), ph.diameter, dtype=vel.dtype,
                                 device=vel.device), ph)
    wst = torch.where(pr.d2 > ph.diameter ** 2, pr.W, w_diam)
    zero = torch.zeros_like(pr.W)
    st = pr.sum(torch.where(fj, m[pr.j] * wst, zero)[:, None] * pr.R)
    inv_rho = 1.0 / torch.where(rho > 0, rho, torch.ones_like(rho))
    v_xy = ((vel[pr.i] - vel[pr.j]) * pr.R).sum(1)
    inv_denom = 1.0 / (pr.d2 + 0.01 * ph.h ** 2)
    m_ij = 0.5 * (m[pr.i] + m[pr.j])
    cf = d2c * ph.viscosity * m_ij * inv_rho[pr.j] * inv_denom * v_xy
    cb = d2c * ph.viscosity_b * ph.rho0 * V[pr.j] * inv_rho[pr.i] * \
        inv_denom * v_xy
    coef = (torch.where(fj, cf, zero) + torch.where(rj, cb, zero)) * pr.gw
    acc = pr.sum(coef[:, None] * pr.R)
    a = -ph.surface_tension / torch.clamp_min(m, 1e-12)[:, None] * st + \
        acc / ph.rho0
    return torch.where((mat == FLUID)[:, None], a, torch.zeros_like(a))


def correction(pr: Pairs, kappa, rho, V, mat, ph: Physics):
    """The velocity change of one corrector iteration from the stiffness
    kappa (DFSPH.py:260-294), walls mirrored."""
    eps = ph.eps * ph.dt
    k_rho = kappa / torch.clamp_min(rho, 1e-12)
    ki, kj = kappa[pr.i], kappa[pr.j]
    fj = (mat[pr.j] == FLUID) & (torch.abs(ki + kj) > eps)
    rj = (mat[pr.j] == RIGID) & (torch.abs(ki) > eps)
    zero = torch.zeros_like(pr.W)
    coef = (torch.where(fj, k_rho[pr.i] + k_rho[pr.j], zero) +
            torch.where(rj, k_rho[pr.i], zero)) * ph.rho0 * V[pr.j] * pr.gw
    dv = -pr.sum(coef[:, None] * pr.R)
    return torch.where((mat == FLUID)[:, None], dv, torch.zeros_like(dv))


def _inverse(m: torch.Tensor) -> torch.Tensor:
    """Inverses of (..., d, d) matrices, d = 2 or 3, as cofactors over the
    determinant, in the matrices' own dtype."""
    if m.shape[-1] == 2:
        det = m[..., 0, 0] * m[..., 1, 1] - m[..., 0, 1] * m[..., 1, 0]
        cof = torch.stack([torch.stack([m[..., 1, 1], -m[..., 0, 1]], -1),
                           torch.stack([-m[..., 1, 0], m[..., 0, 0]], -1)],
                          -2)
        return cof / det[..., None, None]
    cof = torch.empty_like(m)
    for r in range(3):
        for c in range(3):
            r1, r2 = (c + 1) % 3, (c + 2) % 3
            c1, c2 = (r + 1) % 3, (r + 2) % 3
            cof[..., r, c] = (m[..., r1, c1] * m[..., r2, c2]
                              - m[..., r1, c2] * m[..., r2, c1])
    det = (m[..., 0, :] * cof[..., :, 0]).sum(-1)
    return cof / det[..., None, None]


def implicit_viscosity(pr: Pairs, vel, V, m, rho, mat, ph: Physics):
    """Solve (I - dt/rho0 A) v* = b on the fluid rows by CG with the 3x3
    block-Jacobi preconditioner (Weiler et al. 2018), starting from v.
    Returns (v*, CG iterations)."""
    d2c = 2.0 * (ph.dim + 2)
    fluid = mat == FLUID
    fm = fluid[:, None]
    fj = mat[pr.j] == FLUID
    rj = mat[pr.j] == RIGID
    zero = torch.zeros_like(pr.W)
    dt_rho = ph.dt / ph.rho0
    inv_denom = 1.0 / (pr.d2 + 0.01 * ph.h ** 2)
    rho_safe = torch.where(rho > 0, rho, torch.ones_like(rho))
    m_ij = 0.5 * (m[pr.i] + m[pr.j])
    c_f = -d2c * ph.viscosity * m_ij / rho_safe[pr.j] * inv_denom
    c_b = -d2c * ph.viscosity_b * ph.rho0 * V[pr.j] / rho_safe[pr.i] * \
        inv_denom
    cg = (torch.where(fj, c_f, zero) + torch.where(rj, c_b, zero)) * pr.gw
    a_sum = pr.sum(cg[:, None, None] * pr.R[:, :, None] * pr.R[:, None, :])
    eye = torch.eye(ph.dim, dtype=vel.dtype, device=vel.device)
    dinv = torch.where(fm[..., None], _inverse(eye + dt_rho * a_sum), eye)
    v_dot_R = (vel[pr.j] * pr.R).sum(1)
    cb = -c_b * v_dot_R * pr.gw
    br = pr.sum(torch.where(rj, cb, zero)[:, None] * pr.R)
    b = torch.where(fm, vel - ph.dt * br / ph.rho0, torch.zeros_like(vel))
    c_fg = torch.where(fj, c_f * pr.gw, zero)

    def matvec(x):
        s = (pr.R * x[pr.j]).sum(1)
        acc = pr.sum((-c_fg * s)[:, None] * pr.R)
        out = x + dt_rho * (dinv @ acc[..., None])[..., 0]
        return torch.where(fm, out, torch.zeros_like(out))

    x = torch.where(fm, vel, torch.zeros_like(vel))
    r = torch.where(fm, (dinv @ b[..., None])[..., 0] - matvec(x),
                    torch.zeros_like(vel))
    d = r
    it = 0
    err = math.inf
    while err > ph.cg_tol and it < ph.cg_max_iter:
        ad = matvec(d)
        rr = (r * r).sum()
        dad = (d * ad).sum()
        a = rr / dad if float(dad) > 1e-18 else torch.zeros_like(rr)
        x = x + a * d
        r_new = r - a * ad
        rr_new = (r_new * r_new).sum()
        beta = rr_new / rr if float(rr) > 1e-18 else torch.zeros_like(rr)
        d = r_new + beta * d
        r = r_new
        it += 1
        err = math.sqrt(float(rr_new))
    return torch.where(fm, x, vel), it


def _avg_over_active(x: torch.Tensor, n_active: int) -> float:
    return float(x.sum()) / n_active


def step(start: dict, ph: Physics, dtype=torch.float64) -> dict:
    """:func:`step_rows` from a snapshot's ``pos``, ``vel`` and
    ``material``."""
    return step_rows(start["pos"], start["vel"], start["material"], ph, dtype)


def step_rows(pos, vel, mat, ph: Physics, dtype=torch.float64) -> dict:
    """One DFSPH step of the configuration from positions, velocities and
    materials (1 fluid, 2 wall, 0 empty row). Returns the fields at the
    step's end, in the input's row order (``pos``, ``vel``, ``density``,
    ``alpha``, ``rest_volume``, ``mass``, ``material``), and the iteration
    counts (``solver_iters``, ``div_iters``, ``cg_iters`` under implicit
    viscosity)."""
    x = pos.to(dtype)
    v = vel.to(dtype)
    fluid = mat == FLUID
    active = mat != 0
    n_active = int(active.sum())
    fm = fluid[:, None]
    pr = Pairs(x, active, ph)
    V = torch.where(mat == RIGID, wall_volumes(pr, mat, ph),
                    torch.full_like(x[:, 0], ph.v0))
    V = torch.where(active, V, torch.zeros_like(V))
    m = torch.where(fluid, ph.fluid_density * V, ph.rho0 * V)
    rho = density(pr, V, mat, ph)
    alp = alpha(pr, V, mat, ph)

    # non-pressure accelerations and the velocity update
    g = torch.tensor(ph.gravity, dtype=dtype, device=x.device)
    out = {}
    v_np = v
    if ph.viscosity_method == "implicit":
        v_np, out["cg_iters"] = implicit_viscosity(pr, v, V, m, rho, mat, ph)
    acc = g[None] + nonpressure(pr, v_np, V, m, rho, mat, ph)
    v = torch.where(fm, v + ph.dt * acc, v)

    # constant-density corrector
    def star_of(vel_):
        s, _ = divergence(pr, vel_, V, mat)
        st = torch.clamp_min(rho / ph.rho0 + ph.dt * s, 1.0)
        return torch.where(fluid, st, torch.zeros_like(st))

    fluid_one = fluid.to(dtype)
    star = star_of(v)
    it, err = 0, math.inf
    while it < 1 or (err > ph.max_error and it < ph.max_iter):
        kappa = (star - 1.0) * alp / ph.dt
        v = v + correction(pr, kappa, rho, V, mat, ph)
        star = star_of(v)
        err = _avg_over_active(star - fluid_one, n_active)
        it += 1
    out["solver_iters"] = it

    # speed cap, advection, the boundary clamp with reflection
    if ph.vel_cap_cfl > 0:
        cap = ph.vel_cap_cfl * ph.diameter / ph.dt
        sp2 = (v * v).sum(1, keepdim=True)
        scale = torch.where(sp2 > cap * cap,
                            cap / torch.sqrt(torch.clamp_min(sp2, 1e-30)),
                            torch.ones_like(sp2))
        v = torch.where(fm, v * scale, v)
    x = torch.where(fm, x + ph.dt * v, x)
    lo = torch.tensor(ph.domain_start, dtype=dtype, device=x.device) + \
        ph.padding
    hi = torch.tensor(ph.domain_end, dtype=dtype, device=x.device) - \
        ph.padding
    normal = (x > hi).to(dtype) - (x <= lo).to(dtype)
    nlen = torch.sqrt((normal * normal).sum(1))
    hit = fluid & (nlen > 1e-6)
    nu = normal / torch.clamp_min(nlen, 1e-12)[:, None]
    refl = v - 1.5 * (v * nu).sum(1, keepdim=True) * nu
    x = torch.where(fm, torch.minimum(torch.maximum(x, lo), hi), x)
    v = torch.where(hit[:, None], refl, v)

    # new neighbours, density and alpha there, divergence-free corrector
    pr = Pairs(x, active, ph)
    rho = density(pr, V, mat, ph)
    alp = alpha(pr, V, mat, ph)
    min_nbrs = 20 if ph.dim == 3 else 7

    def deriv_of(vel_):
        s, cnt = divergence(pr, vel_, V, mat)
        d = torch.clamp_min(s, 0.0)
        d = torch.where(cnt < min_nbrs, torch.zeros_like(d), d)
        return torch.where(fluid, d, torch.zeros_like(d))

    eta = ph.max_error_v * ph.rho0 / ph.dt
    deriv = deriv_of(v)
    it, err = 0, math.inf
    while it < 1 or (err > eta and it < ph.max_iter_v):
        v = v + correction(pr, deriv * alp, rho, V, mat, ph)
        deriv = deriv_of(v)
        err = _avg_over_active(ph.rho0 * deriv, n_active)
        it += 1
    out["div_iters"] = it
    out.update(pos=x, vel=v, density=rho, alpha=alp, rest_volume=V, mass=m,
               material=mat)
    return out

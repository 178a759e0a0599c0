"""The pair passes of the ported steps: plain bodies and the two CUDA kernels.

Each pass is a named body. Its plain version below is written against
``pairs.Cx`` as the JAX package writes it against ``ops/pair_exec.Cx`` (the
JAX source is named beside each body), and ``csrc/pair_bodies.cuh`` holds the
same body as a device functor, once for both engines, which also share their
candidate walk (``csrc/pair_walk.cuh``). :func:`run` picks the
engine from the environment's type, as ``pair_exec.run`` does on the JAX side:
a ``pairs.SlabEnv`` goes to the slab-window kernel (``csrc/pair_slab.cu``),
a ``pairs.PairEnv`` to the cell-list kernel (``csrc/pair_pass.cu``). CUDA
tensors launch the engine's kernel, CPU tensors evaluate the plain body with
the engine's plain executor; the CUDA path of neither engine ever gives way to
a plain version. Outputs are per row, zero on rows that do not produce; vector
outputs come back as (N, dim).

The bodies of the ported paths (DFSPH, WCSPH, PCISPH, IISPH, PBF):
standard and implicit viscosity, fluid, static walls and dynamic rigid
bodies under either rigid backend (``rigid_contact`` for the integrator's
impulses, ``rigid_dem`` for shape matching's DEM springs). A body that has
outputs for dynamic rigid bodies (the wrenches, the same-object kernel sum)
adds them under the flag :data:`RIGID`, after its other outputs;
``rigid_contact`` has one group of outputs per contact channel, so its
outputs depend on ``params.contact_channels``.

Every body follows ``params.kernel_type`` (the cubic spline, or PBF's poly6
W with the spiky gradient) and ``params.dim``, on the CPU and on the card:
a vector output has ``dim`` components, a torque three in 3D and one in 2D
(``common.pair_cross``). Each engine has one library per kind and dimension
(``_build.VARIANTS``).
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from ..core.params import (MATERIAL_FLUID, MATERIAL_NONE, MATERIAL_RIGID,
                           SimParams, make_params)
from . import _build
from . import graph_loop
from . import kernels
from . import neighbors
from . import pairs
from .pairs import PairEnv, SlabEnv, collect, run_plain, run_plain_slab


def _w(d2, params):
    return kernels.w_d2(d2, params.support_radius, params.dim,
                        params.kernel_type)


def _gw(d2, params):
    return kernels.gw_d2(d2, params.support_radius, params.dim,
                         params.kernel_type)


# flags: bit 0, the neighbour count (divergence, pbf_density); bit 1, the
# outputs of dynamic rigid bodies (wrenches, the same-object kernel sum)
COUNT = 1
RIGID = 2


def _w_diam(params) -> torch.Tensor:
    """W(particle diameter) computed in float32, as the JAX body does."""
    return kernels.W(torch.tensor(params.particle_diameter, dtype=torch.float32),
                     params.support_radius, params.dim, params.kernel_type)


# ---- plain bodies ----------------------------------------------------------

def density_body(cx, params, flags=0):
    """common.compute_density :261."""
    _, d2, mask = cx.geometry()
    return {"s": cx.sum(cx.slab("rest_volume") * _w(d2, params), mask)}


def alpha_body(cx, params, flags=0):
    """dfsph.compute_alpha :32."""
    R, d2, mask = cx.geometry()
    gw = _gw(d2, params)
    c = -cx.slab("rest_volume") * gw
    fluid_j = mask & (cx.slab("material") == MATERIAL_FLUID)
    out = {"sum_sq": cx.sum(c * c * d2, fluid_j)}
    for d in range(cx.dim):
        out[f"vec{d}"] = cx.sum(c * R[d], mask)
    return out


def _rigid_dyn_i(cx):
    return (cx.blk("material") == MATERIAL_RIGID) & (cx.blk("is_dynamic") > 0)


def nonpressure_body(cx, params, flags=0):
    """common._nonpressure_outputs :380 (surface tension + standard
    viscosity); ``flags & RIGID`` adds the viscosity force on dynamic rigid
    rows from their fluid neighbours, ``fpp``."""
    d2c = 2.0 * (params.dim + 2)
    diam = params.particle_diameter
    R, d2, mask = cx.geometry()
    gw = _gw(d2, params)
    mat_j = cx.slab("material")
    fluid_j = mask & (mat_j == MATERIAL_FLUID)
    rigid_j = mask & (mat_j == MATERIAL_RIGID)
    w_dm = _w_diam(params).to(d2.device)
    Wst = torch.where(d2 > diam * diam, _w(d2, params), w_dm)
    mW = cx.slab("mass") * Wst
    out = {f"st{d}": cx.sum(cx.where(fluid_j, mW * R[d], 0.0), fluid_j)
           for d in range(cx.dim)}
    vb, vs = cx.vec_blk("vel"), cx.vec_slab("vel")
    v_xy = sum((vb[d] - vs[d]) * R[d] for d in range(cx.dim))
    denom = d2 + 0.01 * params.support_radius ** 2
    inv_denom = 1.0 / denom
    inv_rho_j = cx.slab("inv_rho")
    m_ij = 0.5 * (cx.blk("mass") + cx.slab("mass"))
    coef_f = d2c * params.viscosity * m_ij * inv_rho_j * inv_denom * v_xy
    m_b = params.density0 * cx.slab("rest_volume")
    coef_b = d2c * params.viscosity_b * m_b * cx.blk("inv_rho") * \
        inv_denom * v_xy
    coef = (cx.where(fluid_j, coef_f, 0.0) +
            cx.where(rigid_j, coef_b, 0.0)) * gw
    for d in range(cx.dim):
        out[f"acc{d}"] = cx.sum(coef * R[d], mask)
    if flags & RIGID:
        pair_ok = fluid_j & _rigid_dyn_i(cx)
        c = d2c * params.viscosity_b * cx.blk("rest_volume") * \
            cx.slab("mass") * inv_rho_j * inv_denom * v_xy * gw
        c = cx.where(pair_ok, c, 0.0)
        for d in range(cx.dim):
            out[f"fpp{d}"] = cx.sum(c * R[d], pair_ok)
    return out


def divergence_body(cx, params, flags=0):
    """dfsph._divergence_sum :148; ``flags & 1`` adds the neighbour count."""
    R, d2, mask = cx.geometry()
    gw = _gw(d2, params)
    vb, vs = cx.vec_blk("vel"), cx.vec_slab("vel")
    dv_R = sum((vb[d] - vs[d]) * R[d] for d in range(cx.dim))
    contrib = cx.slab("rest_volume") * dv_R * gw
    out = {"s": cx.sum(contrib, mask)}
    if flags & 1:
        out["cnt"] = cx.sum(torch.ones_like(contrib), mask)
    return out


def correction_body(cx, params, flags=0, pre=""):
    """dfsph._correction_outputs :223; ``flags & RIGID`` adds the force on
    dynamic rigid rows from their fluid neighbours, ``fp``; ``pre`` prefixes
    the output names."""
    eps = params.dfsph_eps * params.dt
    R, d2, mask = cx.geometry()
    gw = _gw(d2, params)
    vgw = cx.slab("rest_volume") * gw
    mat_j = cx.slab("material")
    k_i, k_j = cx.blk("kappa"), cx.slab("kappa")
    kr_i, kr_j = cx.blk("k_rho"), cx.slab("k_rho")
    fluid_j = mask & (mat_j == MATERIAL_FLUID) & (torch.abs(k_i + k_j) > eps)
    rigid_j = mask & (mat_j == MATERIAL_RIGID) & (torch.abs(k_i) > eps)
    coef = (cx.where(fluid_j, kr_i + kr_j, 0.0) +
            cx.where(rigid_j, kr_i, 0.0)) * params.density0 * vgw
    out = {f"{pre}dv{d}": cx.sum(-coef * R[d], fluid_j | rigid_j)
           for d in range(cx.dim)}
    if flags & RIGID:
        pair_ok = mask & (mat_j == MATERIAL_FLUID) & _rigid_dyn_i(cx) & \
            (torch.abs(k_j) > eps)
        c = -cx.blk("rest_volume") * kr_j * params.density0 / params.dt * \
            (cx.slab("rest_volume") * params.density0) * gw
        c = cx.where(pair_ok, c, 0.0)
        for d in range(cx.dim):
            out[f"{pre}fp{d}"] = cx.sum(c * R[d], pair_ok)
    return out


def nonpressure_warm_body(cx, params, flags=0):
    """dfsph.nonpressure_warm_fused :306: the non-pressure sums and the
    warm-start correction (outputs ``wdv``) in one pass, and under ``flags &
    RIGID`` both wrenches, ``fpp`` and ``wfp``."""
    out = nonpressure_body(cx, params, flags)
    out.update(correction_body(cx, params, flags, pre="w"))
    return out


def density_alpha_divergence_body(cx, params, flags=0):
    """dfsph.density_alpha_divergence :90; ``flags & RIGID`` adds the
    same-object kernel sum of the rigid pseudo-volumes, ``svol``."""
    R, d2, mask = cx.geometry()
    W = _w(d2, params)
    vj = cx.slab("rest_volume")
    gw = _gw(d2, params)
    c = -vj * gw
    fluid_j = mask & (cx.slab("material") == MATERIAL_FLUID)
    vb, vs = cx.vec_blk("vel"), cx.vec_slab("vel")
    dv_R = sum((vb[d] - vs[d]) * R[d] for d in range(cx.dim))
    out = {"sd": cx.sum(vj * W, mask),
           "sum_sq": cx.sum(c * c * d2, fluid_j),
           "sv": cx.sum(vj * dv_R * gw, mask),
           "cnt": cx.sum(torch.ones_like(d2), mask)}
    for d in range(cx.dim):
        out[f"vec{d}"] = cx.sum(c * R[d], mask)
    if flags & RIGID:
        same = cx.slab("object_id") == cx.blk("object_id")
        out["svol"] = cx.sum(cx.where(same, W, 0.0), mask)
    return out


def rigid_volume_body(cx, params, flags=0):
    """The same-object kernel sum of common.compute_rigid_volume_fixedk :230
    (and compute_rigid_particle_volume :188)."""
    _, d2, mask = cx.geometry()
    same = cx.slab("object_id") == cx.blk("object_id")
    return {"s": cx.sum(cx.where(same, _w(d2, params), 0.0), mask)}


def pressure_body(cx, params, flags=0):
    """The kern of common.pressure_acceleration :503 (symmetric pressure
    acceleration); ``p_rho2`` = p / max(rho^2, 1e-12) per particle.
    ``flags & RIGID`` adds the force ``fpp`` and torque ``tpp`` on dynamic
    rigid rows from their fluid neighbours, the torque per pair, its arm
    the fluid particle's offset x_i - R - com_i (in 2D the scalar torque of
    ``pair_cross``)."""
    R, d2, mask = cx.geometry()
    gw = _gw(d2, params)
    mat_j = cx.slab("material")
    fluid_j = mask & (mat_j == MATERIAL_FLUID)
    rigid_j = mask & (mat_j == MATERIAL_RIGID)
    p_rho2_i = cx.blk("p_rho2")
    term_f = cx.slab("mass") * (p_rho2_i + cx.slab("p_rho2"))
    term_b = params.density0 * cx.slab("rest_volume") * p_rho2_i
    term = (cx.where(fluid_j, term_f, 0.0) +
            cx.where(rigid_j, term_b, 0.0)) * gw
    out = {f"acc{d}": cx.sum(-term * R[d], mask) for d in range(cx.dim)}
    if flags & RIGID:
        pair_ok = fluid_j & _rigid_dyn_i(cx)
        m_n = params.density0 * cx.slab("rest_volume")
        c = -(params.density0 * cx.blk("rest_volume")) * \
            cx.slab("p_rho2") * m_n * gw
        f = [cx.where(pair_ok, c * R[d], 0.0) for d in range(cx.dim)]
        arm = [cx.blk(f"pos{d}") - R[d] - cx.blk(f"com{d}")
               for d in range(cx.dim)]
        if cx.dim == 3:
            tq = (arm[1] * f[2] - arm[2] * f[1], arm[2] * f[0] - arm[0] * f[2],
                  arm[0] * f[1] - arm[1] * f[0])
        else:
            tq = (arm[0] * f[1] - arm[1] * f[0],)
        for d in range(cx.dim):
            out[f"fpp{d}"] = cx.sum(f[d], pair_ok)
        for d, t in enumerate(tq):
            out[f"tpp{d}"] = cx.sum(t, pair_ok)
    return out


def pcisph_density_pred_body(cx, params, flags=0):
    """pcisph._density_star_predicted :72: the pair mask from the sorted
    positions, W (the r-form, with its own q <= 1 cutoff) at the predicted
    distance; a non-fluid j keeps its position."""
    _, _, mask = cx.geometry()
    fluid_j = cx.slab("material") == MATERIAL_FLUID
    d2p = 0.0
    for d in range(cx.dim):
        pj = cx.where(fluid_j, cx.slab(f"pred{d}"), cx.slab(f"pos{d}"))
        rp = cx.blk(f"pred{d}") - pj
        d2p = d2p + rp * rp
    W = kernels.W(torch.sqrt(d2p), params.support_radius, params.dim,
                  params.kernel_type)
    return {"s": cx.sum(cx.slab("rest_volume") * W, mask)}


def iisph_dii_body(cx, params, flags=0):
    """iisph.compute_dii :30; ``inv_star2`` = 1 / max(rho*_prev^2, 1e-12)
    of row i."""
    R, d2, mask = cx.geometry()
    gw = _gw(d2, params)
    mat_j = cx.slab("material")
    rho0v = params.density0 * cx.slab("rest_volume")
    fluid_j = mask & (mat_j == MATERIAL_FLUID)
    rigid_j = mask & (mat_j == MATERIAL_RIGID)
    rho_j2 = torch.clamp_min(torch.square(cx.slab("density")), 1e-12)
    c = (cx.where(fluid_j, -rho0v / rho_j2, 0.0) +
         cx.where(rigid_j, -rho0v * cx.blk("inv_star2"), 0.0)) * gw
    return {f"dii{d}": cx.sum(c * R[d], mask) for d in range(cx.dim)}


def iisph_aii_body(cx, params, flags=0):
    """iisph.compute_aii :53 (before the dt^2 factor); ``dpi`` = rho0 V_i /
    max(rho_i^2, 1e-12)."""
    R, d2, mask = cx.geometry()
    gw = _gw(d2, params)
    rho0v_j = params.density0 * cx.slab("rest_volume")
    db = cx.vec_blk("dii")
    term = sum((db[d] - cx.blk("dpi") * gw * R[d]) * gw * R[d]
               for d in range(cx.dim))
    return {"s": cx.sum(rho0v_j * term, mask)}


def iisph_density_star_body(cx, params, flags=0):
    """iisph.compute_density_star :71 (before the dt factor); rho0 enters
    per pair."""
    R, d2, mask = cx.geometry()
    gw = _gw(d2, params)
    vb, vs = cx.vec_blk("vel"), cx.vec_slab("vel")
    dv_R = sum((vb[d] - vs[d]) * R[d] for d in range(cx.dim))
    contrib = params.density0 * cx.slab("rest_volume") * dv_R * gw
    return {"s": cx.sum(contrib, mask)}


def iisph_dij_pj_body(cx, params, flags=0):
    """dij_pj_op of iisph.refine :96."""
    R, d2, mask = cx.geometry()
    gw = _gw(d2, params)
    fluid_j = mask & (cx.slab("material") == MATERIAL_FLUID)
    rho_j2 = torch.clamp_min(torch.square(cx.slab("density")), 1e-12)
    rho0v = params.density0 * cx.slab("rest_volume")
    c = cx.where(fluid_j, -rho0v * cx.slab("pressure") / rho_j2, 0.0) * gw
    return {f"dp{d}": cx.sum(c * R[d], mask) for d in range(cx.dim)}


def iisph_sum_i_body(cx, params, flags=0):
    """sum_i_op of iisph.refine :111 (before the dt^2 factor): ``dij_pj`` is
    read as row i's and as neighbour j's."""
    R, d2, mask = cx.geometry()
    gw = _gw(d2, params)
    mat_j = cx.slab("material")
    fluid_j = mask & (mat_j == MATERIAL_FLUID)
    rigid_j = mask & (mat_j == MATERIAL_RIGID)
    rho0v_j = params.density0 * cx.slab("rest_volume")
    dijb = cx.vec_blk("dij_pj")
    diis = cx.vec_slab("dii")
    dps = cx.vec_slab("dij_pj")
    prs = cx.slab("pressure")
    t_f = 0.0
    for d in range(cx.dim):
        d_ji_pi = cx.blk("dpi") * gw * R[d] * cx.blk("pressure")
        inner = dijb[d] - diis[d] * prs - (dps[d] - d_ji_pi)
        t_f = t_f + inner * gw * R[d]
    t_b = sum(dijb[d] * gw * R[d] for d in range(cx.dim))
    contrib = cx.where(fluid_j, rho0v_j * t_f, 0.0) + \
        cx.where(rigid_j, rho0v_j * t_b, 0.0)
    return {"s": cx.sum(contrib, mask)}


def _visc_c_fluid(cx, d2, params):
    """The fluid-neighbour half of viscosity_cg ``cij`` :48, the coefficient
    of A_ij = c_ij gradW (x) R for fluid j; with 1 / (d2 + 0.01 h^2)."""
    d2c = 2.0 * (params.dim + 2)
    inv_denom = 1.0 / (d2 + 0.01 * params.support_radius ** 2)
    rho_j = cx.slab("density")
    rho_j = cx.where(rho_j > 0, rho_j, 1.0)
    m_ij = 0.5 * (cx.blk("mass") + cx.slab("mass"))
    return -d2c * params.viscosity * m_ij / rho_j * inv_denom, inv_denom


def visc_prep_body(cx, params, flags=0):
    """viscosity_cg ``prep_kern`` :71: the six sums of A_sum over fluid and
    rigid j (``Axx`` ... ``Azz``), then the rigid neighbours' velocity term
    of b over rigid j (``br``)."""
    d2c = 2.0 * (params.dim + 2)
    R, d2, mask = cx.geometry()
    gw = _gw(d2, params)
    mat_j = cx.slab("material")
    fluid_j = mask & (mat_j == MATERIAL_FLUID)
    rigid_j = mask & (mat_j == MATERIAL_RIGID)
    c_f, inv_denom = _visc_c_fluid(cx, d2, params)
    m_b = params.density0 * cx.slab("rest_volume")
    c_b = -d2c * params.viscosity_b * m_b * cx.blk("inv_rho") * inv_denom
    c = cx.where(fluid_j, c_f, 0.0) + cx.where(rigid_j, c_b, 0.0)
    cg = c * gw
    out = {}
    ax = "xyz"
    for a in range(cx.dim):
        for b in range(a, cx.dim):
            out[f"A{ax[a]}{ax[b]}"] = cx.sum(cg * R[a] * R[b], mask)
    vs = cx.vec_slab("vel")
    v_dot_R = sum(vs[d] * R[d] for d in range(cx.dim))
    cb = d2c * params.viscosity_b * params.density0 * \
        cx.slab("rest_volume") * cx.blk("inv_rho") * v_dot_R * inv_denom * gw
    cb = cx.where(rigid_j, cb, 0.0)
    for d in range(cx.dim):
        out[f"br{d}"] = cx.sum(cb * R[d], rigid_j)
    return out


def visc_matvec_body(cx, params, flags=0):
    """The CG matvec ``kern`` of viscosity_cg :110: sum over fluid j of
    -c_ij gw (R . x_j) R (``acc``); c_ij of a rigid j, which the sum leaves
    out, is not formed."""
    R, d2, mask = cx.geometry()
    gw = _gw(d2, params)
    fluid_j = mask & (cx.slab("material") == MATERIAL_FLUID)
    c, _ = _visc_c_fluid(cx, d2, params)
    xs = cx.vec_slab("x")
    s = sum(R[d] * xs[d] for d in range(cx.dim))
    contrib = cx.where(fluid_j, -c * gw * s, 0.0)
    return {f"acc{d}": cx.sum(contrib * R[d], fluid_j) for d in range(cx.dim)}


def rigid_contact_body(cx, params, flags=0):
    """integrator.rigid_contact_data :129: on a rigid row, per contact
    channel, the penetration-weighted sums over rigid neighbours of another
    object within one particle diameter: the weight ``cw_<tag>`` and the
    normal ``cn_<tag>``, pointing toward the row. ``chan`` is the channel of
    the neighbour's object (the object's index in ``contact_channels``, the
    last channel for static rigid objects, -1 for none)."""
    d0 = params.particle_diameter
    R, d2, mask = cx.geometry()
    dist = torch.sqrt(d2)
    touching = (cx.blk("material") == MATERIAL_RIGID) & \
        (cx.slab("material") == MATERIAL_RIGID) & \
        (cx.blk("object_id") != cx.slab("object_id")) & mask & (dist < d0)
    pen = cx.where(touching, d0 - dist, 0.0)
    inv_dist = 1.0 / torch.clamp_min(dist, 1e-9)
    chan = cx.slab("chan")
    out = {}
    for c, tag in enumerate(contact_tags(params)):
        sel = touching & (chan == c)
        out[f"cw_{tag}"] = cx.sum(pen, sel)
        for d in range(cx.dim):
            out[f"cn_{tag}{d}"] = cx.sum(pen * R[d] * inv_dist, sel)
    return out


def rigid_dem_body(cx, params, flags=0):
    """The kern of integrator.rigid_contact_wrench :64 (the shape-matching
    backend's DEM contact): on a rigid row, the spring-damper force ``f``
    from rigid neighbours of another object that touch (pen = d0 - |R| >
    0), max(k pen - c k dt vn, 0) / |R| R."""
    d0 = params.particle_diameter
    R, d2, mask = cx.geometry()
    dist = torch.sqrt(d2)
    rigid_pair = (cx.blk("material") == MATERIAL_RIGID) & \
        (cx.slab("material") == MATERIAL_RIGID) & \
        (cx.blk("object_id") != cx.slab("object_id")) & mask
    pen = d0 - dist
    touching = rigid_pair & (pen > 0.0)
    inv_dist = 1.0 / torch.clamp_min(dist, 1e-9)
    vb, vs = cx.vec_blk("vel"), cx.vec_slab("vel")
    vn = sum((vb[d] - vs[d]) * R[d] for d in range(cx.dim)) * inv_dist
    fmag = params.contact_stiffness * pen - params.contact_damping * \
        params.contact_stiffness * params.dt * vn
    fmag = cx.where(touching, torch.clamp_min(fmag, 0.0) * inv_dist, 0.0)
    return {f"f{d}": cx.sum(fmag * R[d], touching) for d in range(cx.dim)}


def _w_r(r, params):
    return kernels.W(r, params.support_radius, params.dim, params.kernel_type)


def _gw_r(r, params):
    return kernels.grad_W_coef(r, params.support_radius, params.dim,
                               params.kernel_type)


def pbf_density_body(cx, params, flags=0):
    """pbf.compute_density_moving :33: the kernel sum at the moved positions
    (``pos``); ``flags & COUNT`` adds the neighbour count."""
    _, d2, mask = cx.geometry()
    W = _w_r(torch.sqrt(d2), params)
    out = {"s": cx.sum(cx.slab("rest_volume") * W, mask)}
    if flags & COUNT:
        out["cnt"] = cx.sum(torch.ones_like(d2), mask)
    return out


def pbf_lambda_body(cx, params, flags=0):
    """pbf.compute_lambda :50: ``sum_sq`` and ``vec`` over fluid and rigid
    j, a rigid j weighted by row i's ``density`` (the iteration's)."""
    R, d2, mask = cx.geometry()
    gw = _gw_r(torch.sqrt(d2), params)
    mat_j = cx.slab("material")
    fluid_j = mask & (mat_j == MATERIAL_FLUID)
    rigid_j = mask & (mat_j == MATERIAL_RIGID)
    w_f = cx.slab("mass") / params.density0
    w_b = cx.slab("rest_volume") * cx.blk("density") / params.density0
    w = (cx.where(fluid_j, w_f, 0.0) + cx.where(rigid_j, w_b, 0.0)) * gw
    out = {"sum_sq": cx.sum(w * w * d2, fluid_j | rigid_j)}
    for d in range(cx.dim):
        out[f"vec{d}"] = cx.sum(w * R[d], fluid_j | rigid_j)
    return out


def pbf_wq(params) -> float:
    """max(W(delta_q h), 1e-30), the s_corr denominator, in float32 (the
    JAX body evaluates W(float32(delta_q h)) in float32)."""
    w_q = kernels.W(torch.tensor(params.pbf_corr_delta_q * params.support_radius,
                                 dtype=torch.float32),
                    params.support_radius, params.dim, params.kernel_type)
    return float(torch.clamp_min(w_q, 1e-30))


def pbf_fix_body(cx, params, flags=0):
    """pbf.fix_position :79 (before the 1 / rho0 factor): ``dx``, the sums of
    (lam_i + lam_j + s_corr) m_j gradW over fluid j and (2 lam_i + s_corr)
    V_j rho0 gradW over rigid j."""
    R, d2, mask = cx.geometry()
    dist = torch.sqrt(d2)
    gw = _gw_r(dist, params)
    ratio = _w_r(dist, params) / pbf_wq(params)
    r2 = ratio * ratio                       # ratio ** 4, as lax.integer_pow
    scorr = -params.pbf_corr_k * (r2 * r2)
    mat_j = cx.slab("material")
    fluid_j = mask & (mat_j == MATERIAL_FLUID)
    rigid_j = mask & (mat_j == MATERIAL_RIGID)
    lam_i = cx.blk("lam")
    coef = (cx.where(fluid_j, (lam_i + cx.slab("lam") + scorr) *
                     cx.slab("mass"), 0.0) +
            cx.where(rigid_j, (2.0 * lam_i + scorr) *
                     cx.slab("rest_volume") * params.density0, 0.0)) * gw
    return {f"dx{d}": cx.sum(coef * R[d], mask) for d in range(cx.dim)}


# one tag per dynamic body; with the static channel, 27 channels at the most
# (CONTACT_CHANNELS_MAX in csrc/pair_bodies.cuh)
_CHAN_TAGS = "abcdefghijklmnopqrstuvwxyz"


def contact_tags(params: SimParams) -> list:
    """Output-name tags of the contact channels (integrator._chan_tags :97):
    one letter per dynamic body, then ``st`` for all static geometry."""
    n = len(params.contact_channels)
    if n > len(_CHAN_TAGS):
        raise ValueError(f"{n} dynamic rigid bodies > {len(_CHAN_TAGS)} "
                         "contact channels")
    return list(_CHAN_TAGS[:n]) + ["st"]


# output component -> the least dimension that has it
_AXIS: Dict[str, int] = {}


def _vec(name):
    """The components name0..name2 of a vector output; a 2D launch has the
    first two."""
    comps = tuple(f"{name}{d}" for d in range(3))
    _AXIS.update({c: d + 1 for d, c in enumerate(comps)})
    return comps


def _torque(name):
    """The components of a torque output: three in 3D, one (the scalar of
    ``common.pair_cross``) in 2D."""
    comps = tuple(f"{name}{d}" for d in range(3))
    _AXIS.update({comps[1]: 3, comps[2]: 3})
    return comps


# the sums of A_ij of the implicit viscosity, a <= b: Axx, Axy, Axz, Ayy,
# Ayz, Azz in 3D; Axx, Axy, Ayy in 2D
_VISC_A = tuple(f"A{'xyz'[a]}{'xyz'[b]}" for a in range(3) for b in range(a, 3))
_AXIS.update({k: 1 + max("xyz".index(k[1]), "xyz".index(k[2]))
              for k in _VISC_A})


_NONPRESSURE_FIELDS = ("pos", "vel", "material", "mass", "rest_volume",
                       "inv_rho")

# name -> (body id in pair_bodies.cuh, plain body, output components, fields)
BODIES = {
    "density": (0, density_body, ("s",), ("pos", "rest_volume")),
    "alpha": (1, alpha_body, ("sum_sq",) + _vec("vec"),
              ("pos", "rest_volume", "material")),
    "nonpressure": (2, nonpressure_body, _vec("st") + _vec("acc"),
                    _NONPRESSURE_FIELDS),
    "divergence": (3, divergence_body, ("s", "cnt"),
                   ("pos", "vel", "rest_volume")),
    "correction": (4, correction_body, _vec("dv"),
                   ("pos", "material", "rest_volume", "kappa", "k_rho")),
    "density_alpha_divergence": (
        5, density_alpha_divergence_body,
        ("sd", "sum_sq", "sv", "cnt") + _vec("vec"),
        ("pos", "vel", "rest_volume", "material")),
    "rigid_volume": (6, rigid_volume_body, ("s",), ("pos", "object_id")),
    "nonpressure_warm": (7, nonpressure_warm_body,
                         _vec("st") + _vec("acc") + _vec("wdv"),
                         _NONPRESSURE_FIELDS + ("kappa", "k_rho")),
    "pressure": (8, pressure_body, _vec("acc"),
                 ("pos", "material", "mass", "rest_volume", "p_rho2")),
    "pcisph_density_pred": (9, pcisph_density_pred_body, ("s",),
                            ("pos", "pred", "material", "rest_volume")),
    "iisph_dii": (10, iisph_dii_body, _vec("dii"),
                  ("pos", "material", "density", "rest_volume", "inv_star2")),
    "iisph_aii": (11, iisph_aii_body, ("s",),
                  ("pos", "rest_volume", "dii", "dpi")),
    "iisph_density_star": (12, iisph_density_star_body, ("s",),
                           ("pos", "vel", "rest_volume")),
    "iisph_dij_pj": (13, iisph_dij_pj_body, _vec("dp"),
                     ("pos", "material", "density", "rest_volume",
                      "pressure")),
    "iisph_sum_i": (14, iisph_sum_i_body, ("s",),
                    ("pos", "material", "rest_volume", "dii", "pressure",
                     "dij_pj", "dpi")),
    # outputs per channel (contact_outputs); ``chan`` is a table per object
    "rigid_contact": (15, rigid_contact_body, (),
                      ("pos", "material", "object_id", "chan")),
    "visc_prep": (16, visc_prep_body, _VISC_A + _vec("br"),
                  ("pos", "vel", "material", "mass", "density", "rest_volume",
                   "inv_rho")),
    "visc_matvec": (17, visc_matvec_body, _vec("acc"),
                    ("pos", "x", "material", "mass", "density")),
    # PBF (the moved positions go in as ``pos``; ``density`` is the
    # iteration's, ``lam`` the iteration's lambda)
    "pbf_density": (18, pbf_density_body, ("s", "cnt"),
                    ("pos", "rest_volume")),
    "pbf_lambda": (19, pbf_lambda_body, ("sum_sq",) + _vec("vec"),
                   ("pos", "material", "mass", "rest_volume", "density")),
    "pbf_fix": (20, pbf_fix_body, _vec("dx"),
                ("pos", "material", "mass", "rest_volume", "lam")),
    # shape matching's DEM contact, on the dynamic rigid rows
    "rigid_dem": (21, rigid_dem_body, _vec("f"),
                  ("pos", "vel", "material", "object_id")),
}
KINDS = ("cubic", "poly6")
# name -> (outputs a body adds under flags & RIGID, after its others; the
#          fields they read besides the body's)
RIGID_OUTPUTS = {
    "nonpressure": (_vec("fpp"), ("is_dynamic",)),
    "correction": (_vec("fp"), ("is_dynamic",)),
    "density_alpha_divergence": (("svol",), ("object_id",)),
    "nonpressure_warm": (_vec("fpp") + _vec("wfp"), ("is_dynamic",)),
    "pressure": (_vec("fpp") + _torque("tpp"),
                 ("is_dynamic", "object_id", "com")),
}

# engine -> (source in csrc/, its C entry point)
ENGINES = {"pair_pass": "sph_pair_pass", "pair_slab": "sph_pair_slab"}
# rows per block the slab-window kernel takes (MAX_BLOCK in pair_slab.cu)
SLAB_MAX_BLOCK = 512


def launch_key(engine: str, name: str, flags: int = 0, kind: str = "cubic",
               dim: int = 3) -> str:
    """``<engine>/<body>``, with ``@poly6`` under PBF's kernels, ``@2d`` in
    2D and ``+rigid`` for a launch under :data:`RIGID`."""
    return (f"{engine}/{name}{'' if kind == 'cubic' else '@' + kind}"
            f"{'@2d' if dim == 2 else ''}{'+rigid' if flags & RIGID else ''}")


def params_key(engine: str, name: str, params: SimParams,
               flags: int = 0) -> str:
    """:func:`launch_key` of a launch under ``params``."""
    return launch_key(engine, name, flags, params.kernel_type, params.dim)


# kernel launches per engine, body, kind, dimension and variant (launch_key)
launches = {launch_key(engine, name, flags, kind, dim): 0
            for engine in ENGINES for name in BODIES for flags in (0, RIGID)
            if not flags or name in RIGID_OUTPUTS
            for kind in KINDS for dim in (3, 2)}
# a captured step's replays add theirs (ops/graph_loop.py)
graph_loop.register_counts(launches)


def engine_of(env: PairEnv) -> str:
    return "pair_slab" if isinstance(env, SlabEnv) else "pair_pass"


def contact_outputs(params: SimParams) -> tuple:
    """The outputs of ``rigid_contact``, channel by channel."""
    return tuple(k for tag in contact_tags(params)
                 for k in (f"cw_{tag}",) + _vec(f"cn_{tag}")
                 if _AXIS.get(k, 0) <= params.dim)


def out_names(name: str, params: SimParams, flags: int = 0) -> tuple:
    if name == "rigid_contact":
        return contact_outputs(params)
    names = BODIES[name][2]
    if name in ("divergence", "pbf_density") and not flags & COUNT:
        names = names[:1]
    if flags & RIGID:
        names = names + RIGID_OUTPUTS[name][0]
    return tuple(k for k in names if _AXIS.get(k, 0) <= params.dim)


def fields_of(name: str, flags: int = 0) -> tuple:
    """The fields body ``name`` reads under ``flags``."""
    if flags & RIGID:
        return BODIES[name][3] + RIGID_OUTPUTS[name][1]
    return BODIES[name][3]


def body_constants(name: str, params: SimParams) -> list:
    """Float constants of the CUDA body, folded in double on the host:
    c[0..3] from kernels.cubic_constants, then the body's own."""
    c = kernels.cubic_constants(params.support_radius, params.dim)
    if name in ("nonpressure", "nonpressure_warm"):
        d2c = 2.0 * (params.dim + 2)
        diam = params.particle_diameter
        c += [diam * diam, float(_w_diam(params)),
              0.01 * params.support_radius ** 2, d2c * params.viscosity,
              d2c * params.viscosity_b, params.density0]
    if name in ("correction", "nonpressure_warm"):
        c += [params.dfsph_eps * params.dt, params.density0, params.dt]
    if name in ("pressure", "iisph_dii", "iisph_aii", "iisph_density_star",
                "iisph_dij_pj", "iisph_sum_i"):
        c += [params.density0]
    if name == "rigid_contact":
        c += [params.particle_diameter]
    if name == "rigid_dem":
        c += [params.particle_diameter, params.contact_stiffness,
              params.contact_damping * params.contact_stiffness * params.dt]
    if name in ("visc_prep", "visc_matvec"):
        d2c = 2.0 * (params.dim + 2)
        c += [0.01 * params.support_radius ** 2, -d2c * params.viscosity,
              -d2c * params.viscosity_b, params.density0,
              d2c * params.viscosity_b * params.density0]
    if name == "pbf_lambda":
        c += [params.density0]
    if name == "pbf_fix":
        c += [params.density0, -params.pbf_corr_k, pbf_wq(params)]
    return c


# ---- CUDA ------------------------------------------------------------------

_PTR_FIELDS = ("pos", "vel", "cells", "cell_start", "produce", "material",
               "object_id", "is_dynamic", "rest_volume", "mass", "inv_rho",
               "kappa", "k_rho", "pressure", "density", "p_rho2", "dpi",
               "inv_star2", "pred", "dii", "dij_pj", "x", "com", "chan",
               "starts", "lens", "out")
# fields a body reads: (N, dim) vectors, i32 ids and flags, tables per object
# (read through a row's object id: (max_objects,), or (max_objects, dim) for
# a vector); every other one (N,) f32
_VECTORS = ("pos", "vel", "pred", "dii", "dij_pj", "x", "com")
_INTS = ("material", "object_id", "is_dynamic", "chan")
TABLES = ("chan", "com")
N_CONST = 16
N_KC = 6
# PairArgs.kind
KIND_IDS = {"cubic": 0, "poly6": 1}


class PairArgs(ctypes.Structure):
    """ctypes mirror of ``struct PairArgs`` in csrc/pair_bodies.cuh."""
    _fields_ = ([(k, ctypes.c_void_p) for k in _PTR_FIELDS]
                + [(k, ctypes.c_int)
                   for k in ("n", "gx", "gy", "gz", "flags", "block",
                             "n_chan")]
                + [("dh2", ctypes.c_float), ("c", ctypes.c_float * N_CONST),
                   ("lam", ctypes.c_void_p), ("dim", ctypes.c_int),
                   ("kind", ctypes.c_int), ("kc", ctypes.c_float * N_KC)])


def _lib(engine: str, kind: str, dim: int):
    fn = getattr(_build.load(engine, (kind, dim)), ENGINES[engine])
    fn.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def run_cuda(name: str, env: PairEnv, fields: Dict[str, torch.Tensor],
             params: SimParams, produce: torch.Tensor | None = None,
             flags: int = 0) -> Dict[str, torch.Tensor]:
    """Launch the pair kernel of ``env``'s engine for body ``name``; (N,)
    outputs per component."""
    body_id = BODIES[name][0]
    needs = fields_of(name, flags)
    names = out_names(name, params, flags)
    engine = engine_of(env)
    n = env.n
    dev = env.cells.device
    produce = env.produce if produce is None else produce
    kind, dim = params.kernel_type, params.dim
    if env.dim != dim:
        raise ValueError(f"pair kernel {name}: a {env.dim}D environment for "
                         f"{dim}D parameters")
    if engine == "pair_slab" and (not 0 < env.block <= SLAB_MAX_BLOCK
                                  or env.block % 32 or n % env.block):
        raise ValueError(
            f"pair kernel {name}: the slab-window kernel takes blocks of "
            f"32..{SLAB_MAX_BLOCK} rows, whole warps, that divide {n}, got "
            f"{env.block}")
    args = PairArgs()
    keep = []

    def ptr(key, t, dtype, shape):
        if t.device != dev or t.dtype != dtype or tuple(t.shape) != shape \
                or not t.is_contiguous():
            raise ValueError(
                f"pair kernel {name}: {key} must be a contiguous {dtype} "
                f"tensor of shape {shape} on {dev}, got {t.dtype} "
                f"{tuple(t.shape)} on {t.device}")
        keep.append(t)
        setattr(args, key, t.data_ptr())

    for key in needs:
        if key not in fields:
            raise ValueError(f"pair kernel {name}: missing field {key}")
        rows = params.max_objects if key in TABLES else n
        shape = (rows, dim) if key in _VECTORS else (rows,)
        ptr(key, fields[key],
            torch.int32 if key in _INTS else torch.float32, shape)
    ptr("cells", env.cells, torch.int32, (n,))
    if engine == "pair_slab":
        nseg = 9 if dim == 3 else 3
        ptr("starts", env.starts, torch.int32, (n // env.block, nseg))
        ptr("lens", env.lens, torch.int32, (n // env.block, nseg))
        args.block = env.block
    else:
        ptr("cell_start", env.cell_start, torch.int32, (params.num_cells + 1,))
    ptr("produce", produce, torch.bool, (n,))
    out = torch.empty((len(names), n), dtype=torch.float32, device=dev)
    ptr("out", out, torch.float32, (len(names), n))
    args.n = n
    args.gx, args.gy, args.gz = pairs.grid3(env.grid)
    args.dim, args.kind = dim, KIND_IDS[kind]
    args.flags = flags
    if name == "rigid_contact":
        args.n_chan = len(contact_tags(params))
    args.dh2 = env.dh2
    consts = body_constants(name, params)
    for k, v in enumerate(consts):
        args.c[k] = v
    for k, v in enumerate(kernels.kind_constants(params.support_radius, dim)):
        args.kc[k] = v
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib(engine, kind, dim)(body_id, ctypes.addressof(args), stream)
    if err != 0:
        raise RuntimeError(
            f"{engine} kernel {name}: launch failed, CUDA error {err}")
    launches[params_key(engine, name, params, flags)] += 1
    return {k: out[r] for r, k in enumerate(names)}


def run_plain_body(name: str, env: PairEnv, fields: Dict[str, torch.Tensor],
                   params: SimParams, produce: torch.Tensor | None = None,
                   flags: int = 0) -> Dict[str, torch.Tensor]:
    """The plain PyTorch version of body ``name`` under ``env``'s engine
    (any device). A per-object table is read per row, through the row's
    object id (-1 or 0 on rows of no object)."""
    body = BODIES[name][1]
    fk = {k: fields[k] for k in fields_of(name, flags)}
    for k in TABLES:
        if k in fk:
            obj = fields["object_id"]
            rows = fk[k][obj.clamp(0, params.max_objects - 1).long()]
            valid = (obj >= 0).view((-1,) + (1,) * (rows.dim() - 1))
            fk[k] = torch.where(valid, rows, -1 if k in _INTS else 0.0)
    executor = run_plain_slab if isinstance(env, SlabEnv) else run_plain
    return executor(lambda cx: body(cx, params, flags), env, fk,
                    out_names(name, params, flags), produce=produce)


# the dynamic bodies of pile_up_case and pile_up_case_2d, as contact channels
PILE_UP_CHANNELS = (0, 1)
PILE_UP_CHANNELS_2D = (0,)


def pile_up_case(pair_block: int = 256, seed: int = 0):
    """A synthetic sorted state that overfills any short neighbour list:
    ``(params, cells, produce, fields)`` on the CPU, fields as :func:`run`
    takes them, with the ``density`` that ``inv_rho`` and ``k_rho`` were made
    from beside them.

    A 12x12x12 lattice of spacing h/4 fills the 3x3x3 cells at the grid's
    origin corner, so its inner rows have about 250 neighbours and a row's
    run of candidates (three cells of 64) crosses several of the tiles either
    kernel stages; a few particles sit in the opposite corner cell, in an
    edge cell and alone among empty cells. A fifth of the rows are rigid, the
    rest fluid (the rows that produce), and the tail up to ``n_pad`` is
    ``MATERIAL_NONE`` rows with the sentinel cell id. The rows belong to
    three objects; rigid rows of objects 0 and 1 are dynamic bodies (with a
    body com each), those of object 2 static, so wrench and contact pairs
    number in the hundreds. Its ``com`` table holds a com per object, its
    ``chan`` table gives objects 0 and 1 the
    channels of ``contact_channels=PILE_UP_CHANNELS`` and object 2 the static
    one: run ``rigid_contact`` with those channels in the parameters."""
    h = 0.04
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, dtype=torch.float32)

    params = make_params(12 ** 3 + 66, particle_radius=h / 4, support_radius=h,
                         domain_end=(6 * h, 5 * h, 7 * h),
                         pair_block=pair_block, has_dynamic_rigid=False)
    gx, gy, gz = params.grid_num
    k = torch.arange(12, dtype=torch.float32)
    lattice = torch.stack(torch.meshgrid(k, k, k, indexing="ij"), -1)
    lattice = (lattice.reshape(-1, 3) + 0.5) * (h / 4)
    lattice = lattice + (rand(lattice.shape) - 0.5) * (0.1 * h / 4)
    far = torch.tensor([gx - 1.0, gy - 1.0, gz - 1.0]) * h   # corner cell
    edge = torch.tensor([gx - 1.0, 0.0, 3.0]) * h            # edge cell
    lone = torch.tensor([[3.5, 3.5, 1.5], [1.5, 3.5, 5.5]]) * h
    pos = torch.cat([lattice, far + rand(40, 3) * h, edge + rand(24, 3) * h,
                     lone])
    n_real = pos.shape[0]
    n = params.n_pad
    pos = torch.cat([pos, torch.zeros(n - n_real, 3)])
    material = torch.where(rand(n) < 0.2, MATERIAL_RIGID, MATERIAL_FLUID)
    material[n_real:] = MATERIAL_NONE
    material = material.to(torch.int32)
    density = 900.0 + 200.0 * rand(n)
    kappa = -50.0 + 250.0 * rand(n)
    fields = {"pos": pos, "vel": rand(n, 3) - 0.5, "material": material,
              "mass": params.v0 * params.density0 * (0.9 + 0.2 * rand(n)),
              "rest_volume": params.v0 * (0.9 + 0.2 * rand(n)),
              "density": density, "inv_rho": 1.0 / density,
              "object_id": (rand(n) * 3).to(torch.int32),
              "kappa": kappa, "k_rho": kappa / density}
    obj = fields["object_id"]
    fields["is_dynamic"] = ((material == MATERIAL_FLUID) | (obj < 2)).to(
        torch.int32)
    # the fields of the WCSPH, PCISPH and IISPH bodies
    pressure = 5000.0 * rand(n)
    fields.update(
        pressure=pressure, p_rho2=pressure / (density * density),
        dpi=params.density0 * fields["rest_volume"] / (density * density),
        inv_star2=1.0 / (density * density),
        pred=pos + (rand(n, 3) - 0.5) * (0.2 * h),
        dii=(rand(n, 3) - 0.5) * 0.02, dij_pj=(rand(n, 3) - 0.5) * 20.0,
        x=rand(n, 3) - 0.5, lam=(rand(n) - 0.5) * 2e-3)
    cells = neighbors.flat_cell_ids(pos, material != MATERIAL_NONE, params)
    perm = neighbors.sort_permutation(cells)
    fields = {k: v[perm].contiguous() for k, v in fields.items()}
    fields["chan"] = torch.full((params.max_objects,), -1, dtype=torch.int32)
    fields["chan"][:3] = torch.tensor([0, 1, 2], dtype=torch.int32)
    fields["com"] = torch.zeros(params.max_objects, 3)
    fields["com"][:2] = torch.tensor([[h, 2 * h, 1.5 * h], [2 * h, h, 2 * h]])
    return (params, cells[perm].contiguous(),
            fields["material"] == MATERIAL_FLUID, fields)


def pile_up_case_2d(pair_block: int = 256, seed: int = 0):
    """:func:`pile_up_case` in 2D under PBF's kernels (poly6): a 36x36
    lattice of spacing h/12 fills the 3x3 cells at the grid's origin corner,
    so its inner rows have about 450 neighbours and a row's run of
    candidates (three cells of 144) crosses several of the tiles either
    kernel stages; a few particles sit in the opposite corner cell, in an
    edge cell and alone. A fifth of the rows are rigid (object 0 dynamic,
    with a body com, object 1 static), the rest fluid; the tail up to
    ``n_pad`` is ``MATERIAL_NONE`` rows with the sentinel cell id. Returns
    ``(params, cells, produce, fields)`` on the CPU, with the fields of
    every body (the ``chan`` table gives object 0 the channel of
    ``contact_channels=(0,)`` and object 1 the static one)."""
    h = 1.0
    gen = torch.Generator().manual_seed(seed)

    def rand(*shape):
        return torch.rand(*shape, generator=gen, dtype=torch.float32)

    params = make_params(36 ** 2 + 40, dim=2, particle_radius=h / 24,
                         support_radius=h, domain_end=(6 * h, 7 * h),
                         pair_block=pair_block, kernel_type="poly6",
                         has_dynamic_rigid=True)
    gx, gy = params.grid_num
    k = torch.arange(36, dtype=torch.float32)
    lattice = torch.stack(torch.meshgrid(k, k, indexing="ij"), -1)
    lattice = (lattice.reshape(-1, 2) + 0.5) * (h / 12)
    lattice = lattice + (rand(lattice.shape) - 0.5) * (0.1 * h / 12)
    far = torch.tensor([gx - 1.0, gy - 1.0]) * h
    edge = torch.tensor([gx - 1.0, 3.0]) * h
    lone = torch.tensor([[3.5, 4.5], [1.5, 5.5]]) * h
    pos = torch.cat([lattice, far + rand(20, 2) * h, edge + rand(18, 2) * h,
                     lone])
    n_real = pos.shape[0]
    n = params.n_pad
    pos = torch.cat([pos, torch.zeros(n - n_real, 2)])
    material = torch.where(rand(n) < 0.2, MATERIAL_RIGID, MATERIAL_FLUID)
    material[n_real:] = MATERIAL_NONE
    material = material.to(torch.int32)
    density = 900.0 + 200.0 * rand(n)
    obj = (rand(n) * 2).to(torch.int32)
    fields = {"pos": pos, "vel": rand(n, 2) - 0.5, "material": material,
              "mass": params.v0 * params.density0 * (0.9 + 0.2 * rand(n)),
              "rest_volume": params.v0 * (0.9 + 0.2 * rand(n)),
              "density": density, "inv_rho": 1.0 / density,
              "object_id": obj, "lam": (rand(n) - 0.5) * 2e-3,
              "is_dynamic": ((material == MATERIAL_FLUID) | (obj < 1)).to(
                  torch.int32)}
    # the fields of the other bodies, as pile_up_case's
    kappa = -50.0 + 250.0 * rand(n)
    pressure = 5000.0 * rand(n)
    fields.update(
        kappa=kappa, k_rho=kappa / density, pressure=pressure,
        p_rho2=pressure / (density * density),
        dpi=params.density0 * fields["rest_volume"] / (density * density),
        inv_star2=1.0 / (density * density),
        pred=pos + (rand(n, 2) - 0.5) * (0.2 * h / 12),
        dii=(rand(n, 2) - 0.5) * 0.02, dij_pj=(rand(n, 2) - 0.5) * 20.0,
        x=rand(n, 2) - 0.5)
    cells = neighbors.flat_cell_ids(pos, material != MATERIAL_NONE, params)
    perm = neighbors.sort_permutation(cells)
    fields = {k: v[perm].contiguous() for k, v in fields.items()}
    fields["chan"] = torch.full((params.max_objects,), -1, dtype=torch.int32)
    fields["chan"][:2] = torch.tensor([0, 1], dtype=torch.int32)
    fields["com"] = torch.zeros(params.max_objects, 2)
    fields["com"][0] = torch.tensor([1.5 * h, 1.5 * h])
    return (params, cells[perm].contiguous(),
            fields["material"] == MATERIAL_FLUID, fields)


def run(name: str, env: PairEnv, fields: Dict[str, torch.Tensor],
        params: SimParams, produce: torch.Tensor | None = None,
        flags: int = 0) -> Dict[str, torch.Tensor]:
    """One pair pass under ``env``'s engine: its CUDA kernel for CUDA
    tensors, its plain version for CPU tensors. Returns per-row outputs,
    vectors merged to (N, dim). An environment that is not an engine's
    (``parallel/spatial.SpatialEnv``, of the spatial decomposition) runs
    the pass itself, through its ``run``: on its halo-extended rows, as the
    JAX package's ``pair_exec.run`` routes one (:301-303)."""
    if not isinstance(env, PairEnv):
        return env.run(name, fields, params, produce, flags)
    kind = env.cells.device.type
    if kind == "cuda":
        out = run_cuda(name, env, fields, params, produce, flags)
    elif kind == "cpu":
        out = run_plain_body(name, env, fields, params, produce, flags)
    else:
        raise ValueError(f"unsupported device {env.cells.device}")
    return collect(out)

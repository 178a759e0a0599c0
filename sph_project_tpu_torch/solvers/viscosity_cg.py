"""Implicit viscosity: matrix-free block-Jacobi-preconditioned CG.

The JAX package's ``solvers/viscosity_cg.py`` (line numbers name it), after
Weiler et al. 2018: solve (I - dt/rho0 A) v = b with the rows of A built per
pair as c_ij gradW (x) R, then evaluate the standard viscosity at the
solution. Its two pair passes are bodies of ``ops.pair_kernels``:
``visc_prep`` (the row sums of A and the rigid neighbours' term of b, once
per solve) and ``visc_matvec`` (once per CG iteration); both produce on the
fluid rows only, the only rows whose results the solve keeps (:100-104,
:123).

The CG is an ``ops.graph_loop.while_loop``, as the JAX one is a
``lax.while_loop``: a WHILE node of the captured step on the card, a host
loop reading its flag once an iteration elsewhere. The per-row inverse (3x3, or 2x2 in 2D) is written out as
cofactors over the determinant and every small matrix product as sums of
products, so no matrix product (and no TF32) touches the solve.
"""
from __future__ import annotations

import torch

from ..core.params import MATERIAL_FLUID, SimParams
from ..core.state import ParticleState, RigidState, SimState
from ..ops import graph_loop
from ..ops import pair_kernels
from ..ops.pairs import PairEnv
from . import common

# the last solve's CG iterations (int32), final residual norm (float32) and
# largest |visc_x|, 0-dim tensors on the solve's device (under a captured
# step, the graph's: each replay updates them); not a diagnostic of the
# step, which keeps the JAX package's keys
last_solve: dict = {}


def inverse3(m: torch.Tensor) -> torch.Tensor:
    """Inverses of (..., 3, 3) matrices: cofactors over the determinant,
    elementwise."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    c00 = m11 * m22 - m12 * m21
    c01 = m12 * m20 - m10 * m22
    c02 = m10 * m21 - m11 * m20
    det = m00 * c00 + m01 * c01 + m02 * c02
    rows = ((c00, m02 * m21 - m01 * m22, m01 * m12 - m02 * m11),
            (c01, m00 * m22 - m02 * m20, m02 * m10 - m00 * m12),
            (c02, m01 * m20 - m00 * m21, m00 * m11 - m01 * m10))
    return torch.stack([torch.stack([c / det for c in r], -1) for r in rows],
                       -2)


def inverse2(m: torch.Tensor) -> torch.Tensor:
    """Inverses of (..., 2, 2) matrices: cofactors over the determinant,
    elementwise."""
    m00, m01 = m[..., 0, 0], m[..., 0, 1]
    m10, m11 = m[..., 1, 0], m[..., 1, 1]
    det = m00 * m11 - m01 * m10
    rows = ((m11, -m01), (-m10, m00))
    return torch.stack([torch.stack([c / det for c in r], -1) for r in rows],
                       -2)


def implicit_viscosity_solve(p: ParticleState, rigid: RigidState,
                             state: SimState, env: PairEnv,
                             params: SimParams):
    """Solve (I - dt/rho0 A) v_new = b on the fluid rows (:36), then add the
    surface tension and the standard viscosity at the solution to ``p.acc``
    and their wrench to the bodies, in one ``nonpressure`` pass at v_new:
    surface tension does not depend on velocity. Returns (p, rigid, state
    with the new ``visc_x``)."""
    dev = p.pos.device
    dim = params.dim
    fluid = p.material == MATERIAL_FLUID
    fmask = fluid[:, None]
    dt_rho = params.dt / params.density0
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    fields = {"pos": p.pos, "vel": p.vel, "material": p.material,
              "mass": p.mass, "density": p.density,
              "rest_volume": p.rest_volume, "inv_rho": common._inv_rho(p)}

    # the preconditioner D_i and the rhs b in one pass (:95-105)
    prep = pair_kernels.run("visc_prep", env, fields, params, produce=fluid)
    a = [[None] * dim for _ in range(dim)]
    ax = "xyz"
    for i in range(dim):
        for j in range(i, dim):
            a[i][j] = a[j][i] = prep[f"A{ax[i]}{ax[j]}"]
    a_sum = torch.stack([torch.stack(r, -1) for r in a], -2)
    eye = torch.eye(dim, dtype=torch.float32, device=dev)[None]
    inverse = inverse3 if dim == 3 else inverse2
    dinv = torch.where(fmask[..., None], inverse(eye + dt_rho * a_sum), eye)
    b = torch.where(fmask, p.vel - params.dt * prep["br"] / params.density0,
                    zero)
    mv_fields = {k: fields[k] for k in pair_kernels.fields_of("visc_matvec")
                 if k != "x"}

    def matvec(x):
        """(Ax)_i = x_i + dt/rho0 Dinv_i sum over fluid j of (-A_ij) x_j
        (:107-124)."""
        acc = pair_kernels.run("visc_matvec", env, dict(mv_fields, x=x),
                               params, produce=fluid)["acc"]
        return torch.where(fmask, x + dt_rho * common.matvec(dinv, acc), zero)

    # CG (:126-147): err starts at +inf, so the first test passes
    x = torch.where(fmask, state.visc_x + p.vel, zero)
    r = torch.where(fmask, common.matvec(dinv, b) - matvec(x), zero)

    def cond(c):
        _, _, _, itr, err = c
        return (err > params.cg_tol) & (itr < params.cg_max_iter)

    def body(c):
        x, r, pdir, itr, _ = c
        ap = matvec(pdir)
        rr = common.global_sum(r * r, params)
        pap = common.global_sum(pdir * ap, params)
        alpha = torch.where(pap > 1e-18, rr / pap, zero)
        x = x + alpha * pdir
        r_new = r - alpha * ap
        rr_new = common.global_sum(r_new * r_new, params)
        beta = torch.where(rr > 1e-18, rr_new / rr, zero)
        pdir = r_new + beta * pdir
        return x, r_new, pdir, itr + 1, torch.sqrt(rr_new)

    x, _, _, itr, err = graph_loop.while_loop(
        cond, body, (x, r, r, *common.loop_start(0, dev)))

    # the standard viscosity at the solution (:149-155), with the surface
    # tension and, with dynamic bodies, the viscosity wrench
    v_sol = torch.where(fmask, x, p.vel)
    a_np, rf, rt = common.nonpressure_fused(p.replace(vel=v_sol), rigid, env,
                                            params)
    p = p.replace(acc=p.acc + a_np)
    rigid = rigid.replace(force=rigid.force + rf, torque=rigid.torque + rt)
    visc_x = torch.where(fmask, x - p.vel, zero)
    last_solve.update(cg_iters=itr, cg_err=err,
                      visc_x_max=common.global_max(torch.abs(visc_x), params))
    return p, rigid, state.replace(visc_x=visc_x)

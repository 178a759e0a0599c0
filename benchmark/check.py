"""What decides ``correct``: the step the window replays, held to the plain
reference, and the per-step gates.

:func:`compare` takes the state a program (or the control) produced from a
segment's start state, and the reference's step from that same start. The
rows are matched by position (the nearest reference particle within half a
particle diameter), which recovers the permutation the program's sort
applied; then it counts

- ``match_breaks``: rows of either side left without a partner, taken
  twice, or of another material;
- ``order_breaks``: rows out of order by grid cell (the cell of the row's
  position, binned in float32 as the program's grid defines it), or, within
  a cell, out of the order the rows had before the sort (a stable sort);

and measures the widest gaps of the fluid rows: position (in particle
diameters), velocity (against the reference's largest speed), density
(against the rest density), alpha (against its largest value), and the
carried volumes and masses of every row; and the iteration counts against
the reference's. A field or a count that the cell's reference does not
return (``alpha`` and the correctors' counts are DFSPH's, ``cg_iters`` the
implicit viscosity's) is not compared.

Where the reference returns each row's ``object_id`` and its ``bodies``
(``{object id: {"com", "rot", "vel", "omega"}}``, the present dynamic
bodies) and the program's held state has them too, it also counts and
measures the bodies:

- ``object_breaks``: matched rows whose object ids differ, and bodies
  present on one side only;
- ``rigid_pos_gap``: the widest position gap of the rows of the reference's
  bodies, in particle diameters;
- ``body_pos_gap``: the widest gap of a centre of mass, in diameters;
- ``body_rot_gap``: the largest angle of R_prog^T R_ref, in radians;
- ``body_vel_gap``: the widest gap of a body's velocity, against the
  largest fluid speed that ``vel_gap`` takes;
- ``body_omega_gap``: the widest gap of an angular velocity times the
  body's largest row distance from its centre, against that same speed.

A reference that returns no bodies yields none of these, so a limit that
names one fails.
"""
from __future__ import annotations

import math

import torch

from reference.sph import FLUID, RIGID, Physics, close_pairs

# iteration counts compared where the reference returns them
ITERS = ("solver_iters", "div_iters")

NONE = 0


def cell_ids(pos: torch.Tensor, active: torch.Tensor,
             ph: Physics) -> torch.Tensor:
    """Flat cell id per row as the program's grid bins it: floor((x -
    start) / h) in float32, clamped, x-major and z-fastest; empty rows get
    the number of cells."""
    f32 = torch.float32
    start = torch.tensor(ph.domain_start, dtype=f32, device=pos.device)
    q = (pos.to(f32) - start) / torch.tensor(ph.h, dtype=f32,
                                              device=pos.device)
    c = torch.floor(q).to(torch.int64)
    g = torch.tensor(ph.grid_num, device=pos.device)
    c = torch.minimum(torch.clamp_min(c, 0), g - 1)
    flat = c[:, 0]
    for d in range(1, c.shape[1]):
        flat = flat * ph.grid_num[d] + c[:, d]
    n_cells = math.prod(ph.grid_num)
    return torch.where(active, flat, torch.full_like(flat, n_cells))


def sort_rows(out: dict, ph: Physics) -> dict:
    """The fields of ``out`` in the order of a stable sort by grid cell
    (for a control, whose rows come in the start state's order)."""
    perm = torch.sort(cell_ids(out["pos"], out["material"] != NONE, ph),
                      stable=True).indices
    return {k: (v[perm] if torch.is_tensor(v) and v.dim() > 0 else v)
            for k, v in out.items()}


def match(prog_pos, prog_act, ref_pos, ref_act, radius):
    """For every active program row, the index of the nearest active
    reference row within ``radius`` (-1 if none)."""
    pi = torch.nonzero(prog_act).flatten()
    ri = torch.nonzero(ref_act).flatten()
    q, p, d2 = close_pairs(prog_pos[pi].double(), ref_pos[ri].double(),
                           radius, same=False)
    best = torch.full((prog_pos.shape[0],), -1, dtype=torch.long,
                      device=prog_pos.device)
    if q.numel():
        # the nearest: sort by distance, keep the first per query
        o = torch.argsort(d2, stable=True)
        q, p, d2 = q[o], p[o], d2[o]
        o = torch.sort(q, stable=True).indices
        q, p, d2 = q[o], p[o], d2[o]
        first = torch.ones_like(q, dtype=torch.bool)
        first[1:] = q[1:] != q[:-1]
        best[pi[q[first]]] = ri[p[first]]
    return best


def _gap(a, b, rows, scale) -> float:
    if rows.numel() == 0:
        return 0.0
    d = (a[rows].double() - b.double()).abs()
    if d.dim() > 1:
        d = torch.sqrt((d * d).sum(1))
    g = float(d.max())
    return g / scale if math.isfinite(g) else math.inf


def compare(out: dict, ref: dict, ph: Physics) -> dict:
    """The numbers that decide ``correct`` for one step: ``out`` holds the
    program's fields at the step's end in its own row order and its
    iteration counts; ``ref`` the reference's in the start state's order."""
    act_o = out["material"] != NONE
    act_r = ref["material"] != NONE
    best = match(out["pos"], act_o, ref["pos"], act_r, 0.5 * ph.diameter)
    rows = torch.nonzero(act_o).flatten()
    b = best[rows]
    found = b >= 0
    taken = torch.bincount(b[found], minlength=ref["pos"].shape[0])
    wrong_mat = out["material"][rows][found] != ref["material"][b[found]]
    match_breaks = (int((~found).sum()) + int((taken > 1).sum())
                    + int(wrong_mat.sum())
                    + abs(int(act_o.sum()) - int(act_r.sum())))

    cells = cell_ids(out["pos"], act_o, ph)
    down = cells[1:] < cells[:-1]
    tie = (cells[1:] == cells[:-1]) & act_o[1:] & (best[1:] <= best[:-1])
    order_breaks = int(down.sum()) + int(tie.sum())

    ok = rows[found]
    src_ok = best[ok]
    fluid = ok[out["material"][ok] == FLUID]
    src_f = best[fluid]
    vmax = float(torch.sqrt((ref["vel"][src_f].double() ** 2).sum(1)).max()) \
        if src_f.numel() else 1.0
    vol_scale = float(ref["rest_volume"][src_ok].abs().max()) \
        if src_ok.numel() else 1.0
    nums = dict(
        match_breaks=match_breaks,
        order_breaks=order_breaks,
        pos_gap=_gap(out["pos"], ref["pos"][src_f], fluid, ph.diameter),
        vel_gap=_gap(out["vel"], ref["vel"][src_f], fluid, max(vmax, 1e-12)),
        rho_gap=_gap(out["density"], ref["density"][src_f], fluid, ph.rho0),
        volume_gap=max(
            _gap(out["rest_volume"], ref["rest_volume"][src_ok], ok,
                 vol_scale),
            _gap(out["mass"], ref["mass"][src_ok], ok, ph.rho0 * vol_scale)),
        iters_gap=sum(abs(out[k] - ref[k]) for k in ITERS if k in ref),
    )
    if "alpha" in ref:
        amax = float(ref["alpha"][src_f].abs().max()) if src_f.numel() \
            else 1.0
        nums["alpha_gap"] = _gap(out["alpha"], ref["alpha"][src_f], fluid,
                                 max(amax, 1e-30))
    if "cg_iters" in ref:
        nums["cg_gap"] = abs(out["cg_iters"] - ref["cg_iters"])
    if "bodies" in ref and "bodies" in out:
        nums.update(body_numbers(out, ref, ok, src_ok, ph, max(vmax, 1e-12)))
    return nums


def rotation_angle(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The angle of the rotation a^T b, for (..., d, d) rotations, d = 2 or
    3, from its sine and cosine (steady at small angles)."""
    m = a.transpose(-1, -2).double() @ b.double()
    if m.shape[-1] == 2:
        return torch.atan2(m[..., 1, 0] - m[..., 0, 1],
                           m[..., 0, 0] + m[..., 1, 1]).abs()
    axial = torch.stack([m[..., 2, 1] - m[..., 1, 2],
                         m[..., 0, 2] - m[..., 2, 0],
                         m[..., 1, 0] - m[..., 0, 1]], -1)
    sin = 0.5 * torch.sqrt((axial * axial).sum(-1))
    cos = 0.5 * (m.diagonal(dim1=-2, dim2=-1).sum(-1) - 1.0)
    return torch.atan2(sin, cos)


def _widest(gaps: list, scale: float) -> float:
    if not all(math.isfinite(g) for g in gaps):
        return math.inf
    return max(gaps, default=0.0) / scale


def body_numbers(out: dict, ref: dict, ok, src_ok, ph: Physics,
                 speed: float) -> dict:
    """The body numbers of :func:`compare` (module docstring): ``ok`` the
    matched program rows, ``src_ok`` their reference rows."""
    rb, ob = ref["bodies"], out["bodies"]
    obj_o, obj_r = out["object_id"][ok], ref["object_id"][src_ok]
    breaks = int((obj_o != obj_r).sum()) + len(set(rb) ^ set(ob))
    ids = torch.tensor(sorted(rb), dtype=obj_r.dtype, device=obj_r.device)
    in_body = torch.isin(obj_r, ids) & \
        (ref["material"][src_ok] == RIGID)
    rows = ok[in_body]
    common = sorted(set(rb) & set(ob))

    def norm(k, i):
        d = ob[i][k].double().flatten() - rb[i][k].double().flatten()
        return float(torch.sqrt((d * d).sum()))

    reach = []
    act = ref["material"] != NONE
    for i in common:
        sel = act & (ref["object_id"] == i)
        d = ref["pos"][sel].double() - rb[i]["com"].double()
        reach.append(float(torch.sqrt((d * d).sum(1)).max())
                     if d.shape[0] else 0.0)
    return dict(
        object_breaks=breaks,
        rigid_pos_gap=_gap(out["pos"], ref["pos"][src_ok[in_body]], rows,
                           ph.diameter),
        body_pos_gap=_widest([norm("com", i) for i in common], ph.diameter),
        body_rot_gap=_widest([float(rotation_angle(ob[i]["rot"],
                                                   rb[i]["rot"]))
                              for i in common], 1.0),
        body_vel_gap=_widest([norm("vel", i) for i in common], speed),
        body_omega_gap=_widest([norm("omega", i) * r
                                for i, r in zip(common, reach)], speed),
    )


def gate_failures(vals: dict, gates: dict, fluid0: float) -> int:
    """1 if a step's diagnostics break a gate, else 0: a value not finite,
    the average fluid density outside its band, an overflow, a corrector
    that ran to its iteration cap, or a fluid count that changed."""
    keys = ("density_avg", "density_max", "vel_max")
    if not all(math.isfinite(vals[k]) for k in keys):
        return 1
    lo, hi = gates["density_avg_band"]
    rho0 = gates["rho0"]
    if not lo * rho0 <= vals["density_avg"] <= hi * rho0:
        return 1
    if vals["neighbor_overflow"] or vals["sort_overflow"]:
        return 1
    if vals["solver_iters"] >= gates["max_iter"] or \
            vals.get("div_iters", 0) >= gates["max_iter_v"]:
        return 1
    return int(vals["fluid_num"] != fluid0)

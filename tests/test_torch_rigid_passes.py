"""The port's pair passes with dynamic rigid bodies against the JAX package's.

A small coupled state: tests/test_rigid.py's layout (a dynamic cube of 0.1 in
a fluid block, no walls) plus a second dynamic cube pressed against the first
and a static cube against its other side, so that wrench pairs (a dynamic
rigid row and a fluid neighbour) number in the hundreds and contact pairs
of both kinds of channel in the tens. The JAX package prepares (sorts) it; the bridge
carries it to the port row for row; the port sorts it by its own cell ids.
Velocities, stiffnesses and pressures are made from a seed with numpy. Under
both of the port's engines (cell-list, slab-window), against the JAX pass
through its CPU executor (``pair_exec._exec_jax``):

- every variant with dynamic-rigid outputs: the viscosity wrench of the
  non-pressure pass, the correction's wrench, both wrenches of the fused
  warm pass, the pressure force and its per-pair torque, the same-object sum
  of the rigid pseudo-volumes in the density/alpha/divergence pass;
- the contact pass (``rigid_contact``), channel by channel;
- the per-step rigid volume after one step of rigid motion, on the
  environment sorted before the motion (the stale env of the feed-forward
  methods' step end);
- the momentum balance of tests/test_rigid.py on the port itself.

Tolerances: per-row sums max|a - b| <= 2e-5 * max(1, max|b|), as
tests/test_torch_pairs.py; a per-object force or torque within 1e-5 of the
sum of |per-particle terms| of that object (both sides reduce in their own
order: the JAX package's one-hot products reassociate).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_project_tpu.ops.pairs import slab_pack
from sph_project_tpu.rigid import integrator as jint
from sph_project_tpu.solvers import common as jcommon
from sph_project_tpu.solvers import dfsph as jdfsph

from sph_project_tpu_torch.ops import pair_kernels
from sph_project_tpu_torch.ops import pairs as tpairs
from sph_project_tpu_torch.rigid import integrator as tint
from sph_project_tpu_torch.solvers import common as tcommon
from sph_project_tpu_torch.solvers import dfsph as tdfsph

from test_rigid import base_cfg, fluid_block, rigid_body, write_cube_obj
from test_torch_pairs import Setup, assert_pass_close

WRENCH_TOL = 1e-5


def coupled_config(cube: str) -> dict:
    return {"Configuration": base_cfg("dfsph"),
            "RigidBodies": [
                rigid_body(0, cube, (0.3, 0.22, 0.3)),
                rigid_body(2, cube, (0.395, 0.22, 0.3)),
                rigid_body(3, cube, (0.205, 0.22, 0.3), dynamic=False)],
            "FluidBlocks": [fluid_block(1, (0.2, 0.05, 0.2), (0.4, 0.2, 0.4))]}


class RigidSetup(Setup):
    def __init__(self, cube, engine):
        super().__init__(coupled_config(cube), engine=engine)
        assert self.params.has_dynamic_rigid
        assert self.params.contact_channels == (0, 2)
        tp = self.tp
        self.dyn = (tcommon.rigid_dyn(tp) & (tp.object_id >= 0)).numpy()
        n = self.params.n_pad
        rng = np.random.default_rng(3)
        fluid = np.asarray(self.jp.material) == 1
        self.pr = np.where(fluid, rng.uniform(0.0, 3000.0, n),
                           0.0).astype(np.float32)

    def per_object(self, rows):
        """The sums of |per-particle terms| per object and component, of a
        per-row force (and of its torque about the body's com)."""
        p, params = self.tp, self.params
        rows = torch.as_tensor(rows)
        t = tcommon.cross(
            p.pos - self.trigid.com[tcommon.object_index(p, params)], rows)
        sel = tcommon.rigid_dyn(p) & (p.object_id >= 0)
        out = tcommon.object_reduce({"f": rows.abs(), "t": t.abs()},
                                    tcommon.object_index(p, params),
                                    params.max_objects, sel=sel)
        return out["f"].numpy(), out["t"].numpy()


@pytest.fixture(scope="module")
def cube_obj(tmp_path_factory):
    return write_cube_obj(str(tmp_path_factory.mktemp("mesh") / "cube.obj"))


@pytest.fixture(scope="module", params=["pallas_dma", "pallas"],
                ids=["cell_list", "slab_window"])
def box(request, cube_obj):
    return RigidSetup(cube_obj, request.param)


def assert_wrench_close(t, j, scale, what):
    """Per object and component, within WRENCH_TOL of the sum of |terms|."""
    t, j = np.asarray(t, np.float64), np.asarray(j, np.float64)
    err = np.abs(t - j)
    lim = WRENCH_TOL * scale + 1e-12
    assert (err <= lim).all(), f"{what}: max err {err.max()} (limit " \
        f"{lim[np.unravel_index(np.argmax(err - lim), err.shape)]})"
    assert np.abs(j).max() > 0, f"{what}: zero wrench"


def test_state_has_wrench_and_contact_pairs(box):
    """Hundreds of wrench pairs, and tens of contact pairs with each other
    body (a face of 5 x 5 particles against the next)."""
    p, params = box.tp, box.params
    env = tpairs.make_pair_env(box.tenv.cells, box.tenv.produce, params)

    def count(select):
        def body(cx):
            _, d2, mask = cx.geometry()
            return {"n": cx.sum(torch.ones_like(d2), mask & select(cx, d2))}
        return int(tpairs.run_plain(
            body, env, {"pos": p.pos, "material": p.material,
                        "object_id": p.object_id}, ("n",),
            produce=torch.from_numpy(box.dyn))["n"].sum())

    assert count(lambda cx, d2: cx.slab("material") == 1) > 500
    for other in (0, 2, 3):
        assert count(lambda cx, d2: (cx.slab("object_id") == other)
                     & (cx.blk("object_id") != other)
                     & (torch.sqrt(d2) < params.particle_diameter)) > 10


def test_nonpressure_wrench(box):
    ja, jf, jt = jcommon.nonpressure_fused(box.jp, box.jrigid, box.jenv,
                                           box.jsl, box.jparams)
    ta, tf, tt = tcommon.nonpressure_fused(box.tp, box.trigid, box.tenv,
                                           box.params)
    assert_pass_close(ta.numpy(), box.j(ja), "nonpressure acceleration")
    out = pair_kernels.run("nonpressure", box.tenv,
                           tcommon.nonpressure_fields(box.tp), box.params,
                           flags=pair_kernels.RIGID)
    sf, st = box.per_object(out["fpp"])
    assert_wrench_close(tf.numpy(), jf, sf, "viscosity force")
    assert_wrench_close(tt.numpy(), jt, st, "viscosity torque")


def test_correction_wrench(box):
    kappa_j = jnp.asarray(box.kappa_np)
    jdv, jf, jt = jdfsph._correction(box.jp, box.jrigid, kappa_j, None,
                                     box.jenv, box.jsl, box.jparams)
    tdv, tf, tt = tdfsph._correction(box.tp, box.trigid, box.kappa, box.tenv,
                                     box.params)
    assert_pass_close(tdv.numpy(), box.j(jdv), "correction dv")
    out = pair_kernels.run("correction", box.tenv,
                           tdfsph._correction_fields(box.tp, box.kappa),
                           box.params, flags=pair_kernels.RIGID)
    sf, st = box.per_object(out["fp"])
    assert_wrench_close(tf.numpy(), jf, sf, "correction force")
    assert_wrench_close(tt.numpy(), jt, st, "correction torque")


def test_nonpressure_warm_wrenches(box):
    kappa_j = jnp.asarray(box.kappa_np)
    j = jdfsph.nonpressure_warm_fused(box.jp, box.jrigid, kappa_j, box.jenv,
                                      box.jsl, box.jparams)
    t = tdfsph.nonpressure_warm_fused(box.tp, box.trigid, box.kappa,
                                      box.tenv, box.params)
    assert_pass_close(t[0].numpy(), box.j(j[0]), "warm acceleration")
    assert_pass_close(t[3].numpy(), box.j(j[3]), "warm dv")
    fields = tcommon.nonpressure_fields(box.tp)
    fields.update(tdfsph._correction_fields(box.tp, box.kappa))
    out = pair_kernels.run("nonpressure_warm", box.tenv, fields, box.params,
                           flags=pair_kernels.RIGID)
    for k, (tf, tt, jf, jt) in (("fpp", (t[1], t[2], j[1], j[2])),
                                ("wfp", (t[4], t[5], j[4], j[5]))):
        sf, st = box.per_object(out[k])
        assert_wrench_close(tf.numpy(), jf, sf, f"warm {k} force")
        assert_wrench_close(tt.numpy(), jt, st, f"warm {k} torque")


def test_pressure_wrench(box):
    """Force and torque per pair about the fluid particle's position."""
    pr = box.pr
    jp = box.jp.replace(pressure=pr)
    jsl = dict(box.jsl, pressure=slab_pack(box.jenv, {"pr": pr})["pr"])
    ja, jf, jt = jcommon.pressure_acceleration(jp, box.jrigid, box.jenv, jsl,
                                               box.jparams, with_wrench=True)
    tp = box.tp.replace(pressure=torch.from_numpy(pr[box.perm]))
    ta, tf, tt = tcommon.pressure_acceleration(tp, box.trigid, box.tenv,
                                               box.params, with_wrench=True)
    assert_pass_close(ta.numpy(), box.j(ja), "pressure acceleration")
    p_rho2 = tp.pressure / torch.clamp_min(tp.density * tp.density, 1e-12)
    out = pair_kernels.run(
        "pressure", box.tenv,
        {"pos": tp.pos, "material": tp.material, "mass": tp.mass,
         "rest_volume": tp.rest_volume, "p_rho2": p_rho2,
         "is_dynamic": tp.is_dynamic, "object_id": tp.object_id,
         "com": box.trigid.com},
        box.params, flags=pair_kernels.RIGID)
    sf, _ = box.per_object(out["fpp"])
    # the torque is summed per pair: its terms are the rows' tpp
    st = tcommon.object_reduce(
        {"t": out["tpp"].abs()}, tcommon.object_index(tp, box.params),
        box.params.max_objects,
        sel=tcommon.rigid_dyn(tp) & (tp.object_id >= 0))["t"].numpy()
    assert_wrench_close(tf.numpy(), jf, sf, "pressure force")
    assert_wrench_close(tt.numpy(), jt, st, "pressure torque")


def test_density_alpha_divergence_svol(box):
    """The same-object W sum rides the density/alpha/divergence pass."""
    *_, jsvol = jdfsph.density_alpha_divergence(box.jp, box.jenv, box.jsl,
                                                box.jparams)
    *_, tsvol = tdfsph.density_alpha_divergence(box.tp, box.tenv, box.params)
    assert jsvol is not None and tsvol is not None
    assert_pass_close(tsvol.numpy()[box.dyn], box.j(jsvol)[box.dyn],
                      "rigid pseudo-volume sum")


def test_rigid_contact_pass(box):
    j = jint.rigid_contact_data(box.jp, box.jrigid, box.jenv, box.jparams)
    t = tint.rigid_contact_data(box.tp, box.trigid, box.tenv, box.params)
    assert set(t) == set(j) == {"cw_a", "cw_b", "cw_st", "cn_a", "cn_b",
                                "cn_st"}
    for k in t:
        assert np.abs(np.asarray(j[k])).max() > 0, k
        assert_pass_close(t[k].numpy()[box.dyn], box.j(j[k])[box.dyn], k)
        assert not t[k].numpy()[~box.dyn].any(), f"{k} on other rows"


def test_rigid_volume_after_rigid_motion(box):
    """The feed-forward methods recompute the dynamic bodies' volumes after
    the bodies moved, on the environment of the sort before the move: every
    same-object pair within the radius is still a candidate."""
    jr, tr = box.jrigid, box.trigid
    O = box.params.max_objects
    omega = np.zeros((O, 3), np.float32)
    omega[[0, 2]] = [[3.0, -2.0, 1.0], [-1.0, 2.5, 2.0]]
    vel = np.zeros((O, 3), np.float32)
    vel[[0, 2]] = [[1.5, -1.0, 0.5], [-0.5, 1.0, 1.5]]
    dt = box.params.dt
    jturn = jint._rodrigues(jnp.asarray(omega), dt)
    jmoved = jr.replace(com=jr.com + dt * jnp.asarray(vel),
                        rot=jnp.einsum("oij,ojk->oik", jturn, jr.rot))
    jp = jcommon.renew_rigid_particle_state(box.jp, jmoved, box.jparams)
    fresh = slab_pack(box.jenv, {"pos": jp.pos, "object_id": jp.object_id})
    jsl = dict(box.jsl, object_id=fresh["object_id"])
    jv = jcommon.compute_rigid_particle_volume(jp, box.jenv, jsl, box.jparams,
                                               pos_slab=fresh["pos"])
    tp = box.tp.replace(pos=torch.from_numpy(box.j(jp.pos)))
    moved = np.abs(tp.pos.numpy() - box.tp.pos.numpy()).max(1)
    assert moved[box.dyn].min() > 1e-4
    tv = tcommon.compute_rigid_particle_volume(tp, box.tenv, box.params)
    assert_pass_close(tv.rest_volume.numpy()[box.dyn] * 1e6,
                      box.j(jv.rest_volume)[box.dyn] * 1e6,
                      "moved rigid volume (cm^3)")
    np.testing.assert_array_equal(tv.rest_volume.numpy()[~box.dyn],
                                  box.tp.rest_volume.numpy()[~box.dyn])
    assert_pass_close(tv.mass.numpy()[box.dyn], box.j(jv.mass)[box.dyn],
                      "moved rigid mass")


def test_pressure_wrench_balances_momentum(cube_obj):
    """tests/test_rigid.py's momentum balance on the port: under a uniform
    fluid pressure the fluid's momentum change and the force on the body sum
    to about zero."""
    from test_torch_scene import load_both
    from sph_project_tpu_torch import sim as tsim
    cfg = {"Configuration": base_cfg(),
           "RigidBodies": [rigid_body(0, cube_obj, (0.3, 0.22, 0.3))],
           "FluidBlocks": [fluid_block(1, (0.2, 0.05, 0.2), (0.4, 0.2, 0.4))]}
    _, _, ts, tst = load_both(cfg)
    params = ts.params
    sim = tsim.Simulation(ts, tst, device="cpu")
    state, env = tsim.Plumbing.neighbor_prep(sim.state, params)
    p = state.particles
    p = p.replace(density=tcommon.compute_density(p, env, params))
    p = p.replace(pressure=torch.where(p.material == 1, 500.0, 0.0))
    acc, rf, _ = tcommon.pressure_acceleration(p, state.rigid, env, params,
                                               with_wrench=True)
    m = p.mass.numpy().astype(np.float64)
    a = acc.numpy().astype(np.float64)
    fluid_mom = (m[:, None] * a).sum(axis=0)
    rigid_force = rf.numpy().astype(np.float64).sum(axis=0)
    scale = np.abs(m[:, None] * a).sum() + 1e-12
    assert np.abs(rigid_force).max() > 0.01 * scale / len(m)
    np.testing.assert_allclose(fluid_mom + rigid_force, 0.0,
                               atol=2e-5 * scale)

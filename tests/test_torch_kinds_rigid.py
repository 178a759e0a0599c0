"""The port's pair passes with dynamic rigid bodies in 2D and under poly6,
against the JAX package's.

Two states, each under both of the port's engines:

- poly6 in 3D: tests/test_torch_rigid_passes.py's coupled cubes (two
  dynamic cubes pressed together and against a static one, in a fluid
  block) under ``kernel_type="poly6"``;
- 2D, under the cubic spline and under poly6: a hand-built state, since a
  scene file cannot give a 2D dynamic body (the loaders fill meshes with 3D
  points). In the corner of the 2D domain box two fluid blocks, one on the
  other, become dynamic rigid bodies (material, object and body tables set
  in the arrays both packages start from), the upper pushed a quarter
  particle diameter into the lower, which touches the floor and the wall; a
  fluid pool rests beside them: wrench pairs with the fluid, contact pairs
  with the other body and with the walls.

The JAX package prepares (sorts) each state; the bridge carries it to the
port row for row; the port sorts it by its own cell ids. Velocities,
stiffnesses and pressures are made from a seed with numpy. Checked, against
the JAX functions through its CPU executor: the non-pressure pass and its
viscosity wrench, the correction and its wrench, both wrenches of the warm
pass, the pressure force and its per-pair torque (one component in 2D),
the same-object sum of the density/alpha/divergence pass, the contact pass
channel by channel, the rigid volume after one step of rigid motion, and
the shape-matching backend's DEM contact (``rigid_dem``, per row against the
JAX pair pass of ``rigid_contact_wrench``, and its per-body wrench).

Tolerances, as tests/test_torch_rigid_passes.py: per-row sums max|a - b| <=
2e-5 * max(1, max|b|); a per-object force or torque within 1e-5 of the sum
of |per-particle terms| of that object.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_project_tpu.ops import pair_exec as jpair_exec
from sph_project_tpu.ops.pairs import slab_pack
from sph_project_tpu.rigid import integrator as jint
from sph_project_tpu.solvers import common as jcommon
from sph_project_tpu.solvers import dfsph as jdfsph

from sph_project_tpu_torch.ops import pair_kernels
from sph_project_tpu_torch.rigid import integrator as tint
from sph_project_tpu_torch.solvers import common as tcommon
from sph_project_tpu_torch.solvers import dfsph as tdfsph

from test_rigid import write_cube_obj
from test_torch_kinds import ENGINE_IDS, ENGINES, KindSetup, box2d_config
from test_torch_pairs import assert_pass_close
from test_torch_rigid_passes import (assert_wrench_close, coupled_config)

# the bodies of the 2D state: the pool's object and the two that become
# dynamic rigid bodies
POOL, BODY_A, BODY_B = 0, 1, 2


def pool2d_config():
    """The 2D domain box with two blocks in its corner, one on the other,
    and a pool beside them on the floor."""
    cfg = box2d_config()
    block = dict(cfg["FluidBlocks"][0], velocity=[0.0, 0.0])
    cfg["FluidBlocks"] = [
        dict(block, objectId=POOL, start=[0.1, 0.04], end=[0.26, 0.14]),
        dict(block, objectId=BODY_A, start=[0.04, 0.04], end=[0.1, 0.1]),
        dict(block, objectId=BODY_B, start=[0.04, 0.1], end=[0.1, 0.16])]
    return cfg


def make_bodies_2d(params, jstate):
    """The blocks BODY_A and BODY_B turned dynamic rigid bodies: rigid
    material, their rest positions, and a body table (mass, com, the
    identity rotation); BODY_B pushed a quarter particle diameter down into
    BODY_A, which touches the floor and the wall (module docstring).
    Returns (the parameters of dynamic bodies, the state)."""
    p, r = jstate.particles, jstate.rigid
    obj = np.asarray(p.object_id)
    pos = np.array(p.pos)
    mat = np.array(p.material)
    dyn = np.array(p.is_dynamic)
    body = np.isin(obj, (BODY_A, BODY_B))
    pos[obj == BODY_B, 1] -= 0.25 * params.particle_diameter
    mat[body] = 2
    dyn[body] = 1
    com = np.array(r.com)
    mass = np.array(r.mass)
    for o in (BODY_A, BODY_B):
        com[o] = pos[obj == o].mean(0)
        mass[o] = 0.5 * params.density0 * (obj == o).sum() * params.v0
    obj_mat = np.array(r.obj_material)
    r_dyn = np.array(r.is_dynamic)
    obj_mat[[BODY_A, BODY_B]] = 2
    r_dyn[[BODY_A, BODY_B]] = 1
    rot = np.array(r.rot)
    rot[[BODY_A, BODY_B]] = np.eye(2, dtype=np.float32)
    rest = np.where(body[:, None], pos, 0.0).astype(np.float32)
    p = p.replace(pos=jnp.asarray(pos), material=jnp.asarray(mat),
                  is_dynamic=jnp.asarray(dyn), rigid_rest_pos=jnp.asarray(rest))
    r = r.replace(com=jnp.asarray(com), com0=jnp.asarray(com),
                  mass=jnp.asarray(mass), rot=jnp.asarray(rot),
                  obj_material=jnp.asarray(obj_mat),
                  is_dynamic=jnp.asarray(r_dyn))
    return (dict(has_rigid=True, has_dynamic_rigid=True,
                 contact_channels=(BODY_A, BODY_B)),
            jstate.replace(particles=p, rigid=r))


class RigidKindSetup(KindSetup):
    def __init__(self, config, engine, state_fn=None, **overrides):
        super().__init__(config, engine, state_fn=state_fn, **overrides)
        assert self.params.has_dynamic_rigid
        tp = self.tp
        self.dyn = (tcommon.rigid_dyn(tp) & (tp.object_id >= 0)).numpy()
        self.pr = self.seeded(3, 0.0, 3000.0)

    def per_object(self, rows):
        """The sums of |per-particle terms| per object of a per-row force
        and of its torque about the body's com."""
        p, params = self.tp, self.params
        rows = torch.as_tensor(rows)
        t = tcommon.pair_cross(
            p.pos - self.trigid.com[tcommon.object_index(p, params)], rows,
            params.dim)
        out = tcommon.object_reduce({"f": rows.abs(), "t": t.abs()},
                                    tcommon.object_index(p, params),
                                    params.max_objects, sel=self.sel())
        return out["f"].numpy(), out["t"].numpy()

    def sel(self):
        return torch.from_numpy(self.dyn)


@pytest.fixture(scope="module")
def cube_obj(tmp_path_factory):
    return write_cube_obj(str(tmp_path_factory.mktemp("mesh") / "cube.obj"))


def box_fixture(states):
    """A module fixture: the setup of each of ``states`` ("poly6_3d",
    "cubic_2d", "poly6_2d", or "cubic_3d": the coupled cubes under the cubic
    spline) under each engine."""
    @pytest.fixture(scope="module", params=[(s, e) for s in states
                                            for e in ENGINES],
                    ids=[f"{s}-{e}" for s in states for e in ENGINE_IDS])
    def box(request, cube_obj):
        state, engine = request.param
        kind = state.split("_")[0]
        if state.endswith("3d"):
            s = RigidKindSetup(coupled_config(cube_obj), engine,
                               kernel_type=kind)
            assert s.params.contact_channels == (0, 2)
        else:
            s = RigidKindSetup(pool2d_config(), engine,
                               state_fn=make_bodies_2d, kernel_type=kind)
            assert s.params.dim == 2
        assert s.params.kernel_type == kind
        return s

    return box


# here poly6 in 3D; tests/test_torch_kinds_rigid_2d.py runs these tests on
# the 2D state
box = box_fixture(("poly6_3d",))


def test_state_has_wrench_and_contact_pairs(box):
    """Dynamic rigid rows with fluid neighbours (the wrench rows) and with
    contact pairs with the other body and with static geometry."""
    out = tint.rigid_contact_data(box.tp, box.trigid, box.tenv, box.params)
    for tag in ("a", "b", "st"):
        assert (out[f"cw_{tag}"].numpy() > 0).sum() >= 3, tag
    fluid_j = pair_kernels.run(
        "nonpressure", box.tenv, tcommon.nonpressure_fields(box.tp),
        box.params, flags=pair_kernels.RIGID)["fpp"]
    assert (fluid_j.abs().sum(1).numpy()[box.dyn] > 0).sum() >= 6


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
    jdv, jf, jt = jdfsph._correction(box.jp, box.jrigid,
                                     jnp.asarray(box.kappa_np), None,
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
    j = jdfsph.nonpressure_warm_fused(box.jp, box.jrigid,
                                      jnp.asarray(box.kappa_np), box.jenv,
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
    """Force and torque per pair about the fluid particle's position; in 2D
    the torque has one component."""
    pr = box.pr
    jp = box.jp.replace(pressure=pr)
    jsl = dict(box.jsl, pressure=slab_pack(box.jenv, {"pr": pr})["pr"])
    ja, jf, jt = jcommon.pressure_acceleration(jp, box.jrigid, box.jenv, jsl,
                                               box.jparams, with_wrench=True)
    tp = box.tp.replace(pressure=box.t(pr))
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
    assert out["tpp"].shape == (box.params.n_pad,
                                3 if box.params.dim == 3 else 1)
    sf, _ = box.per_object(out["fpp"])
    st = tcommon.object_reduce(
        {"t": out["tpp"].abs()}, tcommon.object_index(tp, box.params),
        box.params.max_objects, sel=box.sel())["t"].numpy()
    assert_wrench_close(tf.numpy(), jf, sf, "pressure force")
    assert_wrench_close(tt.numpy(), jt, st, "pressure torque")


def test_density_alpha_divergence_svol(box):
    *_, jsvol = jdfsph.density_alpha_divergence(box.jp, box.jenv, box.jsl,
                                                box.jparams)
    *_, tsvol = tdfsph.density_alpha_divergence(box.tp, box.tenv, box.params)
    assert_pass_close(tsvol.numpy()[box.dyn], box.j(jsvol)[box.dyn],
                      "rigid pseudo-volume sum")


def test_rigid_contact_pass(box):
    j = jint.rigid_contact_data(box.jp, box.jrigid, box.jenv, box.jparams)
    t = tint.rigid_contact_data(box.tp, box.trigid, box.tenv, box.params)
    assert set(t) == set(j)
    for k in t:
        assert t[k].shape == box.j(j[k]).shape, k
        assert np.abs(np.asarray(j[k])).max() > 0, k
        assert_pass_close(t[k].numpy()[box.dyn], box.j(j[k])[box.dyn], k)
        assert not t[k].numpy()[~box.dyn].any(), f"{k} on other rows"


def test_rigid_volume_after_rigid_motion(box):
    """The dynamic bodies' volumes after one step of rigid motion (a turn
    and a shift each), on the environment sorted before it."""
    jr = box.jrigid
    dim, O, dt = box.params.dim, box.params.max_objects, box.params.dt
    bodies = list(box.params.contact_channels)
    rng = np.random.default_rng(7)
    vel = np.zeros((O, dim), np.float32)
    vel[bodies] = rng.uniform(-1.5, 1.5, (len(bodies), dim))
    if dim == 3:
        omega = np.zeros((O, 3), np.float32)
        omega[bodies] = rng.uniform(-3.0, 3.0, (len(bodies), 3))
        turn = np.asarray(jint._rodrigues(jnp.asarray(omega), dt))
    else:
        th = np.zeros(O)
        th[bodies] = rng.uniform(-3.0, 3.0, len(bodies)) * dt
        c, s = np.cos(th), np.sin(th)
        turn = np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)
    rot = np.einsum("oij,ojk->oik", turn.astype(np.float32),
                    np.asarray(jr.rot)).astype(np.float32)
    jmoved = jr.replace(com=jr.com + dt * jnp.asarray(vel),
                        rot=jnp.asarray(rot))
    jp = jcommon.renew_rigid_particle_state(box.jp, jmoved, box.jparams)
    fresh = slab_pack(box.jenv, {"pos": jp.pos, "object_id": jp.object_id})
    jsl = dict(box.jsl, object_id=fresh["object_id"])
    jv = jcommon.compute_rigid_particle_volume(jp, box.jenv, jsl, box.jparams,
                                               pos_slab=fresh["pos"])
    tp = box.tp.replace(pos=box.t(jp.pos))
    moved = np.abs(tp.pos.numpy() - box.tp.pos.numpy()).max(1)
    assert moved[box.dyn].min() > 1e-5
    tv = tcommon.compute_rigid_particle_volume(tp, box.tenv, box.params)
    assert_pass_close(tv.rest_volume.numpy()[box.dyn] * 1e6,
                      box.j(jv.rest_volume)[box.dyn] * 1e6,
                      "moved rigid volume (cm^3)")
    assert_pass_close(tv.mass.numpy()[box.dyn], box.j(jv.mass)[box.dyn],
                      "moved rigid mass")


def test_rigid_dem_pass(box):
    """The DEM contact of the shape-matching backend: the JAX pair pass of
    ``rigid_contact_wrench`` per row (recorded from a call), the port's
    ``rigid_dem`` body on the dynamic rigid rows, and the per-body force
    and torque. The bodies' velocities are seeded so that the damper acts,
    in both directions."""
    calls = []
    real = jpair_exec.run

    def record(kern, env, slabs, fields, params):
        out = real(kern, env, slabs, fields, params)
        calls.append(out)
        return out

    jpair_exec.run = record
    try:
        jf, jt = jint.rigid_contact_wrench(box.jp, box.jrigid, box.jenv,
                                           box.jparams)
    finally:
        jpair_exec.run = real
    tf, tt = tint.rigid_contact_wrench(box.tp, box.trigid, box.tenv,
                                       box.params)
    out = pair_kernels.run(
        "rigid_dem", box.tenv,
        {"pos": box.tp.pos, "vel": box.tp.vel, "material": box.tp.material,
         "object_id": box.tp.object_id}, box.params,
        produce=tint.dynamic_rigid_mask(box.tp, box.trigid, box.params))["f"]
    jrows = box.j(calls[0]["f"])
    assert (np.abs(jrows[box.dyn]).max(1) > 0).sum() >= 3
    assert_pass_close(out.numpy()[box.dyn], jrows[box.dyn], "DEM force")
    assert not out.numpy()[~box.dyn].any()
    sf, st = box.per_object(out)
    assert_wrench_close(tf.numpy(), jf, sf, "DEM force per body")
    assert_wrench_close(tt.numpy(), jt, st, "DEM torque per body")

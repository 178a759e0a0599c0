"""The port's rigid-body integrator in 2D against the JAX package's.

tests/test_torch_rigid_integrator.py's units on a 2D state: a body turns in
the plane, its angular velocity and torque are (O, 1), and every cross
product is the scalar of ``pair_cross``. The same inputs, made from a seed
with numpy, go through both packages: the placement of the dynamic rigid
particles (``renew_rigid_particle_state``: x = com + R q, v = v_body + omega
x (R q)), the body step without and with contact (``rigid_body_step``: the
planar rotation by omega dt, the walls over two axes) and the impulse solve
(``resolve_body_contacts``: 2D point velocities and torques). One dynamic
block pressed into the floor's inset among static objects and fluid, and
three more dynamic bodies in contact records with it and with static
geometry.

Tolerance: 1e-6 of the largest |value| of each output, as
tests/test_torch_rigid_integrator.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_project_tpu.core import params as jparams_mod
from sph_project_tpu.core import state as jstate_mod
from sph_project_tpu.rigid import integrator as jint
from sph_project_tpu.solvers import common as jcommon

from sph_project_tpu_torch import bridge
from sph_project_tpu_torch.core import params as tparams_mod
from sph_project_tpu_torch.rigid import integrator as tint
from sph_project_tpu_torch.solvers import common as tcommon

from test_torch_rigid_integrator import assert_close
from test_torch_scene import flatten_jax_state

N_PARTICLES = 600
DYNAMIC = (1, 2, 4, 6)         # body ids; 0 and 3 are static rigid, 5 fluid
BLOCK = 2                      # the block pressed into the floor's inset
KW = dict(dim=2, domain_end=(0.6, 0.6), gravity=(0.0, -9.81),
          contact_channels=DYNAMIC,
          has_dynamic_rigid=True, dt=2e-3, wall_thickness=0.03)


def planar(theta):
    c, s = np.cos(theta), np.sin(theta)
    return np.stack([np.stack([c, -s], -1), np.stack([s, c], -1)], -2)


class Case2D:
    """Seeded particles and body tables in both packages, 2D."""

    def __init__(self, seed=0):
        rng = np.random.default_rng(seed)
        self.jp = jparams_mod.make_params(N_PARTICLES, **KW)
        self.tp = tparams_mod.make_params(N_PARTICLES, **KW)
        js = jstate_mod.zeros_state(self.jp)
        O, N = self.jp.max_objects, self.jp.n_pad
        obj = rng.integers(0, 7, N).astype(np.int32)
        obj[-20:] = -1                                   # padding slots
        mat = np.where(obj == 5, 1, 2).astype(np.int32)
        mat[obj < 0] = 0
        dyn = np.isin(obj, DYNAMIC) | (obj == 5)
        com = rng.uniform(0.15, 0.45, (O, 2)).astype(np.float32)
        com[BLOCK] = [0.3, 0.095]                        # near the floor
        rest = (rng.normal(0.0, 0.03, (N, 2)) + com[np.clip(obj, 0, O - 1)]
                ).astype(np.float32)
        rot = planar(rng.uniform(0, 3, O)).astype(np.float32)
        mass = rng.uniform(0.5, 3.0, O).astype(np.float32)
        r_dyn = np.isin(np.arange(O), DYNAMIC).astype(np.int32)
        r_mat = np.zeros(O, np.int32)
        r_mat[:7] = [2, 2, 2, 2, 2, 1, 2]
        present = np.zeros(O, np.int32)
        present[:7] = 1
        particles = js.particles.replace(
            pos=jnp.asarray(rest + rng.normal(0, 1e-3, (N, 2)).astype(np.float32)),
            vel=jnp.asarray(rng.normal(0, 0.3, (N, 2)).astype(np.float32)),
            material=jnp.asarray(mat), object_id=jnp.asarray(obj),
            is_dynamic=jnp.asarray(dyn.astype(np.int32)),
            rigid_rest_pos=jnp.asarray(rest))
        rigid = js.rigid.replace(
            mass=jnp.asarray(mass), com=jnp.asarray(com),
            com0=jnp.asarray(com + rng.normal(0, 0.01, (O, 2)).astype(np.float32)),
            rot=jnp.asarray(rot),
            vel=jnp.asarray(rng.normal(0, 0.5, (O, 2)).astype(np.float32)),
            omega=jnp.asarray(rng.normal(0, 2.0, (O, 1)).astype(np.float32)),
            force=jnp.asarray(rng.normal(0, 5.0, (O, 2)).astype(np.float32)),
            torque=jnp.asarray(rng.normal(0, 0.5, (O, 1)).astype(np.float32)),
            is_dynamic=jnp.asarray(r_dyn), obj_material=jnp.asarray(r_mat),
            present=jnp.asarray(present))
        self.jstate = js.replace(particles=particles, rigid=rigid)
        ts = bridge.state_from_numpy(flatten_jax_state(self.jstate), self.tp)
        self.tpart, self.trigid = ts.particles, ts.rigid
        assert self.trigid.omega.shape == (O, 1)
        # contact records on the dynamic bodies' particles: a third of them
        # touch, with weights well above the 1e-12 threshold
        tags = list("abcd") + ["st"]
        body_rows = dyn & (mat == 2)
        contact = {}
        for c, tag in enumerate(tags):
            on = body_rows & (rng.uniform(size=N) < 0.3) & \
                (obj != (DYNAMIC[c] if c < len(DYNAMIC) else -5))
            contact[f"cw_{tag}"] = np.where(
                on, rng.uniform(1e-4, 5e-3, N), 0.0).astype(np.float32)
            contact[f"cn_{tag}"] = np.where(
                on[:, None], rng.normal(0, 3e-3, (N, 2)), 0.0).astype(np.float32)
        self.contact = contact

    def jcontact(self):
        return {k: jnp.asarray(v) for k, v in self.contact.items()}

    def tcontact(self):
        return {k: torch.from_numpy(v) for k, v in self.contact.items()}


@pytest.fixture(scope="module")
def case():
    return Case2D()


def test_renew_rigid_particle_state_2d(case):
    jp = jcommon.renew_rigid_particle_state(case.jstate.particles,
                                            case.jstate.rigid, case.jp)
    tp = tcommon.renew_rigid_particle_state(case.tpart, case.trigid, case.tp)
    moved = np.asarray(jp.pos) != np.asarray(case.jstate.particles.pos)
    assert moved.any(axis=1).sum() > 100
    assert_close(tp.pos.numpy(), jp.pos, "positions")
    assert_close(tp.vel.numpy(), jp.vel, "velocities")


@pytest.mark.parametrize("with_contact", [False, True],
                         ids=["free", "contact"])
def test_rigid_body_step_2d(case, with_contact):
    """The planar rotation, the walls over two axes (the block reaches below
    the floor's inset) and with contact the impulse solve."""
    j = jint.rigid_body_step(case.jstate.particles, case.jstate.rigid,
                             case.jp, contact=case.jcontact()
                             if with_contact else None)
    t = tint.rigid_body_step(case.tpart, case.trigid, case.tp,
                             contact=case.tcontact() if with_contact else None)
    for k in ("com", "vel", "omega", "rot", "force", "torque"):
        assert getattr(t, k).shape == np.asarray(getattr(j, k)).shape, k
        assert_close(getattr(t, k).numpy(), getattr(j, k), k)
    assert float(t.vel[BLOCK, 1]) >= 0.0
    # the rotation stays a rotation
    r = t.rot.numpy()[list(DYNAMIC)].astype(np.float64)
    np.testing.assert_allclose(np.linalg.det(r), 1.0, atol=1e-5)


def test_resolve_body_contacts_2d(case):
    jr = case.jstate.rigid
    vel = jr.vel + 0.1
    omega = jr.omega * 0.5
    j = jint.resolve_body_contacts(case.jstate.particles, jr, vel, omega,
                                   case.jcontact(), case.jp)
    t = tint.resolve_body_contacts(case.tpart, case.trigid,
                                   torch.from_numpy(np.array(vel)),
                                   torch.from_numpy(np.array(omega)),
                                   case.tcontact(), case.tp)
    for name, a, b in zip(("vel", "omega", "d_com"), t, j):
        assert a.shape == np.asarray(b).shape, name
        assert_close(a.numpy(), b, name)
    assert np.abs(np.asarray(j[0]) - np.asarray(vel)).max() > 1e-4
    assert np.abs(np.asarray(j[1]) - np.asarray(omega)).max() > 1e-4
    assert np.abs(np.asarray(j[2])).max() > 0

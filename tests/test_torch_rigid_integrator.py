"""The port's rigid-body integrator against the JAX package's, unit by unit.

The same inputs, made from a seed with numpy, go through the JAX package's
``rigid/integrator.py`` and ``solvers/common.py`` and the port's
``rigid/integrator.py`` and ``solvers/common.py``: the incremental rotation
(``_rodrigues``), the placement of the dynamic rigid particles
(``renew_rigid_particle_state``), the body step without and with contact
(``rigid_body_step``) and the impulse solve (``resolve_body_contacts``).
Four dynamic bodies (one of them pressed into a wall, two in contact with
each other and one with static geometry) among static objects and fluid.

Tolerance: 1e-6 of the largest |value| of each output: float32 arithmetic in
another order (the per-object sums are one-hot products on both sides) and
sums of products in place of batched matrix products.
"""
import dataclasses

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
from sph_project_tpu_torch.geometry.mesh import rotation_matrix_axis_angle
from sph_project_tpu_torch.ops import pair_kernels
from sph_project_tpu_torch.rigid import integrator as tint
from sph_project_tpu_torch.solvers import common as tcommon

from test_torch_scene import flatten_jax_state

REL = 1e-6
N_PARTICLES = 600             # the state has n_pad slots
DYNAMIC = (1, 2, 4, 6)         # body ids; 0 and 3 are static rigid, 5 fluid
KW = dict(domain_end=(0.6, 0.6, 0.6), contact_channels=DYNAMIC,
          has_dynamic_rigid=True, dt=2e-3, wall_thickness=0.03)


def assert_close(a, b, what):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert a.shape == b.shape, what
    err = np.max(np.abs(a - b)) if a.size else 0.0
    assert err <= REL * max(np.max(np.abs(b)), 1e-30), \
        f"{what}: max err {err} of {np.max(np.abs(b))}"


class Case:
    """Seeded particles and body tables in both packages."""

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
        com = rng.uniform(0.15, 0.45, (O, 3)).astype(np.float32)
        com[2] = [0.3, 0.095, 0.3]                       # near the floor
        rest = (rng.normal(0.0, 0.03, (N, 3)) + com[np.clip(obj, 0, O - 1)]
                ).astype(np.float32)
        axis = rng.normal(size=(O, 3))
        rot = np.stack([rotation_matrix_axis_angle(a, rng.uniform(0, 3))
                        for a in axis])
        mass = rng.uniform(0.5, 3.0, O).astype(np.float32)
        r_dyn = np.isin(np.arange(O), DYNAMIC).astype(np.int32)
        r_mat = np.zeros(O, np.int32)
        r_mat[:7] = [2, 2, 2, 2, 2, 1, 2]
        present = np.zeros(O, np.int32)
        present[:7] = 1
        particles = js.particles.replace(
            pos=jnp.asarray(rest + rng.normal(0, 1e-3, (N, 3)).astype(np.float32)),
            vel=jnp.asarray(rng.normal(0, 0.3, (N, 3)).astype(np.float32)),
            material=jnp.asarray(mat), object_id=jnp.asarray(obj),
            is_dynamic=jnp.asarray(dyn.astype(np.int32)),
            rigid_rest_pos=jnp.asarray(rest))
        rigid = js.rigid.replace(
            mass=jnp.asarray(mass), com=jnp.asarray(com),
            com0=jnp.asarray(com + rng.normal(0, 0.01, (O, 3)).astype(np.float32)),
            rot=jnp.asarray(rot.astype(np.float32)),
            vel=jnp.asarray(rng.normal(0, 0.5, (O, 3)).astype(np.float32)),
            omega=jnp.asarray(rng.normal(0, 2.0, (O, 3)).astype(np.float32)),
            force=jnp.asarray(rng.normal(0, 5.0, (O, 3)).astype(np.float32)),
            torque=jnp.asarray(rng.normal(0, 0.5, (O, 3)).astype(np.float32)),
            is_dynamic=jnp.asarray(r_dyn), obj_material=jnp.asarray(r_mat),
            present=jnp.asarray(present))
        self.jstate = js.replace(particles=particles, rigid=rigid)
        ts = bridge.state_from_numpy(flatten_jax_state(self.jstate), self.tp)
        self.tpart, self.trigid = ts.particles, ts.rigid
        # contact records on the dynamic bodies' particles: a third of them
        # touch, with weights well above the 1e-12 threshold
        C = len(DYNAMIC) + 1
        tags = list("abcd") + ["st"]
        body_rows = dyn & (mat == 2)
        contact = {}
        for c, tag in enumerate(tags):
            on = body_rows & (rng.uniform(size=N) < 0.3) & \
                (obj != (DYNAMIC[c] if c < C - 1 else -5))
            contact[f"cw_{tag}"] = np.where(
                on, rng.uniform(1e-4, 5e-3, N), 0.0).astype(np.float32)
            contact[f"cn_{tag}"] = np.where(
                on[:, None], rng.normal(0, 3e-3, (N, 3)), 0.0).astype(np.float32)
        self.contact = contact

    def jcontact(self):
        return {k: jnp.asarray(v) for k, v in self.contact.items()}

    def tcontact(self):
        return {k: torch.from_numpy(v) for k, v in self.contact.items()}


@pytest.fixture(scope="module")
def case():
    return Case()


def test_rodrigues(case):
    rng = np.random.default_rng(1)
    omega = rng.normal(0, 3.0, (32, 3)).astype(np.float32)
    omega[0] = 0.0                                       # no rotation
    j = jint._rodrigues(jnp.asarray(omega), 2e-3)
    t = tint._rodrigues(torch.from_numpy(omega), 2e-3)
    assert_close(t.numpy(), j, "rotation increments")


def test_renew_rigid_particle_state(case):
    jp = jcommon.renew_rigid_particle_state(case.jstate.particles,
                                            case.jstate.rigid, case.jp)
    tp = tcommon.renew_rigid_particle_state(case.tpart, case.trigid, case.tp)
    moved = np.asarray(jp.pos) != np.asarray(case.jstate.particles.pos)
    assert moved.any(axis=1).sum() > 100
    assert_close(tp.pos.numpy(), jp.pos, "positions")
    assert_close(tp.vel.numpy(), jp.vel, "velocities")


def _check_rigid(t, j):
    for k in ("com", "vel", "omega", "rot", "force", "torque"):
        assert_close(getattr(t, k).numpy(), getattr(j, k), k)


@pytest.mark.parametrize("with_contact", [False, True],
                         ids=["free", "contact"])
def test_rigid_body_step(case, with_contact):
    """Integration, the walls (body 2 sits below the floor's inset), and with
    contact the impulse solve between it."""
    j = jint.rigid_body_step(case.jstate.particles, case.jstate.rigid,
                             case.jp, contact=case.jcontact()
                             if with_contact else None)
    t = tint.rigid_body_step(case.tpart, case.trigid, case.tp,
                             contact=case.tcontact() if with_contact else None)
    _check_rigid(t, j)
    # body 2 reaches below the floor's inset: no velocity into the floor
    assert float(t.vel[2, 1]) >= 0.0


def test_resolve_body_contacts(case):
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
        assert_close(a.numpy(), b, name)
    # the impulses moved the bodies in contact
    assert np.abs(np.asarray(j[0]) - np.asarray(vel)).max() > 1e-4
    assert np.abs(np.asarray(j[2])).max() > 0


def test_contact_channels_and_tags(case):
    """One channel per dynamic body in ``contact_channels`` order, then the
    merged static channel for every static rigid object."""
    table = tint.channel_table(case.trigid, case.tp).numpy()
    assert list(table[list(DYNAMIC)]) == [0, 1, 2, 3]
    assert list(table[[0, 3]]) == [4, 4]
    assert table[5] == -1 and (table[7:] == -1).all()
    assert pair_kernels.contact_tags(case.tp) == jint._chan_tags(case.jp)
    many = dataclasses.replace(case.tp, contact_channels=tuple(range(27)))
    with pytest.raises(ValueError, match="contact channels"):
        pair_kernels.contact_tags(many)

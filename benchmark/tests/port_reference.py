"""A test-only reference that imports the measured program
(``sph_project_tpu_torch``): it rebuilds the port's state from the snapshot
it is handed and takes one eager step of the port.

It stands in, in the harness's tests, for the plain reference of a
configuration whose bodies move, which the benchmark does not have yet: it
shows that such a reference is handed all it needs (``harness.py``'s module
docstring) and that what it returns about the bodies is compared. It is no
yardstick, since it is the program itself, so it never lives under
``benchmark/reference/``: a test copies it into a copy of the benchmark.
The constants are those of ``reference/sph.py`` for the configuration
without its bodies; ``dtype`` is not read (the port computes in float32).
"""
from __future__ import annotations

import dataclasses
import json

import torch

from reference import sph
from reference.sph import FLUID, RIGID, Pairs  # noqa: F401

from sph_project_tpu_torch.core.params import MATERIAL_RIGID
from sph_project_tpu_torch.core.state import (ParticleState, RigidState,
                                              SimState)
from sph_project_tpu_torch.scene import load_scene
from sph_project_tpu_torch.sim import Plumbing, get_step_fn
from sph_project_tpu_torch.utils.config import SimConfig


@dataclasses.dataclass(frozen=True)
class PortPhysics(sph.Physics):
    """``sph.Physics`` and the configuration file, as JSON, that the step
    loads the port's scene from."""
    config: str = ""


def physics_of(config: dict) -> PortPhysics:
    scene = {k: v for k, v in config["scene"].items() if k != "RigidBodies"}
    base = sph.physics_of(dict(config, scene=scene))
    return PortPhysics(**dataclasses.asdict(base), config=json.dumps(config))


def step(start: dict, ph: PortPhysics, dtype=torch.float64) -> dict:
    """The port's step from the snapshot ``start``: the state rebuilt from
    its tensors, the pair environment of its sort built again, one eager
    step. Returns the contract's fields in the step's row order, and the
    rows' object ids and the present dynamic bodies."""
    cfg = json.loads(ph.config)
    scene, _ = load_scene(config=SimConfig(config=cfg["scene"]),
                          **cfg["constants"], **cfg["overrides"])
    params = scene.params

    def own(names, src):
        return {k: src[k].clone() for k in names}

    top = [f.name for f in dataclasses.fields(SimState)
           if f.name not in ("particles", "rigid", "cached_neighbors")]
    state = SimState(
        particles=ParticleState(**own(
            [f.name for f in dataclasses.fields(ParticleState)], start)),
        rigid=RigidState(**own(list(start["rigid"]), start["rigid"])),
        **own(top, start))
    state, env = Plumbing.neighbor_prep(state, params)
    new, diag = get_step_fn(params)(state.replace(cached_neighbors=env))
    p, r = new.particles, new.rigid
    moving = (r.is_dynamic > 0) & (r.present > 0) & \
        (r.obj_material == MATERIAL_RIGID)
    bodies = {i: {k: getattr(r, k)[i] for k in ("com", "rot", "vel", "omega")}
              for i in torch.nonzero(moving).flatten().tolist()}
    return dict(pos=p.pos, vel=p.vel, density=p.density,
                alpha=new.dfsph_alpha, rest_volume=p.rest_volume,
                mass=p.mass, material=p.material,
                solver_iters=int(diag["solver_iters"]),
                div_iters=int(diag["div_iters"]),
                object_id=p.object_id, bodies=bodies)

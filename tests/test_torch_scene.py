"""The port's scene loader and state bridge against the JAX package.

The same scene JSON must give bit-equal particle and rigid arrays in both
packages (all 17 files in data/scenes/), the bridge must carry a state
across row for row, and the scenes the port once refused load and step.
"""
import dataclasses
import os

import numpy as np
import pytest
import torch

from sph_project_tpu.scene import load_scene as jax_load_scene
from sph_project_tpu.utils.config import SimConfig as JaxSimConfig

from sph_project_tpu_torch import bridge
from sph_project_tpu_torch import sim as tsim
from sph_project_tpu_torch.core import state as tstate
from sph_project_tpu_torch.scene import load_scene as torch_load_scene
from sph_project_tpu_torch.utils.config import SimConfig as TorchSimConfig


def _warm_up_vector_math():
    """Run torch's CPU vector math once before JAX runs anything.

    In a process where XLA has already run, the first multi-threaded call of
    ``torch.sqrt`` on a large float32 tensor can return square roots off by
    about 1e-4 relative (in up to one process in three of the pass tests),
    which breaks the per-pass tolerance of the port's plain versions. Every port test imports this module before its first JAX
    computation."""
    x = torch.rand(1 << 18) + 0.5
    torch.sqrt(x)
    torch.pow(x, 7.0)


_warm_up_vector_math()
# One intra-op thread per test process. The suite runs in several worker
# processes at once, and torch's CPU thread pool, oversubscribed by them,
# spins: a CPU step of the small domain-box scene (IISPH, slab-window engine)
# took 0.1-0.3 s alone and 23-84 s with six such processes of 8 threads
# each, 0.3-1.4 s with six of one thread. Every port test imports this module.
torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCENES = os.path.join(ROOT, "data", "scenes")

# the fields the port's params leave at their defaults: the JAX loader sizes
# its TPU pair engines' window caps per scene, the port's engine has none
TPU_SIZING = {"pair_slab", "pair_slab_big", "pair_dma_su"}


def box_config(method="dfsph"):
    """A small DFSPH scene with domain-box walls: a 0.1^3 fluid block thrown
    onto the floor of a 0.3^3 box, so the correctors work within 20 steps."""
    return {
        "Configuration": {
            "domainStart": [0, 0, 0], "domainEnd": [0.3, 0.3, 0.3],
            "addDomainBox": True, "particleRadius": 0.01, "density0": 1000,
            "gravitation": [0, -9.81, 0], "simulationMethod": method,
            "viscosityMethod": "standard", "timeStepSize": 1e-3,
            "viscosity": 0.05, "viscosity_b": 0.03},
        "FluidBlocks": [{"objectId": 0, "start": [0.1, 0.08, 0.1],
                         "end": [0.2, 0.18, 0.2], "translation": [0, 0, 0],
                         "scale": [1, 1, 1], "velocity": [0.0, -2.5, 0.0],
                         "density": 1000.0, "color": [50, 100, 200],
                         "entryTime": -1.0}]}


def load_both(config: dict, port_kw: dict | None = None, **jax_kw):
    """(jax scene, jax state, torch scene, torch state) of one config.
    ``jax_kw`` are parameter overrides for the JAX loader, ``port_kw`` for
    the port's."""
    js, jst = jax_load_scene(config=JaxSimConfig(config=config), **jax_kw)
    ts, tst = torch_load_scene(config=TorchSimConfig(config=config),
                               **(port_kw or {}))
    return js, jst, ts, tst


def flatten_jax_state(state) -> dict:
    """The JAX state as the flat numpy dict ``bridge.state_from_numpy``
    takes."""
    out = {}
    for f in dataclasses.fields(tstate.ParticleState):
        out[f"particles.{f.name}"] = np.asarray(getattr(state.particles, f.name))
    for f in dataclasses.fields(tstate.RigidState):
        out[f"rigid.{f.name}"] = np.asarray(getattr(state.rigid, f.name))
    for f in dataclasses.fields(tstate.SimState):
        if f.name not in ("particles", "rigid", "cached_neighbors"):
            out[f.name] = np.asarray(getattr(state, f.name))
    return out


def _scene_config(name):
    return TorchSimConfig(os.path.join(SCENES, name)).config


def three_cubes_config(cube_obj: str) -> dict:
    """tests/test_rigid.py's three-box squeeze: three dynamic cubes."""
    from test_rigid import base_cfg, rigid_body
    return {"Configuration": base_cfg(gravity=(0, 0, 0)),
            "RigidBodies": [
                rigid_body(0, cube_obj, (0.17, 0.3, 0.3), vel=(0.8, 0, 0)),
                rigid_body(1, cube_obj, (0.30, 0.3, 0.3)),
                rigid_body(2, cube_obj, (0.43, 0.3, 0.3), vel=(-0.8, 0, 0))]}


# high_viscosity_bunny: an OBJ fluid body and a static OBJ rigid body, filled
# by the port's numpy inside test (the JAX package may use its C++ helper);
# dragon_bath_dfsph (two dynamic dragons in their Euler-XYZ poses, 589,824
# slots), coupling_dfsph (a duck and two spheres), coupling_nine_rigid (nine
# dynamic bodies, 1,094,656 slots) and the three cubes: dynamic bodies
# sampled in their own frames, their body table (mass, com, rotation,
# velocity) and the contact channels
_DYNAMIC_SCENES = ("dragon_bath_dfsph.json", "coupling_dfsph.json",
                   "coupling_nine_rigid.json", "three_cubes")


# high_viscosity_implicit: implicit viscosity; the two small emitter scenes:
# gravitationUpper (the emitter height), a static OBJ body and the walls
_VISCOUS_SCENES = ("high_viscosity_implicit.json",
                   "buckling_emitter_small.json", "coiling_emitter_small.json")


# pbf_2d (2D, poly6) and pbf_3d: the PBF scenes; the full-size ones, loaded
# in 5-13 s each: the flagship (1,972,224 slots), the other three
# dragon_bath methods, and the two emitter scenes (2,288,640 and 1,948,672)
_FULL_SIZE_SCENES = ("large_scale_dfsph.json", "dragon_bath_wcsph.json",
                     "dragon_bath_pcisph.json", "dragon_bath_iisph.json",
                     "buckling_emitter.json", "coiling_emitter.json")


@pytest.mark.parametrize("name", ["smoke_test.json", "dam_break_demo.json",
                                  "high_viscosity_bunny.json", "box",
                                  *_DYNAMIC_SCENES, *_VISCOUS_SCENES,
                                  "pbf_2d.json", "pbf_3d.json",
                                  *_FULL_SIZE_SCENES])
def test_load_scene_bit_equal(name, tmp_path):
    if name == "box":
        config = box_config()
    elif name == "three_cubes":
        from test_rigid import write_cube_obj
        config = three_cubes_config(write_cube_obj(str(tmp_path / "cube.obj")))
    else:
        config = _scene_config(name)
    js, jst, ts, tst = load_both(config)
    a = flatten_jax_state(jst)
    b = bridge.state_to_numpy(tst)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    jp, tp = dataclasses.asdict(js.params), dataclasses.asdict(ts.params)
    for k in jp:
        if k not in TPU_SIZING:
            assert jp[k] == tp[k], k
    assert [o.particle_num for o in js.objects] == \
        [o.particle_num for o in ts.objects]
    if name in _DYNAMIC_SCENES or name.startswith("dragon_bath"):
        assert ts.params.has_dynamic_rigid and ts.params.contact_channels
        assert callable(tsim.get_step_fn(ts.params))   # the step is ported
        dyn = (b["particles.is_dynamic"] > 0) & (b["particles.material"] == 2)
        assert dyn.sum() > 0 and (b["rigid.mass"][
            list(ts.params.contact_channels)] > 0).all()
    if name in _VISCOUS_SCENES or "emitter" in name:
        assert ts.params.viscosity_method == "implicit"
        assert ts.params.has_entries == ("emitter" in name)
        assert callable(tsim.get_step_fn(ts.params))   # the step is ported


def test_box_scene_has_walls():
    _, _, ts, tst = load_both(box_config())
    mat = tst.particles.material.numpy()
    assert ts.params.has_rigid and not ts.params.has_dynamic_rigid
    assert (mat == 1).sum() == 125 and (mat == 2).sum() > 0


def test_bridge_round_trip():
    js, jst, ts, _ = load_both(box_config())
    flat = flatten_jax_state(jst)
    st = bridge.state_from_numpy(flat, ts.params)
    back = bridge.state_to_numpy(st)
    for k in flat:
        assert back[k].dtype == flat[k].dtype, k
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    moved = st.to("cpu").replace(t=st.t + 1)
    assert float(moved.t) == 1.0 and float(st.t) == 0.0


def test_bridge_round_trip_rigid(tmp_path):
    """The bridge carries dynamic bodies row for row: their rest positions
    and the body table (pose, velocity, mass, flags) of the JAX state."""
    from test_rigid import write_cube_obj
    cfg = three_cubes_config(write_cube_obj(str(tmp_path / "cube.obj")))
    js, jst, ts, _ = load_both(cfg)
    flat = flatten_jax_state(jst)
    back = bridge.state_to_numpy(bridge.state_from_numpy(flat, ts.params))
    for k in flat:
        np.testing.assert_array_equal(back[k], flat[k], err_msg=k)
    assert (flat["rigid.is_dynamic"][:3] == 1).all()
    assert np.abs(flat["particles.rigid_rest_pos"]).max() > 0


def test_bridge_rejects_wrong_size():
    _, jst, ts, _ = load_both(box_config())
    flat = flatten_jax_state(jst)
    flat["particles.pos"] = flat["particles.pos"][:-1]
    with pytest.raises(ValueError):
        bridge.state_from_numpy(flat, ts.params)


# dynamic rigid bodies under the shape-matching solver (A.11b) and an emitter
# scene under PBF with its implicit viscosity (A.9c) raised until the port
# ran them; they now load, build on the CPU and take a step (the ids name
# the queue items the scenes waited on when these cases were written)
@pytest.mark.parametrize("name", [
    pytest.param("coupling_dfsph.json", id="coupling_dfsph.json-A.11"),
    pytest.param("buckling_emitter_small.json",
                 id="buckling_emitter_small.json-A.12")])
def test_unported_scenes_raise(name):
    overrides = {"coupling_dfsph.json": dict(rigid_solver="shape_matching"),
                 "buckling_emitter_small.json": dict(simulation_method="pbf")}
    scene, state = torch_load_scene(os.path.join(SCENES, name),
                                    **overrides[name])
    params = scene.params
    for k, v in overrides[name].items():
        assert getattr(params, k) == v
    sim = tsim.Simulation(scene, state, device="cpu")
    diag = sim.step()
    p = sim.state.particles
    assert bool(torch.isfinite(p.pos).all()) and int(diag["fluid_num"]) > 0
    if name == "coupling_dfsph.json":
        # the shape-matching projection moved the dynamic bodies
        assert params.has_dynamic_rigid
        bodies = list(params.contact_channels)
        assert not torch.equal(sim.state.rigid.com[bodies],
                               state.rigid.com[bodies])
    else:
        assert params.viscosity_method == "implicit" and params.has_entries

"""The port stands alone: it imports neither JAX nor the JAX package, and it
does not quietly fall back to the CPU."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "sph_project_tpu_torch")

# a fresh interpreter: load a small scene, run one CPU step (each ported
# method under the cell-list engine, or DFSPH warm under the slab-window
# engine), then list any module of JAX or of the JAX package that got
# imported along the way
_PROBE = """
import sys
from sph_project_tpu_torch.scene import load_scene
from sph_project_tpu_torch.sim import Simulation
scene, state = load_scene("data/scenes/smoke_test.json", **%r)
sim = Simulation(scene, state, device="cpu")
assert type(sim.state.cached_neighbors).__name__ == %r
diag = sim.step()
assert int(diag["neighbor_overflow"]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "sph_project_tpu"))
print("FOREIGN", bad)
"""


def _probe(overrides, env_type):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"   # as the test processes (test_torch_scene)
    out = subprocess.run([sys.executable, "-c",
                          _PROBE % (overrides, env_type)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "FOREIGN []" in out.stdout, out.stdout


@pytest.mark.parametrize("method", ["dfsph", "wcsph", "pcisph", "iisph"])
def test_port_imports_no_jax(method):
    _probe(dict(simulation_method=method), "PairEnv")


def test_port_imports_no_jax_warm_slab():
    _probe(dict(simulation_method="dfsph", pair_backend="pallas",
                dfsph_warm_start=True, dfsph_warm_start_div=True), "SlabEnv")


# the same on a small scene with a dynamic body (cube falling into a pool in
# the domain box): the integrator, the contact pass and the wrenches run
_PROBE_RIGID = """
import sys
from sph_project_tpu_torch.scene import load_scene
from sph_project_tpu_torch.sim import Simulation
from sph_project_tpu_torch.utils.config import SimConfig
scene, state = load_scene(config=SimConfig(config=%r))
assert scene.params.has_dynamic_rigid and scene.params.contact_channels
sim = Simulation(scene, state, device="cpu")
assert type(sim.state.cached_neighbors).__name__ == "PairEnv"
com0 = sim.state.rigid.com[1].clone()
diag = sim.step()
assert not bool((sim.state.rigid.com[1] == com0).all())
assert "sph_project_tpu_torch.rigid.integrator" in sys.modules
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "sph_project_tpu"))
print("FOREIGN", bad)
"""


def test_port_imports_no_jax_rigid(tmp_path):
    cube = tmp_path / "cube.obj"
    h = 0.03
    with open(cube, "w") as f:
        for x in (-h, h):
            for y in (-h, h):
                for z in (-h, h):
                    f.write(f"v {x} {y} {z}\n")
        for q in ((1, 2, 4, 3), (5, 7, 8, 6), (1, 5, 6, 2), (3, 4, 8, 7),
                  (1, 3, 7, 5), (2, 6, 8, 4)):
            f.write("f " + " ".join(map(str, q)) + "\n")
    config = {
        "Configuration": {
            "domainStart": [0, 0, 0], "domainEnd": [0.3, 0.3, 0.3],
            "addDomainBox": True, "particleRadius": 0.01, "density0": 1000,
            "gravitation": [0, -9.81, 0], "simulationMethod": "dfsph",
            "viscosityMethod": "standard", "timeStepSize": 1e-3,
            "viscosity": 0.05, "viscosity_b": 0.03},
        "FluidBlocks": [{"objectId": 0, "start": [0.08, 0.08, 0.08],
                         "end": [0.22, 0.13, 0.22], "velocity": [0, 0, 0]}],
        "RigidBodies": [{"objectId": 1, "geometryFile": str(cube),
                         "translation": [0.15, 0.175, 0.15],
                         "velocity": [0, -1.5, 0], "density": 500.0,
                         "isDynamic": True}]}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", _PROBE_RIGID % (config,)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "FOREIGN []" in out.stdout, out.stdout


# (the ids name the features the cases probed when they were written:
# implicit viscosity runs since A.10, and a 2D scene with it still raises)
@pytest.mark.parametrize("scene,overrides,item", [
    ("smoke_test.json", dict(simulation_method="pbf"), "A.9b"),
    ("pbf_2d.json", dict(simulation_method="dfsph",
                         viscosity_method="implicit"), "A.9b"),
    ("dragon_bath_wcsph.json", dict(rigid_solver="shape_matching"), "A.11b"),
], ids=["pbf", "implicit_viscosity", "dynamic_rigid"])
def test_unported_features_raise(scene, overrides, item):
    """What the port does not run yet raises, naming its ROADMAP item, when
    the scene is loaded or the simulation built, before any step."""
    from sph_project_tpu_torch.scene import load_scene
    from sph_project_tpu_torch.sim import Simulation
    with pytest.raises(NotImplementedError, match=item):
        sc, st = load_scene(os.path.join(ROOT, "data", "scenes", scene),
                            **overrides)
        Simulation(sc, st, device="cpu")


# an implicit-viscosity emitter: a fluid column falling through the emitter
# height in the domain box; its placeholders turn fluid within the steps
_PROBE_EMITTER = """
import sys
from sph_project_tpu_torch.scene import load_scene
from sph_project_tpu_torch.sim import Simulation
from sph_project_tpu_torch.utils.config import SimConfig
scene, state = load_scene(config=SimConfig(config=%r))
assert scene.params.has_entries and scene.params.viscosity_method == "implicit"
sim = Simulation(scene, state, device="cpu")
n0 = int(sim.step()["fluid_num"])
n1 = max(int(sim.step()["fluid_num"]) for _ in range(15))
assert n1 > n0, (n0, n1)
assert "sph_project_tpu_torch.solvers.viscosity_cg" in sys.modules
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "sph_project_tpu"))
print("FOREIGN", bad)
"""


def test_port_imports_no_jax_implicit_emitter():
    config = {
        "Configuration": {
            "domainStart": [0, 0, 0], "domainEnd": [0.4, 0.4, 0.4],
            "addDomainBox": True, "particleRadius": 0.01, "density0": 1000,
            "gravitation": [0, -9.81, 0], "simulationMethod": "dfsph",
            "viscosityMethod": "implicit", "timeStepSize": 1e-3,
            "viscosity": 50.0, "gravitationUpper": 0.2},
        "FluidBlocks": [{"objectId": 0, "start": [0.14, 0.08, 0.14],
                         "end": [0.26, 0.34, 0.26], "velocity": [0, -2.0, 0]}]}
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", _PROBE_EMITTER % (config,)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "FOREIGN []" in out.stdout, out.stdout


def test_port_sources_name_no_jax():
    """No source line of the port imports JAX or the JAX package, not even
    behind a branch the probe above does not reach."""
    bad = []
    for dirpath, _, files in os.walk(PKG):
        for name in files:
            if not name.endswith(".py"):
                continue
            path = os.path.join(dirpath, name)
            with open(path) as f:
                for n, line in enumerate(f, 1):
                    words = line.split()
                    if words[:1] in (["import"], ["from"]) and len(words) > 1:
                        root = words[1].split(".")[0]
                        if root in ("jax", "jaxlib", "flax", "sph_project_tpu"):
                            bad.append(f"{path}:{n}: {line.strip()}")
    assert not bad, "\n".join(bad)


def test_simulation_defaults_to_cuda():
    """Without a device argument the simulation runs on the card; on a host
    without one it raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from sph_project_tpu_torch.scene import load_scene
    from sph_project_tpu_torch.sim import Simulation
    scene, state = load_scene(os.path.join(ROOT, "data", "scenes",
                                            "smoke_test.json"),
                              simulation_method="dfsph")
    with pytest.raises(RuntimeError, match="CUDA"):
        Simulation(scene, state)

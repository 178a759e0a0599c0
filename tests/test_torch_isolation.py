"""The port stands alone: it imports neither JAX nor the JAX package, and it
does not quietly fall back to the CPU."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "sph_project_tpu_torch")

# a fresh interpreter: load a small scene, run one CPU step and two through
# ``run`` (each ported method under the cell-list engine, or DFSPH warm
# under the slab-window engine; the loops through ops/graph_loop.py), then
# list any module of JAX or of the JAX package that got imported along the
# way
_PROBE = """
import sys
from sph_project_tpu_torch.scene import load_scene
from sph_project_tpu_torch.sim import Simulation
scene, state = load_scene("data/scenes/smoke_test.json", **%r)
sim = Simulation(scene, state, device="cpu")
assert type(sim.state.cached_neighbors).__name__ == %r
diag = sim.step()
assert int(diag["neighbor_overflow"]) == 0
assert sim.run(2)["fluid_num"].shape == (2,)
assert int(sim.state.step_count) == 3
assert "sph_project_tpu_torch.ops.graph_loop" in sys.modules
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
# the domain box): the integrator, the contact pass and the wrenches run;
# then the same scene under the shape-matching backend (its DEM pass and
# its projection)
_PROBE_RIGID = """
import sys
from sph_project_tpu_torch.scene import load_scene
from sph_project_tpu_torch.sim import Simulation
from sph_project_tpu_torch.utils.config import SimConfig
for solver in ("integrator", "shape_matching"):
    scene, state = load_scene(config=SimConfig(config=%r),
                              rigid_solver=solver)
    assert scene.params.has_dynamic_rigid and scene.params.contact_channels
    sim = Simulation(scene, state, device="cpu")
    assert type(sim.state.cached_neighbors).__name__ == "PairEnv"
    com0 = sim.state.rigid.com[1].clone()
    diag = sim.step()
    assert not bool((sim.state.rigid.com[1] == com0).all())
assert "sph_project_tpu_torch.rigid.integrator" in sys.modules
assert "sph_project_tpu_torch.rigid.shape_matching" in sys.modules
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


# (the ids name the features the cases probed when they were written: they
# raised until the port ran them; PBF with implicit viscosity, DFSPH in 2D
# under poly6 with implicit viscosity, and the shape-matching backend on a
# shipped coupled scene now run)
@pytest.mark.parametrize("scene,overrides", [
    ("smoke_test.json", dict(simulation_method="pbf",
                             viscosity_method="implicit")),
    ("pbf_2d.json", dict(simulation_method="dfsph",
                         viscosity_method="implicit")),
    ("dragon_bath_wcsph.json", dict(rigid_solver="shape_matching")),
], ids=["pbf", "implicit_viscosity", "dynamic_rigid"])
def test_unported_features_raise(scene, overrides):
    """What the port once refused loads, builds on the CPU and steps: the
    scene with its overrides, one step with finite positions and the
    diagnostics of the JAX package's keys."""
    from sph_project_tpu_torch.scene import load_scene
    from sph_project_tpu_torch.sim import Simulation
    sc, st = load_scene(os.path.join(ROOT, "data", "scenes", scene),
                        **overrides)
    for k, v in overrides.items():
        assert getattr(sc.params, k) == v
    sim = Simulation(sc, st, device="cpu")
    diag = sim.step()
    p = sim.state.particles
    assert bool(torch.isfinite(p.pos).all())
    assert int(diag["neighbor_overflow"]) == 0 and int(diag["fluid_num"]) > 0
    assert int(sim.state.step_count) == 1


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


# the CLI driver end to end in a fresh interpreter: the root script on the
# smoke scene with frames, telemetry and checkpoints, a resumed run, and the
# viewer and renderer modules imported
_PROBE_CLI = """
import runpy, sys
out = sys.argv[1]
args = ["run_simulation_torch.py", "--scene_file", "data/scenes/smoke_test.json",
        "--device", "cpu", "--quiet", "--output_dir", out,
        "--checkpoint_interval", "2", "--log_json", out + "/log.jsonl"]
sys.argv = args + ["--steps", "3"]
runpy.run_path("run_simulation_torch.py", run_name="__main__")
sys.argv = args + ["--steps", "5", "--resume", out + "/ckpt"]
runpy.run_path("run_simulation_torch.py", run_name="__main__")
import sph_project_tpu_torch.io.viewer, sph_project_tpu_torch.io.render3d
for m in ("cli", "io.checkpoint", "io.exporters", "utils.telemetry"):
    assert "sph_project_tpu_torch." + m in sys.modules, m
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "sph_project_tpu"))
print("FOREIGN", bad)
"""


def test_cli_imports_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", _PROBE_CLI, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "resumed from" in out.stdout and "at step 3" in out.stdout
    assert "FOREIGN []" in out.stdout, out.stdout
    assert os.path.exists(tmp_path / "000000" / "raw_view.png")


def test_root_scripts_name_no_jax():
    """Neither the port's root scripts (the CLI, the offline pipeline's
    surfacing, rendering and device listing) nor its smoke run imports JAX
    or the JAX package, on any line."""
    bad = []
    for name in ("run_simulation_torch.py", "chip_smoke.py",
                 "surface_reconstruction_torch.py", "render_torch.py",
                 "blender_test_torch.py"):
        with open(os.path.join(ROOT, name)) as f:
            for n, line in enumerate(f, 1):
                words = line.split()
                if words[:1] in (["import"], ["from"]) and len(words) > 1:
                    if words[1].split(".")[0] in ("jax", "jaxlib", "flax",
                                                  "sph_project_tpu"):
                        bad.append(f"{name}:{n}: {line.strip()}")
    assert not bad, "\n".join(bad)


# the offline pipeline in a fresh interpreter: a tiny frame (a seeded cloud
# written by the port's exporter) surfaced and rendered through the port's
# root scripts' functions, and their device listing run
_PROBE_OFFLINE = """
import os, runpy, sys
import numpy as np
from sph_project_tpu_torch.io.exporters import write_ply
import render_torch, surface_reconstruction_torch
frame = os.path.join(sys.argv[1], "000000")
os.makedirs(frame)
rng = np.random.default_rng(0)
write_ply(os.path.join(frame, "particle_object_1.ply"),
          rng.uniform(0.4, 0.6, (400, 3)).astype(np.float32))
args = (frame, 0.01, 3.5, 0.45, 1.0, False)
assert surface_reconstruction_torch.process_frame(args) == (frame, None)
assert render_torch.render_frame((frame, (3.0, 2.0, 3.0), (0.5, 0.5, 0.5),
                                  50.0, (32, 32), "preview", "scene.blend",
                                  "NONE", 0)) == (frame, None)
assert sorted(os.listdir(frame)) == ["particle_object_1.ply",
                                     "particle_object_1_surface.obj",
                                     "render.png"]
runpy.run_path("blender_test_torch.py")
for m in ("native", "geometry.mesh", "io.exporters", "io.render3d"):
    assert "sph_project_tpu_torch." + m in sys.modules, m
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "sph_project_tpu"))
print("FOREIGN", bad)
"""


def test_offline_pipeline_imports_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", _PROBE_OFFLINE,
                          str(tmp_path)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "torch.cuda devices:" in out.stdout, out.stdout
    assert "FOREIGN []" in out.stdout, out.stdout


# the spatial decomposition in two spawned ranks (gloo over the CPU): one
# step of the smoke scene under DFSPH; each rank lists the foreign modules
# it loaded, and so does the parent that started them
_PROBE_SPATIAL = """
import os, sys
from sph_project_tpu_torch.parallel import launch
run = sys.argv[1]
case = dict(name="smoke", scene="data/scenes/smoke_test.json",
            overrides=dict(simulation_method="dfsph"), steps=1)
launch.launch("sph_project_tpu_torch.parallel.launch:run_cases", 2,
              dict(cases=[case], out_dir=os.path.join(run, "out")), run,
              device="cpu")
res = launch.gather_results(os.path.join(run, "out"), "smoke", 2)
for r in res["ranks"]:
    assert r["diags"][0]["neighbor_overflow"] == 0 and r["backend"] == "gloo"
    print("RANK FOREIGN", r["foreign"])
print("FOREIGN", launch.foreign_modules())
"""


def test_spatial_ranks_import_no_jax(tmp_path):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    out = subprocess.run([sys.executable, "-c", _PROBE_SPATIAL, str(tmp_path)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert out.stdout.count("RANK FOREIGN []") == 2, out.stdout
    assert "\nFOREIGN []" in out.stdout, out.stdout


def test_mesh_defaults_to_cuda(tmp_path):
    """The multi-device mesh and launcher, like the simulation, target the
    card unless asked otherwise; on a host without one they raise, before
    any rank starts."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    from sph_project_tpu_torch.parallel import launch, spatial
    with pytest.raises(RuntimeError, match="CUDA"):
        spatial.make_mesh()
    run = str(tmp_path / "run")
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.launch("sph_project_tpu_torch.parallel.launch:run_cases", 2,
                      dict(cases=[], out_dir=run), run)
    assert not os.path.exists(run)
    with pytest.raises(RuntimeError, match="CUDA"):
        launch.run_probes(0, 1, [], run)

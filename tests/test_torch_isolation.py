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


@pytest.mark.parametrize("scene,overrides,item", [
    ("smoke_test.json", dict(simulation_method="pbf"), "A.9b"),
    ("smoke_test.json", dict(viscosity_method="implicit"), "A.10"),
    ("dragon_bath_wcsph.json", {}, "A.11"),
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

"""The port stands alone: it imports neither JAX nor the JAX package, and it
does not quietly fall back to the CPU."""
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "sph_project_tpu_torch")

# a fresh interpreter: load a small scene, run one CPU step (cold under the
# cell-list engine, or warm under the slab-window engine), then list any
# module of JAX or of the JAX package that got imported along the way
_PROBE = """
import sys
from sph_project_tpu_torch.scene import load_scene
from sph_project_tpu_torch.sim import Simulation
scene, state = load_scene("data/scenes/smoke_test.json",
                          simulation_method="dfsph", **%r)
sim = Simulation(scene, state, device="cpu")
assert type(sim.state.cached_neighbors).__name__ == %r
diag = sim.step()
assert int(diag["neighbor_overflow"]) == 0
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax", "sph_project_tpu"))
print("FOREIGN", bad)
"""


def test_port_imports_no_jax(overrides={}, env_type="PairEnv"):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c",
                          _PROBE % (overrides, env_type)], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    assert "FOREIGN []" in out.stdout, out.stdout


def test_port_imports_no_jax_warm_slab():
    test_port_imports_no_jax(dict(pair_backend="pallas", dfsph_warm_start=True,
                                  dfsph_warm_start_div=True), "SlabEnv")


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

"""Whole runs of a small cell on the CPU, through ``harness.run_cell``.

The cell is added the way a later change adds one: a copy of the benchmark
with new files alone (a configuration, a traffic mix, the cell's limits, a
per-layer metric) and new entries in the manifest; no file of the copy is
edited. The cell is a small dam break in a domain box, under the limits of
``flagship_dfsph.opening``. Sound, its run comes out correct; with the
timed step broken underneath (the state left unchanged, half of the rows
left out, one answer altered), or with the bfloat16 control in the
program's place, it does not.
"""
import json
import os
import shutil
import time

import pytest
import torch

import check
import control
import harness
from conftest import BENCH, ROOT

CELL = "tiny_dfsph.tiny_mix"


def tiny_config() -> dict:
    with open(os.path.join(BENCH, "configs", "flagship_dfsph.json")) as f:
        cfg = json.load(f)
    sc = cfg["scene"]
    sc["Configuration"]["domainEnd"] = [0.6, 0.6, 0.3]
    sc["FluidBlocks"][0]["start"] = [0.09, 0.09, 0.09]
    sc["FluidBlocks"][0]["end"] = [0.27, 0.37, 0.21]
    cfg["source"] = "https://github.com/jason-huang03/SPH_Project"
    return cfg


@pytest.fixture(scope="module")
def extended(tmp_path_factory):
    """A checkout root whose benchmark holds one more configuration, mix,
    metric and cell, added as files and manifest entries only."""
    root = tmp_path_factory.mktemp("checkout")
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    (bench / "configs" / "tiny_dfsph.json").write_text(
        json.dumps(tiny_config()))
    (bench / "traffic" / "tiny_mix.json").write_text(json.dumps(
        {"start_s": 0.006, "segment_steps": 4, "jitter_spacing": 0.01}))
    with open(bench / "checks" / "flagship_dfsph.opening.json") as f:
        limits = json.load(f)
    # the mix starts after the first steps: no start to hold to the input
    del limits["limits"]["start_breaks"]
    (bench / "checks" / f"{CELL}.json").write_text(json.dumps(limits))
    (bench / "metrics" / "steps_traced.py").write_text(
        '"""Steps of the traced segment."""\n\n\n'
        'def read(rec):\n    return float(rec["steps"])\n')
    man["configs"].append({"name": "tiny_dfsph", "source":
                           "https://github.com/jason-huang03/SPH_Project",
                           "file": "benchmark/configs/tiny_dfsph.json",
                           "reduced": ["domainEnd", "FluidBlocks"],
                           "why": "a small dam break for the CPU tests"})
    man["workloads"].append({"name": CELL, "config": "tiny_dfsph",
                             "traffic": "tiny_mix", "chips": 1,
                             "why": "a small dam break for the CPU tests"})
    man["per_layer"].append({"name": "steps_traced", "unit": "steps",
                             "better": "higher", "source": "program_counter",
                             "layer": "Solver", "moves": "step_ms",
                             "workloads": [CELL]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
    return root


def run(root, wrap=None, seed=2 ** 33 + 7):
    return harness.run_cell(str(root), CELL, seed, 0.3, False,
                            time.perf_counter(), device="cpu", wrap=wrap,
                            bench_dir=str(root / "benchmark"))


def test_added_cell_runs_correct(extended):
    out = run(extended)
    assert out["correct"], out["checks"]
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"step_ms", "step_p95_ms", "mem_gib",
                                   "setup_s"}
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}


def test_traced_run(extended):
    """A traced run on the CPU: the same checks, and the per-layer metrics
    the cell lists (only the added one)."""
    out = harness.run_cell(str(extended), CELL, 5, 0.2, True,
                           time.perf_counter(), device="cpu",
                           bench_dir=str(extended / "benchmark"))
    assert out["correct"], out["checks"]
    assert list(out) == ["correct", "attempted", "failed", "metrics",
                         "device", "breakdown", "checks"]
    assert out["metrics"] == {"steps_traced": {"value": 4.0,
                                               "unit": "steps"}}
    assert set(out["breakdown"]) == {"device_ops", "idle_gaps"}


def test_added_metric_is_found(extended):
    spec = harness.load_cell(str(extended), CELL,
                             str(extended / "benchmark"))
    names = [m["name"] for m in spec["per_layer"]]
    assert "steps_traced" in names and "cg_iters" not in names
    read = harness.metric_reader(spec["bench_dir"], "steps_traced")
    assert read({"steps": 4}) == 4.0


@pytest.mark.parametrize("viscosity, words", [("standard", 16),
                                               ("implicit", 19)])
def test_gather_words_of_the_state(viscosity, words):
    """By hand: position, velocity and the rigid rest position 3 words
    each; mass, volume, density, material, object id and the dynamic flag
    1 each; the cell id 1; under implicit viscosity its warm start, 3
    more."""
    from sph_project_tpu_torch.scene import load_scene
    from sph_project_tpu_torch.utils.config import SimConfig
    cfg = tiny_config()
    cfg["scene"]["Configuration"]["viscosityMethod"] = viscosity
    scene, state = load_scene(config=SimConfig(config=cfg["scene"]),
                              **cfg["constants"], **cfg["overrides"])
    assert harness.gather_words(state, scene.params) == words


class Broken:
    """The simulation with its step broken after it ran: ``fault`` is
    ``unchanged`` (the state before the step written back), ``half`` (the
    second half of the rows keep their values from before the step) or
    ``altered`` (one fluid row's velocity changed)."""

    def __init__(self, sim, fault):
        self.sim, self.fault = sim, fault

    @property
    def state(self):
        return self.sim.state

    @state.setter
    def state(self, value):
        self.sim.state = value

    def step(self):
        before = harness.clone_tree(self.sim.state)
        diag = self.sim.step()
        st = self.sim.state
        p = st.particles
        if self.fault == "unchanged":
            self.sim.state = before
        elif self.fault == "half":
            half = int((p.material != 0).sum()) // 2
            pos, vel = p.pos.clone(), p.vel.clone()
            pos[half:] = before.particles.pos[half:]
            vel[half:] = before.particles.vel[half:]
            self.sim.state = st.replace(particles=p.replace(pos=pos,
                                                            vel=vel))
        elif self.fault == "altered":
            row = int(torch.nonzero(p.material == 1)[0])
            vel = p.vel.clone()
            vel[row, 0] += 0.5
            self.sim.state = st.replace(particles=p.replace(vel=vel))
        return diag


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
def test_broken_step_is_not_correct(extended, fault):
    out = run(extended, wrap=lambda sim: Broken(sim, fault))
    assert not out["correct"], out["checks"]


def test_control_is_not_correct(extended):
    spec = harness.load_cell(str(extended), CELL,
                             str(extended / "benchmark"))
    cell = harness.Cell(spec, 11, "cpu")
    cell.setup(time.perf_counter(), False)
    cell.window(0.2)
    cell.free()
    assert harness.judged(cell.reference_check(), spec["limits"])[0]
    nums = check.compare(control.control_step(cell.start_state(), cell.ph,
                                              cell.ref_mod),
                         cell.reference(), cell.ph)
    limits = {k: v for k, v in spec["limits"].items() if k in nums}
    assert limits.keys() >= {"pos_gap", "vel_gap", "rho_gap", "alpha_gap"}
    assert not harness.judged(nums, limits)[0], nums

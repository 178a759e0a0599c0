"""A configuration whose bodies move, added as new files and manifest entries
alone, as a later change would add one; and the path without bodies left as
it was.

The cell: two dynamic spheres (``data/models_builtin/sphere.obj`` at a
quarter of its size, radius 5 cm) falling into a small pool, under limits
that name the six body numbers, with ``port_reference.py`` as its reference
(copied into the copy's ``reference/``: it imports the program, so it is a
test's stand-in and no yardstick). Sound, its run comes out correct with the
segments repeating; with the timed step broken underneath, each fault fails
on its own number: a body and its rows moved by a tenth of a diameter, a
body turned by 0.01 rad, two bodies' object ids swapped, the bodies left
unrestored between segments. Without bodies the window holds, and
``check.compare`` yields, exactly what they did before bodies were held; a
limit on a body number then fails. And the rigid pair bodies are counted:
their names, their bytes and operations by hand, the roofline reader on
them.
"""
import json
import math
import os
import shutil
import time

import pytest
import torch

import bench_trace
import check
import counts
import harness
from conftest import BENCH, ROOT
from test_harness_run import extended  # noqa: F401

CELL = "tiny_coupled.coupled_mix"
BODY_LIMITS = {"object_breaks": 0, "rigid_pos_gap": 0.01,
               "body_pos_gap": 0.01, "body_rot_gap": 0.001,
               "body_vel_gap": 0.01, "body_omega_gap": 0.01}
# the fields the window held and the numbers compare yielded before bodies
# were held
HELD = {"pos", "vel", "density", "rest_volume", "mass", "material", "alpha"}
COMPARED = {"match_breaks", "order_breaks", "pos_gap", "vel_gap", "rho_gap",
            "volume_gap", "iters_gap", "alpha_gap"}


def sphere(oid, x):
    return {"objectId": oid, "geometryFile": "./data/models/sphere.obj",
            "translation": [x, 0.33, 0.15], "rotationAxis": [0, 1, 0],
            "rotationAngle": 0.0, "scale": [0.25, 0.25, 0.25],
            "velocity": [0.0, -1.0, 0.0], "density": 500.0,
            "color": [255, 255, 255], "isDynamic": True, "entryTime": -1.0}


def coupled_config() -> dict:
    with open(os.path.join(BENCH, "configs", "flagship_dfsph.json")) as f:
        cfg = json.load(f)
    sc = cfg["scene"]
    sc["Configuration"]["domainEnd"] = [0.5, 0.5, 0.3]
    sc["FluidBlocks"][0].update(start=[0.09, 0.09, 0.09],
                                end=[0.41, 0.27, 0.21], velocity=[0, 0, 0])
    sc["RigidBodies"] = [sphere(1, 0.18), sphere(2, 0.32)]
    cfg["source"] = "https://github.com/jason-huang03/SPH_Project"
    cfg["reference"] = "port_step"
    return cfg


@pytest.fixture(scope="module")
def coupled(tmp_path_factory):
    """A checkout root whose benchmark holds the coupled configuration, its
    mix, limits and reference, added as files and manifest entries only."""
    root = tmp_path_factory.mktemp("checkout")
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    (bench / "configs" / "tiny_coupled.json").write_text(
        json.dumps(coupled_config()))
    (bench / "traffic" / "coupled_mix.json").write_text(json.dumps(
        {"start_s": 0.0018, "segment_steps": 4, "jitter_spacing": 0.01}))
    with open(bench / "checks" / "flagship_dfsph.settled.json") as f:
        limits = json.load(f)
    limits["limits"].update(BODY_LIMITS)
    (bench / "checks" / f"{CELL}.json").write_text(json.dumps(limits))
    shutil.copy(os.path.join(BENCH, "tests", "port_reference.py"),
                bench / "reference" / "port_step.py")
    man["configs"].append({"name": "tiny_coupled", "source":
                           "https://github.com/jason-huang03/SPH_Project",
                           "file": "benchmark/configs/tiny_coupled.json",
                           "reduced": ["domainEnd", "FluidBlocks",
                                       "RigidBodies"],
                           "why": "two spheres into a pool for the CPU tests"})
    man["workloads"].append({"name": CELL, "config": "tiny_coupled",
                             "traffic": "coupled_mix", "chips": 1,
                             "why": "two spheres into a pool for the CPU "
                                    "tests"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    for p, data in before.items():
        assert p.read_bytes() == data, f"{p} was edited"
    return root


def run(root, wrap=None, seed=2 ** 33 + 11):
    """A run long enough for two segments of four steps or more."""
    return harness.run_cell(str(root), CELL, seed, 2.5, False,
                            time.perf_counter(), device="cpu", wrap=wrap,
                            bench_dir=str(root / "benchmark"))


def test_coupled_cell_runs_correct(coupled):
    out = run(coupled)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 4
    assert out["checks"].keys() >= BODY_LIMITS.keys() | {"segment_breaks"}
    # the reference is the program's own step: every body number reads 0
    for k in BODY_LIMITS:
        assert out["checks"][k]["value"] == 0, k


def test_coupled_bodies_move_in_a_segment(coupled):
    spec = harness.load_cell(str(coupled), CELL, str(coupled / "benchmark"))
    cell = harness.Cell(spec, 3, "cpu")
    cell.setup(time.perf_counter(), False)
    assert cell.bodies
    cell.window(0.1)
    s0 = cell.start_state()
    held = cell.held
    assert held.keys() == HELD | {"object_id", "rigid"}
    assert set(s0["rigid"]) >= {"com", "rot", "vel", "omega", "present"}
    for k in ("object_id", "is_dynamic", "rigid_rest_pos", "t"):
        assert k in s0, k
    bodies = harness.bodies_of(held["rigid"])
    assert sorted(bodies) == [1, 2]
    for i in bodies:
        moved = bodies[i]["com"] - s0["rigid"]["com"][i]
        assert float(moved.norm()) > 0.0, i


class BodyFault:
    """The simulation with its bodies broken after each step: ``moved``
    (body 1 and its rows 0.1 diameter along x), ``turned`` (body 1 turned
    by 0.01 rad about y), ``swapped`` (the object ids of the rows of bodies
    1 and 2 exchanged) or ``unrestored`` (the bodies' state kept when the
    window writes the snapshot back)."""

    def __init__(self, sim, fault):
        self.sim, self.fault = sim, fault

    @property
    def state(self):
        return self.sim.state

    @state.setter
    def state(self, value):
        if self.fault == "unrestored":
            value = value.replace(rigid=self.sim.state.rigid)
        self.sim.state = value

    def step(self):
        diag = self.sim.step()
        st = self.sim.state
        p, r = st.particles, st.rigid
        if self.fault == "moved":
            d = 0.1 * self.sim.params.particle_diameter
            com, pos = r.com.clone(), p.pos.clone()
            com[1, 0] += d
            pos[p.object_id == 1, 0] += d
            st = st.replace(particles=p.replace(pos=pos),
                            rigid=r.replace(com=com))
        elif self.fault == "turned":
            c, s = math.cos(0.01), math.sin(0.01)
            turn = torch.tensor([[c, 0.0, s], [0.0, 1.0, 0.0], [-s, 0.0, c]],
                                dtype=r.rot.dtype)
            rot = r.rot.clone()
            rot[1] = turn @ rot[1]
            st = st.replace(rigid=r.replace(rot=rot))
        elif self.fault == "swapped":
            oid = p.object_id.clone()
            oid[p.object_id == 1] = 2
            oid[p.object_id == 2] = 1
            st = st.replace(particles=p.replace(object_id=oid))
        if self.fault != "unrestored":
            self.sim.state = st
        return diag


@pytest.mark.parametrize("fault, numbers", [
    ("moved", ("body_pos_gap", "rigid_pos_gap")),
    ("turned", ("body_rot_gap",)),
    ("swapped", ("object_breaks",)),
    ("unrestored", ("segment_breaks",))])
def test_broken_bodies_fail_on_their_number(coupled, fault, numbers):
    out = run(coupled, wrap=lambda sim: BodyFault(sim, fault))
    assert out["attempted"] > 4
    assert not out["correct"]
    for k in numbers:
        c = out["checks"][k]
        assert c["value"] > c["limit"], (k, c)
    if fault == "turned":
        assert out["checks"]["body_rot_gap"]["value"] == \
            pytest.approx(0.01, rel=1e-4)
    if fault == "moved":
        assert out["checks"]["body_pos_gap"]["value"] == \
            pytest.approx(0.1, rel=1e-4)


def test_without_bodies_nothing_more_is_held_or_compared(extended):
    spec = harness.load_cell(str(extended), "tiny_dfsph.tiny_mix",
                             str(extended / "benchmark"))
    cell = harness.Cell(spec, 7, "cpu")
    cell.setup(time.perf_counter(), False)
    assert not cell.bodies
    cell.window(0.2)
    cell.free()
    assert set(cell.held) == HELD
    ref = cell.reference()
    assert "bodies" not in ref and "object_id" not in ref
    nums = cell.reference_check()
    assert set(nums) == COMPARED | {"segment_breaks", "settle_failed",
                                    "failed"}
    ok, _ = harness.judged(nums, spec["limits"])
    assert ok
    # a limit on a body number fails where the reference returns no bodies
    for k, lim in BODY_LIMITS.items():
        ok, checks = harness.judged(nums, dict(spec["limits"], **{k: lim}))
        assert not ok and math.isnan(checks[k]["value"]), k


def test_rotation_angle():
    for axis, dim in ((2, 3), (None, 2)):
        for a in (1e-6, 0.01, 1.0, 3.0):
            c, s = math.cos(a), math.sin(a)
            if dim == 2:
                r = torch.tensor([[c, -s], [s, c]], dtype=torch.float64)
            else:
                r = torch.tensor([[c, -s, 0], [s, c, 0], [0, 0, 1]],
                                 dtype=torch.float64)
            eye = torch.eye(dim, dtype=torch.float64)
            assert float(check.rotation_angle(eye, r)) == \
                pytest.approx(a, rel=1e-9)
            assert float(check.rotation_angle(r, r)) == 0.0


FAM = bench_trace.Families(os.path.join(BENCH, "families.json"))


@pytest.mark.parametrize("name, body", [
    ("void pair_kernel<RigidVolume<Cubic, 3> >(PairArgs, int)",
     "rigid_volume"),
    ("void pair_kernel<RigidContact<12, Cubic, 3> >(PairArgs, int)",
     "rigid_contact"),
    ("void slab_kernel<RigidDem<Cubic, 3> >(PairArgs, int)", "rigid_dem"),
    ("void pair_kernel<CorrectionAt<true, 4, 3, Cubic, 3> >(PairArgs, int)",
     "correction+rigid"),
    ("void pair_kernel<CorrectionAt<false, 4, 3, Cubic, 3> >(PairArgs, int)",
     "correction"),
    ("void pair_kernel<NonpressureAt<true, 6, Cubic, 3> >(PairArgs, int)",
     "nonpressure+rigid"),
    ("void pair_kernel<NonpressureWarm<true, Cubic, 3> >(PairArgs, int)",
     "nonpressure_warm+rigid"),
    ("void pair_kernel<DensityAlphaDivergence<true, Cubic, 3> >(PairArgs, "
     "int)", "density_alpha_divergence+rigid"),
    ("void pair_kernel<DensityAlphaDivergence<false, Cubic, 3> >(PairArgs, "
     "int)", "density_alpha_divergence")])
def test_rigid_kernel_names_map_to_their_bodies(name, body):
    assert FAM.body(name) == body
    assert FAM(name) == f"pair:{body}"
    assert body in counts.BODIES


WORK = dict(pairs=1000, wall_pairs=100, rows_read=60, n=80, cells=9,
            dyn_pairs=200, same_pairs=150, touch_pairs=10, dyn_rows_read=30)
# the bytes every pass moves besides its fields and outputs: the cell ids
# (80 int32), the cell table (10 int32), the produce mask (80 bytes)
TABLES = 4 * 80 + 4 * 10 + 80


@pytest.mark.parametrize("body, n_bytes, n_ops", [
    # pos and object_id on the 30 rows a dynamic pass reads, one output;
    # the object compare on every pair, W and the sum on one object's pairs
    ("rigid_volume", 4 * 4 * 30 + TABLES + 4 * 80, 200 * (8 + 1) + 150 * 14),
    # pos, material, object_id; 1 + 3 outputs (one channel); 18 a touching
    # pair
    ("rigid_contact", 5 * 4 * 30 + TABLES + 4 * 4 * 80,
     200 * (8 + 1) + 10 * 18),
    # pos, vel, material, object_id; 3 outputs; 26 a touching pair
    ("rigid_dem", 8 * 4 * 30 + TABLES + 3 * 4 * 80, 200 * (8 + 1) + 10 * 26),
    # the correction and is_dynamic; 3 + 3 outputs; the fluid body's
    # operations on the producing rows' pairs
    ("correction+rigid", 8 * 4 * 60 + TABLES + 6 * 4 * 80, 1000 * (8 + 28)),
    ("density_alpha_divergence+rigid", 9 * 4 * 60 + TABLES + 8 * 4 * 80,
     1000 * (8 + 60)),
    ("nonpressure+rigid", 11 * 4 * 60 + TABLES + 9 * 4 * 80,
     1000 * (8 + 55)),
    ("nonpressure_warm+rigid", 13 * 4 * 60 + TABLES + 15 * 4 * 80,
     1000 * (8 + 71))])
def test_rigid_counts_by_hand(body, n_bytes, n_ops):
    assert counts.pair_work(body, WORK) == (n_bytes, n_ops)


def test_pair_roofline_reads_a_coupled_segment():
    """A segment that launches the rigid bodies and the +rigid instances
    reads a number; the same kernels without them read as before."""
    fluid = [("void pair_kernel<Density<Cubic, 3> >(PairArgs, int)", 0,
              400_000)]
    rigid = [("void pair_kernel<RigidVolume<Cubic, 3> >(PairArgs, int)",
              400_000, 450_000),
             ("void pair_kernel<RigidContact<4, Cubic, 3> >(PairArgs, int)",
              450_000, 500_000),
             ("void pair_kernel<CorrectionAt<true, 4, 3, Cubic, 3> >"
              "(PairArgs, int)", 500_000, 900_000)]
    read = harness.metric_reader(BENCH, "pair_roofline")
    rec = dict(families=FAM, work=WORK)
    got = read(dict(rec, kernels=fluid + rigid))
    bound = sum(counts.bound_s(*counts.pair_work(b, WORK)) for b in (
        "density", "rigid_volume", "rigid_contact", "correction+rigid"))
    assert got == pytest.approx(100 * bound / 0.9e-3)
    assert read(dict(rec, kernels=fluid)) == pytest.approx(
        100 * counts.bound_s(*counts.pair_work("density", WORK)) / 0.4e-3)

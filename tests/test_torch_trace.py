"""The program's spans and counters on the CPU (``ops/graph_loop.py``
``Trace``, ``Simulation(trace=...)``): every span of a traced step closes
and nests under ``step``; each loop's ticks equal the step's iteration
counts; a step with tracing off records nothing and computes what the
traced one does, bit for bit; the counting walk's plain version against a
brute-force count; the host spans on the profiler's timeline; the CLI's
``--trace_file`` and ``stage_ms``; the telemetry's running maximum.

The stamps themselves run only on the card: ``tests/test_torch_trace_card.py``
(marked ``cuda``) holds them there."""
import json

import pytest
import torch

from sph_project_tpu_torch import cli
from sph_project_tpu_torch import sim as tsim
from sph_project_tpu_torch.ops import graph_loop
from sph_project_tpu_torch.ops import pair_kernels as pk
from sph_project_tpu_torch.ops import pairs
from sph_project_tpu_torch.scene import load_scene
from sph_project_tpu_torch.solvers import viscosity_cg
from sph_project_tpu_torch.utils import telemetry
from sph_project_tpu_torch.utils.config import SimConfig

from test_torch_scene import box_config

torch.set_num_threads(1)
STEPS = 3
# (method, overrides, {loop: the diagnostic its ticks equal})
CASES = {
    "dfsph": ("dfsph", {}, {"dfsph.density": "solver_iters",
                            "dfsph.divergence": "div_iters"}),
    "pcisph": ("pcisph", {}, {"pcisph.pressure": "solver_iters"}),
    "iisph": ("iisph", {}, {"iisph.pressure": "solver_iters"}),
    "implicit": ("dfsph", dict(viscosity_method="implicit", viscosity=500.0,
                               viscosity_b=500.0),
                 {"dfsph.density": "solver_iters",
                  "dfsph.divergence": "div_iters",
                  "viscosity.cg": "cg_iters"}),
}


def _run(case, trace):
    """STEPS steps of ``case``: (diagnostics per step with the CG's count,
    the final state, the spans read once at the end)."""
    method, overrides, _ = CASES[case]
    scene, state = load_scene(config=SimConfig(config=box_config(method)),
                              **overrides)
    sim = tsim.Simulation(scene, state, device="cpu", trace=trace)
    diags = []
    for _ in range(STEPS):
        d = dict(sim.step())
        if "viscosity.cg" in CASES[case][2]:
            d["cg_iters"] = viscosity_cg.last_solve["cg_iters"].clone()
        diags.append(d)
    return diags, sim.state, sim.spans(), sim


@pytest.fixture(scope="module", params=list(CASES))
def traced(request):
    return request.param, _run(request.param, True)


def test_spans_close_and_nest_under_step(traced):
    case, (_, _, read, _) = traced
    spans = read["spans"]
    by_seq = {s.seq: s for s in spans}
    steps = [s for s in spans if s.name == "step"]
    assert [s.replay for s in steps] == list(range(1, STEPS + 1))
    assert all(s.parent == -1 for s in steps)
    names = {s.name for s in spans}
    assert {"nonpressure", "neighbor_prep", "pair_count", "advect",
            "diagnostics"} <= names
    assert any(n.startswith("pair.") for n in names)
    for s in spans:
        assert s.start <= s.end
        if s.name.startswith("sph.") or s.name == "step":
            continue
        top = s
        while top.parent != -1:
            parent = by_seq[top.parent]
            assert parent.start <= top.start and top.end <= parent.end
            top = parent
        assert top.name == "step" and top.replay == s.replay, s
    # nothing is left open, and nothing recorded twice
    assert graph_loop._active is None
    assert len({s.seq for s in spans}) == len(spans)


def test_ticks_equal_the_iteration_counts(traced):
    case, (diags, _, read, _) = traced
    for loop, key in CASES[case][2].items():
        got = [read["ticks"].get((loop, r), 0) for r in range(1, STEPS + 1)]
        want = [int(d[key]) for d in diags]
        assert got == want, (loop, got, want)
        assert sum(want) >= STEPS


def test_tracing_off_records_nothing_and_computes_the_same(traced):
    case, (diags_on, state_on, _, _) = traced
    diags_off, state_off, read, sim = _run(case, False)
    assert read == {} and sim.recording is None and sim._trace is None
    for a, b in zip(diags_on, diags_off):
        assert a.keys() == b.keys()
        for k in a:
            assert torch.equal(a[k], b[k]), k
    for (p, a), (_, b) in zip(tsim._tensors(state_on),
                              tsim._tensors(state_off)):
        assert torch.equal(a, b), ".".join(p)


def test_trace_switches_on_and_off():
    """``Simulation.trace`` on the CPU: spans recorded from the next step,
    and none once it is off again; the counters count every traced step."""
    scene, state = load_scene(config=SimConfig(config=box_config("dfsph")))
    sim = tsim.Simulation(scene, state, device="cpu")
    sim.step()
    assert sim.spans() == {}
    sim.trace(True)
    sim.step()
    sim.step()
    read = sim.spans()
    assert [s.replay for s in read["spans"] if s.name == "step"] == [1, 2]
    c = read["counters"]
    assert 0 < c["pair_kept"] < c["pair_candidates"]
    sim.trace(False)
    sim.step()
    read = sim.spans()
    assert read["spans"] == [] and read["counters"]["pair_kept"] == 0


def _brute_force(params, cells, produce, pos):
    """Per row: pairs within the radius (j != i, the squared distance in
    the kernels' order) and the particles of the 3^dim cells around the
    row's, the row itself included (the candidates a walk tests)."""
    dim = pos.shape[1]
    grid = pairs.grid3(tuple(params.grid_num))
    gx, gy, gz = grid
    live = (cells >= 0) & (cells < gx * gy * gz)
    c = cells.long()
    x, y, z = c // (gy * gz), (c // gz) % gy, c % gz
    R = [pos[:, None, d] - pos[None, :, d] for d in range(dim)]
    d2 = R[0] * R[0] + R[1] * R[1]
    if dim == 3:
        d2 = d2 + R[2] * R[2]
    h2 = torch.tensor(params.support_radius ** 2, dtype=torch.float32)
    eye = torch.eye(len(cells), dtype=torch.bool)
    kept = ((d2 < h2) & ~eye & live[None, :]).sum(1)
    near = ((x[:, None] - x[None, :]).abs() <= 1) & \
        ((y[:, None] - y[None, :]).abs() <= 1) & \
        ((z[:, None] - z[None, :]).abs() <= 1) & live[None, :]
    tested = near.sum(1)
    zero = torch.zeros_like(kept)
    keep = produce & live
    return torch.where(keep, kept, zero), torch.where(keep, tested, zero)


@pytest.mark.parametrize("make", [pk.pile_up_case, pk.pile_up_case_2d])
@pytest.mark.parametrize("engine", ["cell_list", "slab"])
def test_counting_walk_against_brute_force(make, engine):
    params, cells, produce, fields = make()
    env = (pairs.make_pair_env if engine == "cell_list"
           else pairs.make_slab_env)(cells, produce, params)
    out = pk.run("pair_count", env, {"pos": fields["pos"]}, params)
    kept, tested = _brute_force(params, cells, produce, fields["pos"])
    assert int(kept.sum()) > 0 and int(tested.sum()) > int(kept.sum())
    assert torch.equal(out["kept"].long(), kept)
    assert torch.equal(out["tested"].long(), tested)


def test_host_spans_reach_the_profiler_only_when_traced():
    trace = graph_loop.Trace("cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        with graph_loop.host_span("sph.one", trace):
            torch.ones(3).sum()
        with graph_loop.host_span("sph.two", None):
            torch.ones(3).sum()
    names = {e.name for e in prof.events()}
    assert "sph.one" in names and "sph.two" not in names
    read = trace.read()
    assert [s.name for s in read["spans"]] == ["sph.one"]
    with graph_loop.host_span("sph.three", trace):
        pass
    assert [s.name for s in trace.read()["spans"]] == ["sph.three"]


def test_pairing_tolerates_dropped_closes():
    """A close whose open's inner spans lost their closes (a full table)
    ends them unrecorded; a close with no open is skipped."""
    trace = graph_loop.Trace("cpu")
    for name, kind in (("step", 0), ("a", 0), ("b", 0), ("step", 1),
                       ("c", 1)):
        trace.host_event(name, kind)
    spans = trace.read()["spans"]
    assert [s.name for s in spans] == ["step"]


def test_iterations_by_name():
    """A captured loop's iterations under its name, summed over loops that
    share one, across flushes."""
    rec = graph_loop.Captured()
    n = len(graph_loop._counted)
    rec.outer = [{} for _ in range(n)]
    rec.counters = torch.zeros(graph_loop.MAX_LOOPS, dtype=torch.int64)
    rec.loops = [(rec.counters[i], [{} for _ in range(n)]) for i in range(3)]
    rec.names = ["a", "b", "a"]
    rec.replayed()
    rec.counters[:3] += torch.tensor([2, 5, 1])
    assert rec.iterations() == {"a": 3, "b": 5}
    rec.replayed()
    rec.counters[:3] += torch.tensor([1, 1, 1])
    assert rec.iterations() == {"a": 5, "b": 6}


def test_cli_trace_file(tmp_path):
    log = tmp_path / "run.jsonl"
    path = tmp_path / "trace.json"
    cli.main(["--scene_file", "data/scenes/smoke_test.json", "--device",
              "cpu", "--steps", "3", "--no-export", "--quiet", "--log_json",
              str(log), "--trace_file", str(path)])
    lines = [json.loads(x) for x in log.read_text().splitlines()]
    assert len(lines) == 3
    for line in lines:
        st = line["stage_ms"]
        assert st["step"] > 0 and {"neighbor_prep", "nonpressure",
                                   "diagnostics"} <= set(st)
    doc = json.loads(path.read_text())
    names = {e["name"] for e in doc["traceEvents"] if e["ph"] == "X"}
    assert {"sph.load", "sph.prepare", "sph.read", "step",
            "pair_count"} <= names
    steps = [e for e in doc["traceEvents"] if e.get("name") == "step"]
    assert [e["args"]["replay"] for e in steps] == [1, 2, 3]
    assert all(e["dur"] >= 0 for e in doc["traceEvents"] if e["ph"] == "X")


def test_stage_ms_and_running_max(tmp_path):
    trace = graph_loop.Trace("cpu")
    Span = graph_loop.Span
    read = {"spans": [Span("step", "host", 1, 0, 4e6, 0, -1),
                      Span("pair.density", "host", 1, 1e6, 2e6, 1, 0),
                      Span("pair.density", "host", 1, 2e6, 2.5e6, 2, 0),
                      Span("sph.read", "host", 1, 5e6, 6e6, 3, -1)]}
    assert telemetry.stage_ms(read) == {1: {"step": 4.0,
                                            "pair.density": 1.5}}
    tel = telemetry.StepTelemetry(trace=trace)
    for ov in (0, 3, 1):
        tel.record({"neighbor_overflow": torch.tensor(ov)}, 0, 10)
    assert tel.summary(10)["max_neighbor_overflow"] == 3.0
    assert [s.name for s in trace.read()["spans"]] == ["sph.read"] * 3
    assert "max_neighbor_overflow" not in \
        telemetry.StepTelemetry().summary(10)

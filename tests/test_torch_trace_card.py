"""The program's stamps on the card (``csrc/graph_loop.cu``): a step
captured with tracing off runs no stamp kernel, and computes what the
traced capture does, bit for bit; the CUDA counting walk equals its plain
version; the stamps of a replay rise in the order written; the clock anchor
maps the device's timer onto the host's.

Needs a CUDA device and skips without one; this file imports no JAX, so it
runs on the card's host:

    python3 -m pytest -m cuda tests/test_torch_trace_card.py -q

``tests/test_torch_trace.py`` holds the spans, ticks and counters of the
same steps on the CPU.
"""
import pytest
import torch

from sph_project_tpu_torch import sim as tsim
from sph_project_tpu_torch.ops import graph_loop
from sph_project_tpu_torch.ops import pair_kernels as pk
from sph_project_tpu_torch.ops import pairs
from sph_project_tpu_torch.scene import load_scene
from sph_project_tpu_torch.utils.config import SimConfig
from sph_project_tpu_torch.utils.telemetry import host_values

STEPS = 4
# tests/test_torch_scene.py's box: a 0.1^3 block thrown onto the floor of a
# 0.3^3 box, so the correctors iterate within a few steps
BOX = {
    "Configuration": {
        "domainStart": [0, 0, 0], "domainEnd": [0.3, 0.3, 0.3],
        "addDomainBox": True, "particleRadius": 0.01, "density0": 1000,
        "gravitation": [0, -9.81, 0], "simulationMethod": "dfsph",
        "viscosityMethod": "standard", "timeStepSize": 1e-3,
        "viscosity": 0.05, "viscosity_b": 0.03},
    "FluidBlocks": [{"objectId": 0, "start": [0.1, 0.08, 0.1],
                     "end": [0.2, 0.18, 0.2], "translation": [0, 0, 0],
                     "scale": [1, 1, 1], "velocity": [0.0, -2.5, 0.0],
                     "density": 1000.0, "color": [50, 100, 200],
                     "entryTime": -1.0}]}


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stamp kernel runs only on the "
                    "card")
    return torch.device("cuda")


def _sim(trace):
    scene, state = load_scene(config=SimConfig(config=BOX))
    return tsim.Simulation(scene, state, device="cuda", trace=trace)


@pytest.mark.cuda
def test_tracing_off_runs_no_stamp(card):
    plain = _sim(False)
    assert plain.recording is None and plain._trace is None
    before = graph_loop.stamp_runs(card)
    d_plain = [host_values(plain.step()) for _ in range(STEPS)]
    assert graph_loop.stamp_runs(card) == before
    traced = _sim(True)
    before = graph_loop.stamp_runs(card)
    d_traced = [host_values(traced.step()) for _ in range(STEPS)]
    read = traced.spans()
    # every stamp that ran wrote an event or counted a drop
    assert graph_loop.stamp_runs(card) - before == \
        len(read["stamps"]) + read["dropped"] > 0
    assert d_plain == d_traced
    for (p, a), (_, b) in zip(tsim._tensors(plain.state),
                              tsim._tensors(traced.state)):
        assert torch.equal(a, b), ".".join(p)
    for r, d in enumerate(d_traced, 1):
        assert read["ticks"][("dfsph.density", r)] == d["solver_iters"]
        assert read["ticks"][("dfsph.divergence", r)] == d["div_iters"]
    assert traced.iterations() == {
        "dfsph.density": sum(d["solver_iters"] for d in d_traced),
        "dfsph.divergence": sum(d["div_iters"] for d in d_traced)}
    # captured again with tracing off: no stamp runs
    traced.trace(False)
    before = graph_loop.stamp_runs(card)
    traced.step()
    assert graph_loop.stamp_runs(card) == before


@pytest.mark.cuda
@pytest.mark.parametrize("make", [pk.pile_up_case, pk.pile_up_case_2d])
def test_counting_walk_kernel_equals_plain(card, make):
    params, cells, produce, fields = make()
    pos = fields["pos"].to(card)
    for env in (pairs.make_pair_env(cells.to(card), produce.to(card), params),
                pairs.make_slab_env(cells.to(card), produce.to(card), params)):
        got = pk.run_cuda("pair_count", env, {"pos": pos}, params)
        want = pk.run_plain_body("pair_count", env, {"pos": pos}, params)
        assert int(got["kept"].sum()) > 0
        for k in ("kept", "tested"):
            assert torch.equal(got[k], want[k]), (type(env).__name__, k)


@pytest.mark.cuda
def test_stamps_rise_within_a_replay(card):
    sim = _sim(True)
    for _ in range(STEPS):
        host_values(sim.step())
    read = sim.spans()
    assert read["dropped"] == 0
    by = {}
    for replay, name, kind, t in read["stamps"]:
        by.setdefault(replay, []).append((name, kind, t))
    assert sorted(by) == list(range(1, STEPS + 1))
    for replay, events in by.items():
        times = [t for _, _, t in events]
        assert times == sorted(times), replay
        assert events[0][:2] == ("step", graph_loop.OPEN)
        assert events[-1][:2] == ("step", graph_loop.CLOSE)
    offset, unc, step = sim.recording.calibrate()
    assert 0 < step < 2_000 and 0 <= unc < 100_000
    # mapped onto the host's clock, the steps follow one another
    steps = sorted((s for s in read["spans"] if s.name == "step"),
                   key=lambda s: s.replay)
    assert all(a.end <= b.start for a, b in zip(steps, steps[1:]))

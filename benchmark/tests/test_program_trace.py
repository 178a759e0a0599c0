"""The program-traced pass (``program_trace.py``) and its five readers: the
readers on a synthetic record against hand sums, nothing read from a record
without the pass or from a program without spans, and the pass itself on a
small cell on the CPU (the host's clock in place of the stamps)."""
import json
import os
import shutil
import time

import pytest

import harness
import program_trace
from conftest import BENCH, ROOT
from test_harness_run import CELL, tiny_config

READERS = ("replay_gap_ms", "prep_ms", "solve_ms", "glue_ms",
           "pair_hit_rate")
MS = 1_000_000


def read(name, rec):
    return harness.metric_reader(BENCH, name)(rec)


def synthetic(**over):
    """Two steps of 10 ms, 2 ms apart, then a third after a read; each step
    with a sort of 1 ms, a counting walk of 0.5 ms (its pair launch inside),
    a corrector loop of 4 ms with two pair launches of 1 ms in it, a
    divergence loop of 2 ms with one of 1 ms, a pair launch of 0.5 ms
    outside the loops."""
    spans = []
    for r, t in ((1, 0), (2, 12 * MS), (3, 30 * MS)):
        spans += [("step", r, t, t + 10 * MS),
                  ("neighbor_prep", r, t + 1 * MS, t + 2 * MS),
                  ("pair_count", r, t + 2 * MS, t + 2.5 * MS),
                  ("pair.pair_count", r, t + 2.1 * MS, t + 2.4 * MS),
                  ("pair.nonpressure", r, t + 3 * MS, t + 3.5 * MS),
                  ("dfsph.density", r, t + 4 * MS, t + 8 * MS),
                  ("pair.correction", r, t + 4 * MS, t + 5 * MS),
                  ("pair.divergence", r, t + 6 * MS, t + 7 * MS),
                  ("dfsph.divergence", r, t + 8 * MS, t + 10 * MS),
                  ("pair.correction", r, t + 8 * MS, t + 9 * MS)]
    prog = dict(steps=3, spans=spans, read_after=[2],
                counters={"pair_candidates": 700, "pair_kept": 100})
    prog.update(over)
    return {"program": prog}


def test_readers_on_a_synthetic_record():
    rec = synthetic()
    # the gap after replay 2 straddles a read: only 1 -> 2 counts
    assert read("replay_gap_ms", rec) == pytest.approx(2.0)
    assert read("prep_ms", rec) == pytest.approx(1.0)
    assert read("solve_ms", rec) == pytest.approx(6.0)
    # 10 - (1 sort + 0.5 walk + 0.5 + 1 + 1 + 1 pair launches)
    assert read("glue_ms", rec) == pytest.approx(5.0)
    assert read("pair_hit_rate", rec) == pytest.approx(100 / 7)


def test_readers_read_nothing_without_the_pass():
    for rec in ({}, {"program": None},
                synthetic(spans=[], counters={})):
        for name in READERS:
            assert read(name, rec) is None, name


def test_replay_gaps_by_host_span():
    """Gaps between replays on the device, named by the host span open at
    their start and split by the host spans that cover them."""
    from sph_project_tpu_torch.ops.graph_loop import Span
    us = 1000
    read = {"spans": [
        Span("step", "device", 1, 0, 100 * us, 0, -1),
        Span("step", "device", 2, 150 * us, 250 * us, 1, -1),
        Span("step", "device", 3, 330 * us, 400 * us, 2, -1),
        Span("sph.read", "host", 1, 90 * us, 120 * us, 3, -1),
        Span("sph.replay", "host", 2, 130 * us, 140 * us, 4, -1),
        Span("sph.read", "host", 2, 240 * us, 300 * us, 5, -1),
        Span("sph.replay", "host", 3, 310 * us, 320 * us, 6, -1)]}
    out = program_trace.replay_gaps(read)
    assert out["sph.read"] == (2, 130.0)
    assert out["during"] == pytest.approx(
        {"sph.read": 70.0, "sph.replay": 20.0, "none": 40.0})
    lines = []
    program_trace.log_replay_gaps(out, lines.append)
    assert "sph.read 2 gaps, 65.0 us each" in lines[0]
    assert "sph.replay 10.0, none 20.0" in lines[0]


@pytest.fixture(scope="module")
def tiny_root(tmp_path_factory):
    """A checkout root whose manifest holds the small CPU cell of
    ``test_harness_run.py``, added as files and entries."""
    root = tmp_path_factory.mktemp("checkout")
    bench = root / "benchmark"
    shutil.copytree(BENCH, bench, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    (bench / "configs" / "tiny_dfsph.json").write_text(
        json.dumps(tiny_config()))
    (bench / "traffic" / "tiny_mix.json").write_text(json.dumps(
        {"start_s": 0.006, "segment_steps": 4, "jitter_spacing": 0.01}))
    with open(bench / "checks" / "flagship_dfsph.opening.json") as f:
        limits = json.load(f)
    del limits["limits"]["start_breaks"]
    (bench / "checks" / f"{CELL}.json").write_text(json.dumps(limits))
    man["configs"].append({"name": "tiny_dfsph", "source": "a", "file":
                           "benchmark/configs/tiny_dfsph.json",
                           "reduced": [], "why": "a"})
    man["workloads"].append({"name": CELL, "config": "tiny_dfsph",
                             "traffic": "tiny_mix", "chips": 1, "why": "a"})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root


def test_program_pass_on_the_cpu(tiny_root):
    spec = harness.load_cell(str(tiny_root), CELL,
                             str(tiny_root / "benchmark"))
    cell = harness.Cell(spec, 2 ** 33 + 5, "cpu")
    cell.setup(time.perf_counter(), False)
    cell.window(0.05)
    prog = program_trace.program_pass(cell, log=lambda *a: None)
    assert prog["steps"] == 4 and prog["replays"] == [1, 2, 3, 4]
    assert prog["dropped"] == 0 and not prog["on_card"]
    ticks = {(n, r): k for n, r, k in prog["ticks"]}
    for r, row in zip(prog["replays"], prog["diags"]):
        assert ticks[("dfsph.density", r)] == row["solver_iters"]
        assert ticks[("dfsph.divergence", r)] == row["div_iters"]
    # the first step's walk ran on the positions its resort sorted, which
    # the window's first step left in the held state: the reference's
    # neighbour search on them counts the same pairs
    ref = cell.ref_mod
    mat = cell.held["material"]
    pr = ref.Pairs(cell.held["pos"].double(), mat != 0, cell.ph)
    assert prog["first_counters"]["pair_kept"] == \
        int((mat[pr.i] == ref.FLUID).sum())
    rec = {"program": prog}
    for name in READERS:
        v = read(name, rec)
        assert v is not None and v > 0, name
    assert read("pair_hit_rate", rec) < 100
    assert read("solve_ms", rec) + read("prep_ms", rec) < \
        sum(e - s for n, _, s, e in prog["spans"] if n == "step") / MS / 4


def test_program_without_spans_gives_nothing(tiny_root):
    class Plain:
        """A simulation as a program before spans had it."""
    cell = harness.Cell(harness.load_cell(str(tiny_root), CELL,
                                          str(tiny_root / "benchmark")),
                        1, "cpu")
    cell.sim = Plain()
    assert program_trace.program_pass(cell) is None

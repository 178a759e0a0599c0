"""``BENCHMARK.json`` against the benchmark's contract: its keys, names and
units, its bounds and run length, and every file a cell needs found by
name."""
import json
import math
import os
import re

import pytest

import harness
from conftest import BENCH, ROOT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def man():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def line(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_keys(man):
    assert list(man) == ["command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"]
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 * 1024
    assert 1 <= len(man["paths"]) <= 16
    for p in man["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
    assert 1 <= len(man["command"]) <= 32
    assert all(line(w) for w in man["command"])
    for w in man["command"][1:]:
        if "/" in w:
            assert any(w.startswith(p + "/") for p in man["paths"])


def test_names_and_units(man):
    groups = ("configs", "workloads", "end_to_end", "per_layer")
    for g in groups:
        names = [x["name"] for x in man[g]]
        assert len(names) == len(set(names)), g
        assert all(NAME.match(n) for n in names), g
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert line(c["source"]) and line(c["why"])
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
    for w in man["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and line(w["why"])
        assert w["chips"] in (1, 4)
    for m in man["end_to_end"] + man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in man["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert line(m["layer"])


def test_bounds_and_run_length(man):
    e2e = {m["name"]: m for m in man["end_to_end"]}
    assert "setup_s" in e2e and len(e2e) >= 2
    for m in e2e.values():
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    rs = man["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200
    fours = sum(w["chips"] == 4 for w in man["workloads"])
    assert fours <= max(1, len(man["workloads"]) // 4)


def test_every_cell_finds_its_files(man):
    cells = {w["name"] for w in man["workloads"]}
    used = {w["config"] for w in man["workloads"]}
    assert used == {c["name"] for c in man["configs"]}
    files = [c["file"] for c in man["configs"]]
    assert len(files) == len(set(files))
    for f in files:
        assert f.startswith(tuple(p + "/" for p in man["paths"]))
    e2e = {m["name"] for m in man["end_to_end"]}
    for m in man["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for name in cells:
        spec = harness.load_cell(ROOT, name)
        assert spec["per_layer"] and len(spec["end_to_end"]) >= 2
        for m in spec["per_layer"]:
            assert callable(harness.metric_reader(BENCH, m["name"]))
        for key in ("match_breaks", "order_breaks", "pos_gap", "vel_gap",
                    "rho_gap", "failed"):
            assert key in spec["limits"], (name, key)


def test_config_files_hold_what_is_run(man):
    for c in man["configs"]:
        with open(os.path.join(ROOT, c["file"])) as f:
            cfg = json.load(f)
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["scene"]["Configuration"]["exportFrame"] is False
        assert set(cfg["constants"]) == {
            "surface_tension", "dfsph_max_error", "dfsph_max_error_v",
            "dfsph_max_iter", "dfsph_max_iter_v", "dfsph_eps",
            "vel_cap_cfl", "cg_tol", "cg_max_iter"}
        # the reference the configuration names models all of it
        ref = harness.reference_of(cfg)
        assert math.isfinite(ref.physics_of(cfg).dt)


def test_layers_are_named_in_perf(man):
    with open(os.path.join(ROOT, "PERF.md")) as f:
        perf = f.read()
    for m in man["per_layer"]:
        assert f"| {m['layer']} |" in perf, m["layer"]

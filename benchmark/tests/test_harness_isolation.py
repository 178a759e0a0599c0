"""What the benchmark loads: nothing of JAX or the JAX package anywhere,
nothing of the measured program in the reference; and how a run ends where
it cannot measure (no CUDA device, no program beside it)."""
import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

import harness
from conftest import BENCH, ROOT

JAX = {"jax", "jaxlib", "flax", "sph_project_tpu"}


def imported_tops(path):
    """Top-level names of every module a source file imports."""
    with open(path) as f:
        tree = ast.parse(f.read())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def sources(sub=""):
    top = os.path.join(BENCH, sub)
    for d, _, files in os.walk(top):
        if os.sep + "tests" in d[len(BENCH):]:
            continue
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_jax_imported(path):
    assert not imported_tops(path) & JAX


def test_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        assert "sph_project_tpu_torch" not in imported_tops(path), path
    code = ("import sys; sys.path[:0] = [%r]; import reference.sph; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'sph_project_tpu_torch', 'sph_project_tpu', 'jax'}))" % BENCH)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert out.stdout.strip() == "[]"


def test_foreign_modules_compared_by_top_level_name():
    assert "sph_project_tpu_torch" not in harness.FOREIGN
    sys.modules["sph_project_tpu_probe_x"] = sys.modules["os"]
    try:
        assert "sph_project_tpu_probe_x" not in harness.foreign_modules()
    finally:
        del sys.modules["sph_project_tpu_probe_x"]


def test_no_card_no_result(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "flagship_dfsph.settled", "--seed", str(2 ** 32 + 3), "--seconds",
         "1", "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=ROOT)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_without_the_program_no_result(tmp_path):
    """In a directory that holds only the manifest and the benchmark, a run
    fails before it prints anything."""
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys, time; sys.path[:0] = [%r]; import harness; "
            "print(harness.run_cell(%r, 'flagship_dfsph.opening', 5, 1.0, "
            "False, time.perf_counter(), device='cpu'))"
            % (str(tmp_path / "benchmark"), str(tmp_path)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert "sph_project_tpu_torch" in out.stderr

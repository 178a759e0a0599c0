"""The port's CLI driver against ``run_simulation.py``, on the CPU.

- The smoke scene for 20 steps: the same export layout (frames every
  1/fps of simulated time, a checkpoint in ``<out>/ckpt``), the same JSONL
  keys in the same order, the same step numbers and fluid counts, densities
  within float32 rounding.
- The domain box thrown onto its floor under PCISPH (4-9 iterations a
  step) and DFSPH: iteration counts equal to the JAX driver's every step.
- ``--resume`` continues bit for bit: 10 steps, a checkpoint, 10 more in a
  fresh process state equal the 20 steps straight through, iteration counts
  and every state array included.
- ``--device cuda``, the default, raises on a host without CUDA.
"""
import json
import os
import sys

import pytest
import torch

from test_torch_scene import SCENES, box_config

import run_simulation

from sph_project_tpu_torch import bridge
from sph_project_tpu_torch import cli

SMOKE = os.path.join(SCENES, "smoke_test.json")
ITERS = ("solver_iters", "div_iters")


def _jax_cli(monkeypatch, *args):
    monkeypatch.setattr(sys, "argv", ["run_simulation.py", *args])
    run_simulation.main()


def _log(path):
    with open(path) as f:
        return [json.loads(line) for line in f]


def _layout(root):
    return sorted(os.path.relpath(os.path.join(d, n), root)
                  for d, _, names in os.walk(root) for n in names)


def test_cli_smoke_scene_matches_jax_driver(tmp_path, monkeypatch):
    common = ["--scene_file", SMOKE, "--steps", "20", "--quiet",
              "--checkpoint_interval", "10"]
    _jax_cli(monkeypatch, *common, "--output_dir", str(tmp_path / "jax"),
             "--log_json", str(tmp_path / "jax.jsonl"))
    sim = cli.main([*common, "--device", "cpu", "--output_dir",
                    str(tmp_path / "port"), "--log_json",
                    str(tmp_path / "port.jsonl")])
    assert sim.device.type == "cpu" and int(sim.state.step_count) == 20
    # fps 200 at dt 1 ms: a frame every 5 steps (exportFrame only)
    want = [os.path.join(f"{c:06d}", "raw_view.png") for c in (0, 5, 10, 15)]
    want.append(os.path.join("ckpt", "state.npz"))
    assert _layout(tmp_path / "jax") == _layout(tmp_path / "port") == sorted(want)
    a, b = _log(tmp_path / "jax.jsonl"), _log(tmp_path / "port.jsonl")
    assert len(a) == len(b) == 20
    for ea, eb in zip(a, b):
        assert list(ea) == list(eb)
        assert ea["step"] == eb["step"] and ea["fluid_num"] == eb["fluid_num"]
        for k in ("density_avg", "density_max", "vel_max"):
            assert eb[k] == pytest.approx(ea[k], rel=1e-5, abs=1e-6), k
        for k in ea:
            if "overflow" in k or k.startswith("sort_"):
                assert ea[k] == eb[k] == 0.0, k


def _scene_file(tmp_path, method):
    cfg = box_config(method)
    cfg["Configuration"].update(fps=100.0, totalTime=1.0)
    path = tmp_path / f"box_{method}.json"
    path.write_text(json.dumps(cfg))
    return str(path)


@pytest.mark.parametrize("method", ["pcisph", "dfsph"])
def test_cli_iteration_counts_match_jax_driver(method, tmp_path, monkeypatch):
    scene = _scene_file(tmp_path, method)
    common = ["--scene_file", scene, "--steps", "20", "--quiet", "--no-export"]
    _jax_cli(monkeypatch, *common, "--log_json", str(tmp_path / "jax.jsonl"))
    cli.main([*common, "--device", "cpu", "--log_json",
              str(tmp_path / "port.jsonl")])
    a, b = _log(tmp_path / "jax.jsonl"), _log(tmp_path / "port.jsonl")
    keys = [k for k in ITERS if k in a[0]]
    assert keys and all(k in b[0] for k in keys)
    counts = [[e[k] for k in keys] for e in a]
    assert counts == [[e[k] for k in keys] for e in b]
    if method == "pcisph":
        assert max(c[0] for c in counts) > 1


@pytest.mark.parametrize("method", ["pcisph", "dfsph"])
def test_cli_resume_is_bit_equal(method, tmp_path):
    """20 steps straight against 10, a checkpoint (saved after step index
    9, so at step count 10), then a resumed run to 20. PCISPH moves the
    fluid after its sort, so the restore re-sorts the rows; DFSPH's saved
    rows are sorted, and its next step runs on the restored environment."""
    scene = _scene_file(tmp_path, method)
    common = ["--scene_file", scene, "--device", "cpu", "--quiet",
              "--no-export"]
    straight = cli.main([*common, "--steps", "20", "--log_json",
                         str(tmp_path / "straight.jsonl")])
    cli.main([*common, "--steps", "10", "--checkpoint_interval", "9",
              "--output_dir", str(tmp_path / "half"), "--log_json",
              str(tmp_path / "first.jsonl")])
    resumed = cli.main([*common, "--steps", "20", "--resume",
                        str(tmp_path / "half" / "ckpt"), "--log_json",
                        str(tmp_path / "second.jsonl")])
    a = _log(tmp_path / "straight.jsonl")
    b = _log(tmp_path / "first.jsonl") + _log(tmp_path / "second.jsonl")
    assert [e["step"] for e in b] == list(range(20))
    for ea, eb in zip(a, b):
        for k in ea:
            if k != "wall_ms":
                assert ea[k] == eb[k], (ea["step"], k)
    sa, sb = bridge.walk(straight.state), bridge.walk(resumed.state)
    for (path, x), (_, y) in zip(sa, sb):
        assert x.dtype == y.dtype and torch.equal(x, y), path


def test_cli_device_cuda_raises_without_cuda(tmp_path):
    """``--device cuda`` (and no ``--device``) runs on the card; on a host
    without one the simulation raises instead of carrying on on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    for extra in (["--device", "cuda"], []):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli.main(["--scene_file", SMOKE, "--steps", "1", "--no-export",
                      *extra])
    with pytest.raises(SystemExit):
        cli.main(["--scene_file", SMOKE, "--device", "tpu"])


def _files(root):
    out = {}
    for rel in _layout(root):
        with open(os.path.join(root, rel), "rb") as f:
            out[rel] = f.read()
    return out


def test_cli_pbf_2d_scene_matches_jax_driver(tmp_path, monkeypatch):
    """pbf_2d.json (a frame every step, the 2D view) through both drivers, 4
    steps: the same JSONL keys in the same order, equal fluid counts and
    iteration counts, densities within float32 rounding; the same frames,
    byte for byte (the trajectories are within 1e-5 for the first 5 steps:
    tests/test_torch_pbf_2d.py). The JAX package's PLY writer takes 3D
    points only, so the scene exports no PLY in either package."""
    common = ["--scene_file", os.path.join(SCENES, "pbf_2d.json"), "--steps",
              "4", "--quiet"]
    _jax_cli(monkeypatch, *common, "--output_dir", str(tmp_path / "jax"),
             "--log_json", str(tmp_path / "jax.jsonl"))
    cli.main([*common, "--device", "cpu", "--output_dir",
              str(tmp_path / "port"), "--log_json",
              str(tmp_path / "port.jsonl")])
    a, b = _log(tmp_path / "jax.jsonl"), _log(tmp_path / "port.jsonl")
    assert len(a) == len(b) == 4
    for ea, eb in zip(a, b):
        assert list(ea) == list(eb)
        for k in ("step", "fluid_num", "solver_iters"):
            assert ea[k] == eb[k], k
        for k in ("density_avg", "density_max", "vel_max"):
            assert eb[k] == pytest.approx(ea[k], rel=1e-5, abs=1e-6), k
    fa, fb = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(fa) == sorted(fb)
    frames = sorted({k.split(os.sep)[0] for k in fa})
    assert frames == [f"{c:06d}" for c in range(4)]
    assert sorted(fa) == [os.path.join(f, "raw_view.png") for f in frames]
    for k in fa:
        assert fa[k] == fb[k], k


def test_cli_pbf_2d_resume_is_bit_equal(tmp_path):
    """The 2D PBF scene: 6 steps straight against 3, a checkpoint, and a
    resumed run to 6, every state array bit for bit."""
    common = ["--scene_file", os.path.join(SCENES, "pbf_2d.json"), "--device",
              "cpu", "--quiet", "--no-export"]
    straight = cli.main([*common, "--steps", "6"])
    cli.main([*common, "--steps", "3", "--checkpoint_interval", "2",
              "--output_dir", str(tmp_path / "half")])
    resumed = cli.main([*common, "--steps", "6", "--resume",
                        str(tmp_path / "half" / "ckpt")])
    assert int(resumed.state.step_count) == 6
    sa, sb = bridge.walk(straight.state), bridge.walk(resumed.state)
    for (path, x), (_, y) in zip(sa, sb):
        assert x.dtype == y.dtype and torch.equal(x, y), path

"""The port's I/O against the JAX package's: checkpoints, exporters, the
software renderer and the live viewer.

- Checkpoints keep the JAX file layout and leaf names, so a state saved by
  either package restores in the other; after the restore one step of the
  two packages agrees within 1e-5 (nearest-neighbour match, as the re-sorts
  order rows differently) with equal iteration counts. The port's own
  round trip is bit-equal, the next step included.
- The exporters write byte-equal PLY, OBJ, PNG and npz files for the same
  state (the npz with the clock held: a zip stamps its members with the
  time of writing).
- ``render_particles`` / ``render_mesh`` give equal arrays, and the live
  viewer serves the JAX viewer's frame.
"""
import json
import os
import urllib.request
import warnings

import numpy as np
import pytest
import torch

from test_torch_scene import (SCENES, box_config, flatten_jax_state,
                              load_both)

from sph_project_tpu import sim as jsim
from sph_project_tpu.io import checkpoint as jck
from sph_project_tpu.io import exporters as jexp
from sph_project_tpu.io import render3d as jr3d
from sph_project_tpu.io import viewer as jviewer
from sph_project_tpu.scene import load_scene as jax_load_scene

from sph_project_tpu_torch import bridge
from sph_project_tpu_torch import sim as tsim
from sph_project_tpu_torch.io import checkpoint as tck
from sph_project_tpu_torch.io import exporters as texp
from sph_project_tpu_torch.io import render3d as tr3d
from sph_project_tpu_torch.io import viewer as tviewer
from sph_project_tpu_torch.scene import load_scene as torch_load_scene

SMOKE = os.path.join(SCENES, "smoke_test.json")
NN_TOL = 1e-5
ITERS = ("solver_iters", "div_iters")


def _port_sim(steps=3, **overrides):
    scene, state = torch_load_scene(SMOKE, **overrides)
    sim = tsim.Simulation(scene, state, device="cpu")
    for _ in range(steps):
        sim.step()
    return sim


def _leaves(state):
    return {".".join(p): v for p, v in bridge.walk(state)}


def test_checkpoint_roundtrip(tmp_path):
    """Every leaf comes back bit for bit, with its dtype, and the restored
    state's next step equals the uninterrupted one's."""
    sim = _port_sim(simulation_method="dfsph")
    ck = str(tmp_path / "ckpt")
    tck.save(ck, sim.state)
    fresh = _port_sim(steps=0, simulation_method="dfsph")
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        fresh.state = tck.restore(ck, fresh.state, fresh.params)
    a, b = _leaves(sim.state), _leaves(fresh.state)
    assert a.keys() == b.keys()
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        assert torch.equal(a[k], b[k]), k
    da, db = sim.step(), fresh.step()
    assert {k: float(v) for k, v in da.items()} == \
        {k: float(v) for k, v in db.items()}
    for k, v in _leaves(sim.state).items():
        assert torch.equal(v, _leaves(fresh.state)[k]), k


def test_checkpoint_names_are_jax_tree_paths(tmp_path):
    """The file holds the JAX layout: ``__names__`` and ``leaf_<i>``, the
    names the JAX package's tree paths give."""
    scene, state = jax_load_scene(SMOKE)
    want, _, _ = jck._flatten_with_names(state)
    _, tstate = torch_load_scene(SMOKE)
    tck.save(str(tmp_path), tstate)
    with np.load(str(tmp_path / "state.npz"), allow_pickle=True) as z:
        assert list(z["__names__"]) == want
        assert sorted(z.files) == sorted(
            ["__names__"] + [f"leaf_{i}" for i in range(len(want))])


def test_checkpoint_structure_mismatch(tmp_path):
    sim = _port_sim(steps=0)
    ck = str(tmp_path / "ckpt")
    os.makedirs(ck)
    np.savez_compressed(os.path.join(ck, "state.npz"),
                        __names__=np.asarray(["not", "the_same"], dtype=object),
                        leaf_0=np.zeros(3), leaf_1=np.ones(2))
    with pytest.raises(ValueError, match="structure mismatch"):
        tck.restore(ck, sim.state, sim.params)


def test_checkpoint_shape_mismatch(tmp_path):
    sim = _port_sim(steps=0)
    ck = str(tmp_path / "ckpt")
    tck.save(ck, sim.state)
    with np.load(os.path.join(ck, "state.npz"), allow_pickle=True) as z:
        arrays = {k: z[k] for k in z.files}
    arrays["leaf_0"] = arrays["leaf_0"][:-1]
    np.savez_compressed(os.path.join(ck, "state.npz"), **arrays)
    with pytest.raises(ValueError, match="shape"):
        tck.restore(ck, sim.state, sim.params)


def test_checkpoint_forward_compat_new_field(tmp_path):
    """A checkpoint written before a state field existed restores into the
    newer template: the missing leaf keeps the template's value (warned),
    everything else matches by name (tests/test_io_scene.py's case)."""
    sim = _port_sim()
    ck = str(tmp_path / "oldck")
    tck.save(ck, sim.state)
    with np.load(os.path.join(ck, "state.npz"), allow_pickle=True) as z:
        names = list(z["__names__"])
        vals = [z[f"leaf_{i}"] for i in range(len(names))]
    drop = next(i for i, n in enumerate(names) if "dfsph_kappa_v" in n)
    names, vals = names[:drop] + names[drop + 1:], vals[:drop] + vals[drop + 1:]
    np.savez_compressed(os.path.join(ck, "state.npz"),
                        __names__=np.asarray(names, dtype=object),
                        **{f"leaf_{i}": v for i, v in enumerate(vals)})
    template = _port_sim(steps=0)
    template.state = template.state.replace(
        dfsph_kappa_v=torch.full_like(template.state.dfsph_kappa_v, 7.0))
    with pytest.warns(UserWarning, match="dfsph_kappa_v"):
        restored = tck.restore(ck, template.state, template.params)
    for k, v in _leaves(restored).items():
        want = template.state.dfsph_kappa_v if "kappa_v" in k \
            else _leaves(sim.state)[k]
        assert torch.equal(v, want), k


def _fluid(state):
    p = state.particles
    return np.asarray(p.pos)[np.asarray(p.material) == 1].astype(np.float64)


def _nn(a, b):
    return np.sqrt(((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)).min(1)


# (case, method, steps before the save). The smoke scene as it is (WCSPH, a
# free block); the domain box under DFSPH, PCISPH and IISPH after its block
# hits the floor (PCISPH and IISPH iterate there; DFSPH's correctors stay at
# 1 and 1 on this scene, as in the JAX package); pbf_2d.json, a 2D state
# (PBF)
CASES = [("smoke", "wcsph", 3), ("box", "dfsph", 18), ("box", "pcisph", 12),
         ("box", "iisph", 12), ("pbf_2d", "pbf", 3)]


def _config(case, method):
    if case in ("smoke", "pbf_2d"):
        with open(SMOKE if case == "smoke"
                  else os.path.join(SCENES, "pbf_2d.json")) as f:
            return json.load(f)
    return box_config(method)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
@pytest.mark.parametrize("case,method,steps", CASES,
                         ids=[f"{c}-{m}" for c, m, _ in CASES])
def test_checkpoint_across_packages(direction, case, method, steps, tmp_path):
    """A state saved by one package after some steps restores in the other;
    then one step of each agrees within 1e-5, with equal iteration counts.

    The JAX package's DFSPH step takes its pair environment from the state,
    and its checkpoints carry it (``.cached_neighbors/...`` leaves, its own
    engine's tables). A port file has none, so ``restore`` keeps the JAX
    template's, which describes the template's positions; the JAX side
    rebuilds it here with its own ``neighbor_prep``, as its prepare does.
    The port drops the JAX file's tables and rebuilds its own."""
    js, jst, ts, tst = load_both(_config(case, method),
                                 simulation_method=method)
    ck = str(tmp_path / "ckpt")
    j = jsim.Simulation(js, jst)
    t = tsim.Simulation(ts, tst, device="cpu")
    if direction == "jax_to_port":
        for _ in range(steps):
            j.step()
        jck.save(ck, j.state)
        with pytest.warns(UserWarning, match="cached_neighbors"):
            t.state = tck.restore(ck, t.state, ts.params)
    else:
        for _ in range(steps):
            t.step()
        tck.save(ck, t.state)
        with pytest.warns(UserWarning, match="cached_neighbors"):
            j.state = jck.restore(ck, j.state)
        if method == "dfsph":
            state, env = jsim.Plumbing.neighbor_prep(j.state, js.params,
                                                     exact_sort=True)
            j.state = state.replace(cached_neighbors=env)
    assert int(t.state.step_count) == int(j.state.step_count) == steps
    np.testing.assert_array_equal(np.sort(_fluid(t.state), 0),
                                  np.sort(_fluid(j.state), 0))
    dj, dt = j.step(), t.step()
    for k in ITERS:
        if k in dj:
            assert int(dj[k]) == int(dt[k]), k
    if method in ("pcisph", "iisph"):
        assert int(dj["solver_iters"]) > 1   # the loop works here
    d = _nn(_fluid(t.state), _fluid(j.state))
    assert d.max() < NN_TOL, d.max()


def _exporter_config(cube):
    """A fluid block and a dynamic cube turned 30 degrees, every export on."""
    return {
        "Configuration": {
            "domainStart": [0, 0, 0], "domainEnd": [0.4, 0.4, 0.4],
            "addDomainBox": False, "particleRadius": 0.01, "density0": 1000,
            "gravitation": [0, -9.81, 0], "simulationMethod": "dfsph",
            "viscosityMethod": "standard", "timeStepSize": 1e-3,
            "viscosity": 0.05, "exportPly": True, "exportObj": True,
            "exportFrame": True},
        "FluidBlocks": [{"objectId": 0, "start": [0.05, 0.05, 0.05],
                         "end": [0.2, 0.15, 0.2], "velocity": [0, 0, 0],
                         "color": [50, 100, 200]}],
        "RigidBodies": [{"objectId": 1, "geometryFile": cube,
                         "translation": [0.3, 0.25, 0.3],
                         "rotationAxis": [1, 1, 0], "rotationAngle": 30.0,
                         "velocity": [0, -1.0, 0], "density": 500.0,
                         "color": [200, 80, 40], "isDynamic": True}]}


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            path = os.path.join(dirpath, n)
            with open(path, "rb") as f:
                out[os.path.relpath(path, root)] = f.read()
    return out


def test_frame_exporter_byte_equal(tmp_path, monkeypatch):
    """The JAX state after two steps, carried into the port: the port's
    FrameExporter writes the JAX exporter's files byte for byte."""
    from test_rigid import write_cube_obj
    cfg = _exporter_config(write_cube_obj(str(tmp_path / "cube.obj"), 0.08))
    js, jst, ts, _ = load_both(cfg)
    j = jsim.Simulation(js, jst)
    for _ in range(2):
        j.step()
    state = bridge.state_from_numpy(flatten_jax_state(j.state), ts.params)
    assert not np.allclose(np.asarray(j.state.rigid.rot[1]), np.eye(3))
    # zip stamps each npz member with the time of writing
    monkeypatch.setattr("time.time", lambda: 1.7e9)
    for pkg, sc, st in (("jax", js, j.state), ("port", ts, state)):
        mod = jexp if pkg == "jax" else texp
        ex = mod.FrameExporter(sc, str(tmp_path / pkg), export_ply=True,
                               export_obj=True, export_frame=True,
                               export_npz=True)
        ex.dump(st, 2)
    a, b = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(a) == sorted(b) == sorted(
        os.path.join("000002", n) for n in (
            "particle_object_0.ply", "mesh_object_1.obj", "raw_view.png",
            "state.npz"))
    for k in a:
        assert a[k] == b[k], k


def test_frame_exporter_byte_equal_2d(tmp_path, monkeypatch):
    """pbf_2d.json's JAX state after two steps, carried into the port: the
    2D view and the npz state byte for byte (the JAX package's PLY writer
    takes 3D points only)."""
    with open(os.path.join(SCENES, "pbf_2d.json")) as f:
        cfg = json.load(f)
    js, jst, ts, _ = load_both(cfg)
    j = jsim.Simulation(js, jst)
    for _ in range(2):
        j.step()
    state = bridge.state_from_numpy(flatten_jax_state(j.state), ts.params)
    assert state.particles.pos.shape[1] == 2
    monkeypatch.setattr("time.time", lambda: 1.7e9)
    for pkg, sc, st in (("jax", js, j.state), ("port", ts, state)):
        mod = jexp if pkg == "jax" else texp
        mod.FrameExporter(sc, str(tmp_path / pkg), export_ply=False,
                          export_frame=True, export_npz=True).dump(st, 2)
    a, b = _files(tmp_path / "jax"), _files(tmp_path / "port")
    assert sorted(a) == sorted(b) == sorted(
        os.path.join("000002", n) for n in ("raw_view.png", "state.npz"))
    for k in a:
        assert a[k] == b[k], k


def test_writers_byte_equal(tmp_path):
    """Each writer on the same arrays from a numpy seed; and the reader."""
    rng = np.random.default_rng(0)
    pts = rng.random((37, 3), dtype=np.float32)
    faces = rng.integers(0, 37, (20, 3))
    rgb = rng.integers(0, 256, (24, 32, 3), dtype=np.uint8)
    colors = rng.integers(0, 256, (37, 3), dtype=np.uint8)
    for mod in (jexp, texp):
        d = tmp_path / mod.__name__.split(".")[0]
        d.mkdir()
        mod.write_ply(str(d / "p.ply"), pts)
        mod.write_obj(str(d / "m.obj"), pts.astype(np.float64), faces)
        mod.write_png(str(d / "i.png"), rgb)
    a, b = _files(tmp_path / "sph_project_tpu"), \
        _files(tmp_path / "sph_project_tpu_torch")
    assert a.keys() == b.keys() and all(a[k] == b[k] for k in a)
    np.testing.assert_array_equal(
        texp.read_ply(str(tmp_path / "sph_project_tpu" / "p.ply")), pts)
    assert texp.png_bytes(rgb) == jexp.png_bytes(rgb)
    img_j = jexp.rasterize_particles(pts, colors, (0, 0, 0), (1, 1, 1), size=64)
    img_t = texp.rasterize_particles(pts, colors, (0, 0, 0), (1, 1, 1), size=64)
    np.testing.assert_array_equal(img_j, img_t)


def test_render3d_equal():
    rng = np.random.default_rng(1)
    verts = rng.random((30, 3))
    faces = rng.integers(0, 30, (40, 3))
    pos = rng.random((500, 3))
    kw = dict(size=(96, 80), eye=(2.5, 1.5, 2.0))
    for a, b in zip(jr3d.render_mesh(verts, faces, **kw),
                    tr3d.render_mesh(verts, faces, **kw)):
        np.testing.assert_array_equal(a, b)
    img_j, z_j = jr3d.render_particles(pos, **kw)
    img_t, z_t = tr3d.render_particles(pos, **kw)
    np.testing.assert_array_equal(img_j, img_t)
    np.testing.assert_array_equal(z_j, z_t)
    assert (img_t != img_t[0, 0]).any()      # something was drawn
    np.testing.assert_array_equal(tr3d.look_at((1, 2, 3), (0, 0, 0)),
                                  jr3d.look_at((1, 2, 3), (0, 0, 0)))


def _get(url):
    with urllib.request.urlopen(url, timeout=10) as r:
        return r.read()


def test_live_viewer_frame():
    """One frame of the port's viewer, fetched over HTTP on 127.0.0.1 from
    an ephemeral port, equals the JAX viewer's frame of the same state."""
    js, jst = jax_load_scene(SMOKE)
    ts, tst = torch_load_scene(SMOKE)
    size = (120, 100)
    tv = tviewer.LiveViewer(ts.params, port=0, size=size)
    jv = jviewer.LiveViewer(js.params, port=0, size=size)
    try:
        tv.update(tst, steps_per_s=2.5)
        jv.update(jst, steps_per_s=2.5)
        base = f"http://127.0.0.1:{tv.port}"
        png = _get(base + "/frame.png")
        stats = json.loads(_get(base + "/stats"))
        assert png[:8] == b"\x89PNG\r\n\x1a\n"
        assert png == jv._png
        assert stats == {"step": 0, "t": 0.0, "steps_per_s": 2.5,
                         "rho_max": float(tst.particles.density.max())}
        assert b"live view" in _get(base + "/")
        assert _get(base + "/ctl?dyaw=0.3") == b"ok"
        assert _get(base + "/frame.png") != png        # the camera turned
    finally:
        tv.close()
        jv.close()

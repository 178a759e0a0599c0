"""Deferred entries and emitters, the port against the JAX package.

Both packages load the same config, prepare it and step it on the CPU. Every
step: the fluid count and the count of active particles (any material but
none) equal, and each material's particles matched by position, every one of
the port's within 1e-5 of one of the JAX package's of the same material
(nearest-neighbour match: the re-sorts order rows differently); the
iteration counts equal.

- The entry config of tests/test_solvers.py (test_entry_time_activation): a
  second fluid block joins at t = 0.01 s (WCSPH, 20 steps).
- The emitter config of tests/test_static_rigid_gate.py (gravitationUpper
  0.3, above all its fluid), DFSPH and WCSPH, for that test's 5 steps: its
  fluid block starts on the wall layer (169 fluid particles sit on wall
  particles), and from that start the rounding differences the two packages
  have from prepare on (the walls' volumes, 3e-7 relative: the JAX package
  sums its fixed-K neighbour list, the port runs a pair pass) grow past 1e-5
  within 20 steps, with or without the emitter height.
- A falling column through the emitter height in the domain box: its
  placeholders (fluid above g_upper made rigid at prepare) fall at their own
  speed and turn fluid below g_upper, so the fluid count rises; standard and
  implicit viscosity, 20 DFSPH steps.
"""
import numpy as np
import pytest

from sph_project_tpu import sim as jsim
from sph_project_tpu_torch import sim as tsim

from test_solvers import dam_break_cfg
from test_static_rigid_gate import _walls_scene
from test_torch_dfsph import nn_dist
from test_torch_scene import load_both

TOL = 1e-5


def entry_config() -> dict:
    cfg = dam_break_cfg("wcsph", dt=1e-3).config
    cfg["FluidBlocks"].append({
        "objectId": 1, "start": [0.3, 0.3, 0.3], "end": [0.4, 0.4, 0.4],
        "translation": [0, 0, 0], "scale": [1, 1, 1], "velocity": [0, 0, 0],
        "density": 1000.0, "color": [200, 50, 50], "entryTime": 0.01})
    return cfg


def column_config(viscosity_method: str) -> dict:
    """A 0.12 x 0.26 x 0.12 fluid column falling at 2 m/s in the 0.4^3
    domain box of the emitter config, with the emitter height at 0.2."""
    cfg = _walls_scene("dfsph", emitter=True).config
    cfg["Configuration"].update(gravitationUpper=0.2,
                                viscosityMethod=viscosity_method,
                                viscosity=50.0 if viscosity_method ==
                                "implicit" else 0.05)
    cfg["FluidBlocks"][0].update(start=[0.14, 0.08, 0.14],
                                 end=[0.26, 0.34, 0.26], velocity=[0, -2.0, 0])
    return cfg


def run_both(config: dict, steps: int):
    """``steps`` steps through both packages with the checks above; returns
    the fluid count per step and the port's simulation."""
    js, jst, ts, tst = load_both(config, port_kw=dict(pair_block=64),
                                 pair_block=64, pair_chunk=32)
    assert ts.params.has_entries and js.params.has_entries
    jax_sim = jsim.Simulation(js, jst)
    port = tsim.Simulation(ts, tst, device="cpu")
    counts = []
    for s in range(steps):
        jd = jax_sim.step()
        td = port.step()
        assert set(td) == set(jd), f"step {s}: diagnostics keys differ"
        for k in ("fluid_num", "solver_iters", "div_iters"):
            if k in jd:
                assert int(td[k]) == int(jd[k]), \
                    f"step {s}: {k} {int(td[k])} vs JAX {int(jd[k])}"
        tp, jp = port.state.particles, jax_sim.state.particles
        tm, jm = tp.material.numpy(), np.asarray(jp.material)
        assert (tm != 0).sum() == (jm != 0).sum(), f"step {s}: active count"
        for mat in np.unique(jm[jm != 0]):
            a = tp.pos.numpy()[tm == mat].astype(np.float64)
            b = np.asarray(jp.pos)[jm == mat].astype(np.float64)
            assert a.shape == b.shape, f"step {s}: material {mat} count"
            d = nn_dist(a, b).max()
            assert d < TOL, f"step {s}: material {mat} off by {d:.2e}"
        counts.append(int(td["fluid_num"]))
    return counts, port


def test_entry_time_activation_matches_jax():
    counts, port = run_both(entry_config(), 20)
    obj = port.state.particles.object_id.numpy()
    mat = port.state.particles.material.numpy()
    assert ((obj == 1) & (mat != 0)).sum() == counts[-1] - counts[0] > 0
    # the block is absent until its entry time, then present
    assert counts[:9] == [counts[0]] * 9 and counts[10:] == [counts[-1]] * 10


@pytest.mark.parametrize("method", ["dfsph", "wcsph"])
def test_emitter_config_matches_jax(method):
    counts, _ = run_both(_walls_scene(method, emitter=True).config, 5)
    assert counts == [512] * 5


@pytest.mark.parametrize("viscosity_method", ["standard", "implicit"])
def test_emitter_column_matches_jax(viscosity_method):
    counts, port = run_both(column_config(viscosity_method), 20)
    assert port.params.viscosity_method == viscosity_method
    # placeholders cross the emitter height and turn fluid
    assert counts[-1] > counts[0] and counts == sorted(counts)

"""The port's WCSPH step and its new pair pass against the JAX package.

- The symmetric pressure acceleration (body ``pressure``, shared by WCSPH,
  PCISPH and IISPH) on one sorted state with pressures made from a seed with
  numpy: the port's plain body under both of its engines against the JAX
  package's ``common.pressure_acceleration(..., with_wrench=False)`` through
  its CPU executor (``pair_exec._exec_jax``), and against the TPU kernel
  itself (``pair_dma``, Pallas interpret mode) on a tiny scene.
- 20 WCSPH steps of the JAX ``Simulation`` against the port's
  ``Simulation(device="cpu")`` on the small domain-box scene, whose walls
  make the rigid branches run: the same diagnostics keys, and every fluid
  particle within 1e-5 of one of the JAX package's (nearest-neighbour match).

Tolerance: max|a - b| <= 2e-5 * max(1, max|b|), as tests/test_torch_pairs.py.
"""
import numpy as np
import pytest
import torch

from sph_project_tpu import sim as jsim
from sph_project_tpu.ops.pairs import slab_pack
from sph_project_tpu.solvers import common as jcommon
from sph_project_tpu.solvers import wcsph as jwcsph

from sph_project_tpu_torch import sim as tsim
from sph_project_tpu_torch.solvers import common as tcommon
from sph_project_tpu_torch.solvers import wcsph as twcsph

from test_torch_dfsph import fluid_pos, nn_dist
from test_torch_pairs import Setup, assert_pass_close
from test_torch_scene import box_config, load_both

STEPS = 20


@pytest.fixture(scope="module", params=["pallas_dma", "pallas"],
                ids=["cell_list", "slab_window"])
def box(request):
    return Setup(box_config(), engine=request.param)


def seeded_pressure(s, seed=1):
    """Pressures on fluid rows, zero elsewhere, in the JAX row order."""
    rng = np.random.default_rng(seed)
    pr = rng.uniform(0.0, 5000.0, s.params.n_pad).astype(np.float32)
    return np.where(np.asarray(s.jp.material) == 1, pr, 0.0).astype(np.float32)


def check_pressure_pass(s, pr):
    jp = s.jp.replace(pressure=pr)
    jsl = dict(s.jsl, pressure=slab_pack(s.jenv, {"pr": pr})["pr"])
    j, _, _ = jcommon.pressure_acceleration(jp, s.jrigid, s.jenv, jsl,
                                            s.jparams, with_wrench=False)
    tp = s.tp.replace(pressure=torch.from_numpy(pr[s.perm]))
    t = tcommon.pressure_acceleration(tp, s.tenv, s.params)
    assert np.abs(np.asarray(j)).max() > 0
    assert_pass_close(t.numpy(), s.j(j), "pressure acceleration")


def test_pressure_pass(box):
    check_pressure_pass(box, seeded_pressure(box))


def test_pressure_pass_vs_pallas_dma():
    """The same pass against the TPU kernel itself (pair_dma, Pallas
    interpret mode) on a tiny scene."""
    cfg = box_config()
    cfg["Configuration"]["domainEnd"] = [0.24, 0.24, 0.24]
    cfg["FluidBlocks"][0].update(start=[0.08, 0.08, 0.08],
                                 end=[0.14, 0.14, 0.14])
    s = Setup(cfg, pair_backend="pallas_dma")
    assert int(s.jenv.overflow) == 0
    check_pressure_pass(s, seeded_pressure(s))


def test_compute_pressure_matches_jax(box):
    """Tait EOS with the clamped density written back."""
    rng = np.random.default_rng(2)
    dens = rng.uniform(900.0, 1100.0, box.params.n_pad).astype(np.float32)
    j = jwcsph.compute_pressure(box.jp.replace(density=dens), box.jparams)
    t = twcsph.compute_pressure(
        box.tp.replace(density=torch.from_numpy(dens[box.perm])), box.params)
    np.testing.assert_array_equal(t.density.numpy(), box.j(j.density))
    assert_pass_close(t.pressure.numpy(), box.j(j.pressure), "pressure")


def run_steps_against_jax(method, steps=STEPS, **overrides):
    """``steps`` steps of ``method`` on the small domain-box scene in both
    packages; checks the diagnostics per step and the fluid at the end.
    Returns the per-step solver iterations (empty for WCSPH)."""
    js, jst, ts, tst = load_both(box_config(method),
                                 port_kw=dict(overrides, pair_block=64),
                                 pair_block=64, pair_chunk=32, **overrides)
    jax_sim = jsim.Simulation(js, jst)
    port = tsim.Simulation(ts, tst, device="cpu")
    iters = []
    for s in range(steps):
        jd = jax_sim.step()
        td = port.step()
        assert set(td) == set(jd), f"step {s}: diagnostics keys differ"
        if "solver_iters" in jd:
            assert int(td["solver_iters"]) == int(jd["solver_iters"]), \
                f"step {s}: solver_iters {int(td['solver_iters'])} vs JAX " \
                f"{int(jd['solver_iters'])}"
            iters.append(int(td["solver_iters"]))
        for k in ("neighbor_overflow", "sort_overflow", "fluid_num"):
            assert int(td[k]) == int(jd[k]), f"step {s}: {k}"
    jp, tp = jax_sim.state.particles, port.state.particles
    a = fluid_pos(tp.pos.numpy(), tp.material.numpy())
    b = fluid_pos(jp.pos, jp.material)
    assert a.shape == b.shape and np.isfinite(a).all()
    d = nn_dist(a, b)
    assert d.max() < 1e-5, f"trajectory drift {d.max():.2e}"
    return iters


def test_wcsph_steps_match_jax():
    assert run_steps_against_jax("wcsph") == []

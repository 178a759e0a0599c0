"""The port's IISPH step and its five new pair passes against the JAX package.

- Each pass on one sorted state, under both of the port's engines, against
  the JAX package's through its CPU executor (``pair_exec._exec_jax``), on
  the fluid rows, the rows whose sums the step reads:
  ``compute_dii`` (with the stale advected density at zero, as on the first
  step, and made from a seed), ``compute_aii``, ``compute_density_star``,
  and the two kernels of ``refine`` (``dij_pj_op`` and ``sum_i_op``), taken
  from a run of the JAX ``refine`` and fed pressures and sums d_ij p_j made
  from a seed with numpy.
- 20 IISPH steps of the JAX ``Simulation`` against the port's
  ``Simulation(device="cpu")`` on the small domain-box scene, under either
  engine: the same diagnostics keys, ``solver_iters`` equal at every step,
  and every fluid particle within 1e-5 of one of the JAX package's. From the
  second step on, d_ii reads the advected density carried across the sort.

Tolerance: max|a - b| <= 2e-5 * max(1, max|b|), as tests/test_torch_pairs.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_project_tpu.ops import pair_exec
from sph_project_tpu.ops.pairs import slab_pack
from sph_project_tpu.solvers import iisph as jiisph

from sph_project_tpu_torch import sim as tsim
from sph_project_tpu_torch.ops import pair_kernels
from sph_project_tpu_torch.solvers import iisph as tiisph

from test_torch_pairs import Setup, assert_pass_close
from test_torch_scene import box_config
from test_torch_wcsph import STEPS, run_steps_against_jax


class IisphSetup(Setup):
    """A sorted state and the JAX package's d_ii, a_ii and rho* on it."""

    def __init__(self, engine):
        super().__init__(box_config(), engine=engine)
        n = self.params.n_pad
        rng = np.random.default_rng(4)
        fluid = np.asarray(self.jp.material) == 1
        self.star_prev = np.where(
            fluid, rng.uniform(950.0, 1050.0, n), 0.0).astype(np.float32)
        self.jdii = jiisph.compute_dii(self.jp, self.star_prev, self.jenv,
                                       self.jsl, self.jparams)
        self.jaii = jiisph.compute_aii(self.jp, self.jdii, None, self.jenv,
                                       self.jsl, self.jparams)
        self.jstar = jiisph.compute_density_star(self.jp, self.jenv,
                                                 self.jsl, self.jparams)
        self.dii = torch.from_numpy(self.j(self.jdii))
        self.dpi = tiisph._dpi(self.tp, self.params)


@pytest.fixture(scope="module", params=["pallas_dma", "pallas"],
                ids=["cell_list", "slab_window"])
def box(request):
    return IisphSetup(request.param)


@pytest.mark.parametrize("stale", ["first_step", "seeded"])
def test_dii_pass(box, stale):
    """d_ii; before the first step the stale advected density is 0, so the
    rigid-neighbour term takes 1 / max(0, 1e-12) = 1e12."""
    prev = np.zeros_like(box.star_prev) if stale == "first_step" \
        else box.star_prev
    j = jiisph.compute_dii(box.jp, prev, box.jenv, box.jsl, box.jparams)
    t = tiisph.compute_dii(box.tp, torch.from_numpy(prev[box.perm]),
                           box.tenv, box.params)
    assert np.abs(np.asarray(j)).max() > 0
    assert_pass_close(t.numpy()[box.fluid], box.j(j)[box.fluid], "d_ii")


def test_aii_pass(box):
    t = tiisph.compute_aii(box.tp, box.dii, box.dpi, box.tenv, box.params)
    assert np.abs(np.asarray(box.jaii)).max() > 0
    assert_pass_close(t.numpy()[box.fluid], box.j(box.jaii)[box.fluid],
                      "a_ii")


def test_density_star_pass(box):
    t = tiisph.compute_density_star(box.tp, box.tenv, box.params)
    assert_pass_close(t.numpy(), box.j(box.jstar), "advected density")


@pytest.fixture(scope="module")
def refine_kernels(box):
    """The two pair kernels of the JAX ``refine`` with what it hands them:
    ``[(kern, slab fields, row fields)]`` for ``dij_pj_op``, ``sum_i_op``."""
    calls = []
    run = pair_exec.run

    def spy(kern, env, slabs, fields, params):
        calls.append((kern, slabs, fields))
        return run(kern, env, slabs, fields, params)

    pair_exec.run = spy
    try:
        jiisph.refine(box.jp, box.jdii, box.jaii, box.jstar, box.jenv,
                      box.jsl, box.jparams)
    finally:
        pair_exec.run = run
    assert len(calls) == 2
    return calls


def seeded_refine_inputs(box):
    """Pressure on fluid rows and sums d_ij p_j, in the JAX row order."""
    n = box.params.n_pad
    rng = np.random.default_rng(5)
    fluid = np.asarray(box.jp.material) == 1
    pr = np.where(fluid, rng.uniform(0.0, 3000.0, n), 0.0).astype(np.float32)
    dp = rng.normal(0.0, 10.0, (n, 3)).astype(np.float32)
    return pr, dp


def test_dij_pj_pass(box, refine_kernels):
    kern, slabs, fields = refine_kernels[0]
    pr, _ = seeded_refine_inputs(box)
    j = pair_exec.run(kern, box.jenv,
                      dict(slabs, pr=slab_pack(box.jenv, {"pr": pr})["pr"]),
                      fields, box.jparams)["dp"]
    tp = box.tp
    t = pair_kernels.run("iisph_dij_pj", box.tenv,
                         {"pos": tp.pos, "material": tp.material,
                          "density": tp.density,
                          "rest_volume": tp.rest_volume,
                          "pressure": torch.from_numpy(pr[box.perm])},
                         box.params)["dp"]
    assert np.abs(np.asarray(j)).max() > 0
    assert_pass_close(t.numpy()[box.fluid], box.j(j)[box.fluid],
                      "sum d_ij p_j")


def test_sum_i_pass(box, refine_kernels):
    """sum_i reads d_ij p_j as row i's and as neighbour j's."""
    kern, slabs, fields = refine_kernels[1]
    pr, dp = seeded_refine_inputs(box)
    up = slab_pack(box.jenv, {"pr": pr, "dp": dp})
    j = pair_exec.run(kern, box.jenv, dict(slabs, pr=up["pr"], dp=up["dp"]),
                      dict(fields, pr=jnp.asarray(pr),
                           dij_pj=jnp.asarray(dp)), box.jparams)["s"]
    tp = box.tp
    t = pair_kernels.run("iisph_sum_i", box.tenv,
                         {"pos": tp.pos, "material": tp.material,
                          "rest_volume": tp.rest_volume, "dii": box.dii,
                          "pressure": torch.from_numpy(pr[box.perm]),
                          "dij_pj": torch.from_numpy(dp[box.perm]),
                          "dpi": box.dpi}, box.params)["s"]
    assert np.abs(np.asarray(j)).max() > 0
    assert_pass_close(t.numpy()[box.fluid], box.j(j)[box.fluid], "sum_i")


def test_density_star_carries_across_the_sort():
    assert "iisph_density_star" in tsim.permuted_keys(
        box_config_params("iisph"))[1]
    assert "iisph_density_star" not in tsim.permuted_keys(
        box_config_params("pcisph"))[1]


def box_config_params(method):
    from sph_project_tpu_torch.scene import load_scene
    from sph_project_tpu_torch.utils.config import SimConfig
    return load_scene(config=SimConfig(config=box_config(method)))[0].params


@pytest.mark.parametrize("overrides", [{}, dict(pair_backend="pallas")],
                         ids=["cell_list", "slab_window"])
def test_iisph_steps_match_jax(overrides):
    iters = run_steps_against_jax("iisph", **overrides)
    assert len(iters) == STEPS and sum(iters) > STEPS

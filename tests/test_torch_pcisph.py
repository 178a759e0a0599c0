"""The port's PCISPH step and its new pair pass against the JAX package.

- ``compute_pcisph_k``: the port's copy gives the JAX package's stiffness,
  in 3D and in 2D.
- The predicted density (body ``pcisph_density_pred``) on one sorted state
  with predicted positions made from a seed with numpy, some pairs moved
  beyond the support radius: the port's plain body under both of its engines
  against the JAX package's ``pcisph._density_star_predicted`` through its
  CPU executor (``pair_exec._exec_jax``).
- 20 PCISPH steps of the JAX ``Simulation`` against the port's
  ``Simulation(device="cpu")`` on the small domain-box scene, under either
  engine: the same diagnostics keys, ``solver_iters`` equal at every step,
  and every fluid particle within 1e-5 of one of the JAX package's.

Tolerance: max|a - b| <= 2e-5 * max(1, max|b|), as tests/test_torch_pairs.py.
"""
import numpy as np
import pytest
import torch

from sph_project_tpu.core.params import make_params as jax_make_params
from sph_project_tpu.ops.pairs import slab_pack
from sph_project_tpu.solvers import pcisph as jpcisph

from sph_project_tpu_torch.core.params import make_params
from sph_project_tpu_torch.solvers import pcisph as tpcisph

from test_torch_pairs import Setup, assert_pass_close
from test_torch_scene import box_config
from test_torch_wcsph import STEPS, run_steps_against_jax


@pytest.fixture(scope="module", params=["pallas_dma", "pallas"],
                ids=["cell_list", "slab_window"])
def box(request):
    return Setup(box_config(), engine=request.param)


@pytest.mark.parametrize("dim,kw", [
    (3, {}), (2, {}), (3, dict(particle_radius=0.005, dt=4e-4)),
], ids=["3d", "2d", "3d_fine"])
def test_compute_pcisph_k_matches_jax(dim, kw):
    j = jpcisph.compute_pcisph_k(jax_make_params(1000, dim=dim, **kw))
    t = tpcisph.compute_pcisph_k(make_params(1000, dim=dim, **kw))
    assert j < 0 and abs(t - j) <= 1e-12 * abs(j)


def test_density_star_predicted_pass(box):
    n = box.params.n_pad
    rng = np.random.default_rng(3)
    fluid = np.asarray(box.jp.material) == 1
    pos = np.asarray(box.jp.pos)
    # displacements of up to 0.3 particle radius per axis: lattice pairs at
    # the support radius in the sorted positions move inside and outside it
    shift = rng.uniform(-0.003, 0.003, (n, 3)).astype(np.float32)
    pred = np.where(fluid[:, None], pos + shift, pos).astype(np.float32)
    pred_slab = slab_pack(box.jenv, {"x": pred})["x"]
    j_star, j_err = jpcisph._density_star_predicted(
        box.jp, pred, pred_slab, box.jenv, box.jsl, box.jparams)
    t_star, t_err = tpcisph.density_star_predicted(
        box.tp, torch.from_numpy(pred[box.perm]), box.tenv, box.params)
    # the error is the positive part of rho*/rho0 - 1 without the self term
    # (as the JAX package takes it): 0 on this state, compared all the same
    assert np.asarray(j_star).max() > 0
    assert_pass_close(t_star.numpy(), box.j(j_star), "predicted density")
    assert_pass_close(float(t_err), float(j_err), "density error")


@pytest.mark.parametrize("overrides", [{}, dict(pair_backend="pallas")],
                         ids=["cell_list", "slab_window"])
def test_pcisph_steps_match_jax(overrides):
    iters = run_steps_against_jax("pcisph", **overrides)
    assert len(iters) == STEPS and sum(iters) > STEPS

"""PBF steps of the port against the JAX package's, 3D.

Both packages load one scene and step it on the CPU, the JAX package with
``pair_block=1`` (whose slab executor then takes the step-start grid's
candidates, as the port's engines do: tests/test_torch_pbf.py), the port
under its cell-list engine.

On the 3D dam break (tests/test_solvers.py's, PBF, ``pbfCorrK`` 0, dt 5e-4)
one step keeps every fluid particle within 1e-5 of the JAX package's
(measured 1.9e-6). The configuration is chaotic (the reference's 2D-tuned
PBF in 3D: velocities of 40-160 m/s, densest particles at 1.2-1.4 rho0), and
float32 rounding differences grow 4-15x a step (3.0e-5 after two steps,
4e-2 after 20, measured), so the 20 steps are held to the same diagnostics
keys, finite positions inside the domain and a mean density within 1% of
the JAX package's at every step (measured within 0.34%).
"""
import numpy as np

from sph_project_tpu import sim as jsim

from sph_project_tpu_torch import sim as tsim

from test_torch_dfsph import fluid_pos, nn_dist
from test_torch_pbf import dam_config
from test_torch_scene import load_both


def run_against_jax(config, steps, engine="pallas_dma", jax_block=1,
                    **overrides):
    """``steps`` PBF steps in both packages; per step the port's and the
    JAX package's diagnostics and the largest nearest-neighbour distance of
    the fluid."""
    js, jst, ts, tst = load_both(
        config, port_kw=dict(overrides, pair_block=64, pair_backend=engine),
        pair_block=jax_block, pair_chunk=256 if jax_block == 1 else 32,
        **overrides)
    jax_sim = jsim.Simulation(js, jst)
    port = tsim.Simulation(ts, tst, device="cpu")
    out = []
    for _ in range(steps):
        jd, td = jax_sim.step(), port.step()
        assert set(td) == set(jd)
        assert int(td["solver_iters"]) == int(jd["solver_iters"]) == \
            ts.params.pbf_iters
        tp, jp = port.state.particles, jax_sim.state.particles
        a = fluid_pos(tp.pos.numpy(), tp.material.numpy())
        b = fluid_pos(jp.pos, jp.material)
        assert a.shape == b.shape and np.isfinite(a).all()
        out.append((td, jd, float(nn_dist(a, b).max()), a))
    return ts.params, out


def test_dam_break_one_step():
    _, out = run_against_jax(dam_config(), 1)
    assert out[0][2] < 1e-5, f"trajectory drift {out[0][2]:.2e}"


def test_dam_break_twenty_steps():
    params, out = run_against_jax(dam_config(), 20)
    lo = np.asarray(params.domain_start) + params.padding
    hi = np.asarray(params.domain_end) - params.padding
    for s, (td, jd, _, a) in enumerate(out):
        assert (a >= lo - 1e-6).all() and (a <= hi + 1e-6).all(), s
        rel = abs(float(td["density_avg"]) / float(jd["density_avg"]) - 1.0)
        assert rel < 1e-2, f"step {s}: density_avg off by {rel:.2e}"
    assert out[0][2] < 1e-5


def test_smoke_scene_steps():
    """smoke_test.json under a PBF override (the cubic kernel, s_corr on,
    dt 1 ms): the first step's mean density equal to the JAX package's
    (measured 1.2e-7 relative); its fluid, at velocities of 150 m/s after
    one step, within 1e-3 (measured 1.1e-4)."""
    from test_torch_scene import _scene_config
    _, out = run_against_jax(_scene_config("smoke_test.json"), 1,
                             simulation_method="pbf")
    td, jd, d, _ = out[0]
    assert abs(float(td["density_avg"]) / float(jd["density_avg"]) - 1) < 1e-5
    assert d < 1e-3, f"trajectory drift {d:.2e}"


def test_emitter_column_steps():
    """tests/test_torch_emitter.py's emitter column (a fluid column falling
    at 2 m/s through the emitter height 0.2 in the domain box) under a PBF
    override with standard viscosity (PBF with implicit viscosity:
    tests/test_torch_kinds_steps_pbf_implicit.py): the placeholders advect
    and turn fluid through the PBF step. Ten steps with the fluid count
    equal at every step and growing, the first step's mean density equal
    (measured 2e-7 relative) and its fluid within 1e-3 (measured 6.8e-5: the
    fluid reaches the speed cap, 200 m/s, in this first step)."""
    from test_torch_emitter import column_config
    params, out = run_against_jax(column_config("standard"), 10,
                                  simulation_method="pbf")
    assert params.has_entries and params.kernel_type == "cubic"
    counts = [int(td["fluid_num"]) for td, _, _, _ in out]
    assert counts == [int(jd["fluid_num"]) for _, jd, _, _ in out]
    assert 0 < counts[0] < counts[-1]
    td, jd, d, _ = out[0]
    assert abs(float(td["density_avg"]) / float(jd["density_avg"]) - 1) < 1e-5
    assert d < 1e-3, f"trajectory drift {d:.2e}"


def test_cube_pool_step(tmp_path):
    """tests/test_torch_rigid_steps.py's cube dropped onto a pool, under PBF:
    the step's dynamic-body tail (the viscosity wrench of the non-pressure
    pass, which no rigid solve consumes in a PBF step, and the bodies'
    volumes at the final positions). One step: the fluid within 1e-3
    (measured 2.5e-4: the pool at rest reads 0.65 rho0 under poly6, and its
    first projection moves it violently, as on the walled box), the cube's
    accumulated force within 1e-4 of the largest component, its particles'
    volumes (sorted) within 1e-6 relative."""
    from test_rigid import write_cube_obj
    from test_torch_rigid_steps import cube_pool_config
    cube = write_cube_obj(str(tmp_path / "cube6.obj"), size=0.06)
    js, jst, ts, tst = load_both(
        cube_pool_config(cube, "pbf"),
        port_kw=dict(pair_block=64), pair_block=1, pair_chunk=256)
    assert ts.params.has_dynamic_rigid
    jax_sim = jsim.Simulation(js, jst)
    port = tsim.Simulation(ts, tst, device="cpu")
    jax_sim.step()
    port.step()
    tp, jp = port.state.particles, jax_sim.state.particles
    a = fluid_pos(tp.pos.numpy(), tp.material.numpy())
    b = fluid_pos(jp.pos, jp.material)
    assert nn_dist(a, b).max() < 1e-3
    jf = np.asarray(jax_sim.state.rigid.force)[1]
    tf = port.state.rigid.force.numpy()[1]
    assert np.abs(jf).max() > 0
    np.testing.assert_allclose(tf, jf, atol=1e-4 * np.abs(jf).max())

    def volumes(p):
        m = np.asarray(p.material)
        dyn = (m == 2) & (np.asarray(p.is_dynamic) > 0)
        return np.sort(np.asarray(p.rest_volume)[dyn])

    np.testing.assert_allclose(volumes(tp), volumes(jp), rtol=1e-6)

"""``ops/graph_loop.py`` on the CPU: its host loop against
``jax.lax.while_loop``, the launch accounting of replays, the state copy of
the captured step, ``Simulation.run`` against ``step``, and the capture
helpers refusing a host without CUDA.

The WHILE node itself (the conditional node of a captured step) runs only
on the card: ``chip_smoke.py`` holds the graphed step bit-equal to the eager
one there."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sph_project_tpu_torch import sim as tsim
from sph_project_tpu_torch.ops import graph_loop
from sph_project_tpu_torch.scene import load_scene as torch_load_scene
from sph_project_tpu_torch.utils.config import SimConfig as TorchSimConfig

from test_torch_scene import box_config

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, tolerance, iteration cap, iterations before the loop, error at
# entry): the cold correctors' at-least-once rule with the error at +inf;
# the cap reached; the warm correctors' entry with one iteration counted and
# the error already under the tolerance (false at entry); the CG's shape,
# whose rule has no at-least-once term, with the error under the tolerance
LOOPS = (("at_least_once", 0.05, 50, 0, np.inf),
         ("cap", 1e-30, 7, 0, np.inf),
         ("warm_met", 0.05, 50, 1, 0.01),
         ("cg_met", 0.05, 50, 0, 0.01))


def _loop_fns(xp, tol, cap, at_least_once, rate):
    """cond and body of a corrector-shaped loop over (x, err, itr), written
    once for jnp and torch: x decays towards a target at ``rate``, the
    error is the mean of |x - target|."""

    def cond(c):
        _, err, itr = c
        more = (err > tol) & (itr < cap)
        return (itr < 1) | more if at_least_once else more

    def body(c):
        x, _, itr = c
        x = x * rate + (1.0 - rate) * 0.25
        err = xp.mean(xp.abs(x - 0.25))
        return x, err, itr + 1

    return cond, body


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("name,tol,cap,itr0,err0", LOOPS)
def test_while_loop_matches_jax(name, tol, cap, itr0, err0, seed):
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(-1.0, 1.0, size=(64, 3)).astype(np.float32)
    rate = np.float32(rng.uniform(0.3, 0.7))
    at_least_once = not name.startswith("cg")
    jcond, jbody = _loop_fns(jnp, tol, cap, at_least_once, rate)
    jx, jerr, jitr = jax.lax.while_loop(
        jcond, jbody, (jnp.asarray(x0), jnp.float32(err0), jnp.int32(itr0)))
    tcond, tbody = _loop_fns(torch, tol, cap, at_least_once, float(rate))
    tx, terr, titr = graph_loop.while_loop(
        tcond, tbody, (torch.from_numpy(x0),
                       torch.tensor(err0, dtype=torch.float32),
                       torch.tensor(itr0, dtype=torch.int32)))
    assert titr.dtype == torch.int32 and terr.dtype == torch.float32
    assert int(titr) == int(jitr)
    if name == "cap":
        assert int(titr) == cap
    elif name.endswith("met"):
        assert int(titr) == itr0       # no iteration ran
        assert np.array_equal(tx.numpy(), x0)
    else:
        assert int(titr) > 1 and float(terr) <= tol
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(float(terr), float(jerr), rtol=1e-6)


def test_while_loop_checks_cond():
    carry = (torch.zeros(3),)
    with pytest.raises(ValueError, match="0-dim"):
        graph_loop.while_loop(lambda c: c[0] > 0, lambda c: c, carry)
    with pytest.raises(ValueError, match="0-dim"):
        graph_loop.while_loop(lambda c: c[0].sum(), lambda c: c, carry)


def test_warming_runs_a_loop_body_once():
    """Before a capture, a loop that runs no iteration runs its body once,
    result dropped (its kernels and constants loaded); otherwise not."""
    calls = []

    def body(c):
        calls.append(1)
        return (c[0] + 1,)

    never = (lambda c: torch.tensor(False))
    out = graph_loop.while_loop(never, body, (torch.zeros(()),))
    assert calls == [] and float(out[0]) == 0.0
    with graph_loop.warming():
        out = graph_loop.while_loop(never, body, (torch.zeros(()),))
        assert calls == [1] and float(out[0]) == 0.0
        out = graph_loop.while_loop(lambda c: c[0] < 2, body,
                                    (torch.zeros(()),))
    assert calls == [1, 1, 1] and float(out[0]) == 2.0


def test_assign_is_simultaneous():
    """The carry written back in place: a new value that is another
    buffer (a swap) is copied aside first."""
    a, b = torch.arange(4.0), torch.arange(4.0) + 10
    graph_loop._assign((a, b), (b, a))
    assert a.tolist() == [10, 11, 12, 13] and b.tolist() == [0, 1, 2, 3]
    c = torch.zeros(2)
    with pytest.raises(ValueError, match="changed a carry"):
        graph_loop._assign((c,), (torch.zeros(3),))
    with pytest.raises(ValueError, match="values for a carry"):
        graph_loop._assign((c,), (c, c))


def test_replay_accounting():
    """Launches outside the loops count once per replay on the host; each
    loop's iterations come from its device count at the flush, times the
    launches of one iteration, and the count is zeroed."""
    counts = {"k_outer": 0, "k_body": 0}
    graph_loop.register_counts(counts)
    try:
        rec = graph_loop.Captured()
        n = len(graph_loop._counted)
        outer = [{} for _ in range(n)]
        outer[-1] = {"k_outer": 2}
        body = [{} for _ in range(n)]
        body[-1] = {"k_body": 3}
        body[0] = {"graph_while": 1}
        rec.outer = outer
        rec.counters = torch.zeros(graph_loop.MAX_LOOPS, dtype=torch.int64)
        iters = rec.counters[0]
        rec.loops = [(iters, body)]
        before = graph_loop.launches["graph_while"]
        rec.replayed()
        rec.replayed()
        assert counts == {"k_outer": 4, "k_body": 0}
        iters += 5                     # five iterations over both replays
        graph_loop.flush_launches()
        assert counts == {"k_outer": 4, "k_body": 15}
        assert graph_loop.launches["graph_while"] == before + 5
        assert int(iters) == 0 and not graph_loop._pending
        graph_loop.flush_launches()    # nothing pending: no change
        assert counts == {"k_outer": 4, "k_body": 15}
        with graph_loop.uncounted():
            counts["k_outer"] += 7
        assert counts["k_outer"] == 4
    finally:
        graph_loop._counted.remove(counts)
        graph_loop.launches["graph_while"] = before


def test_capture_raises_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA device")
    with pytest.raises(RuntimeError, match="CUDA"):
        graph_loop.capture(lambda: None)
    assert not graph_loop.capturing(torch.zeros(()))


def _box(method, **overrides):
    scene, state = torch_load_scene(
        config=TorchSimConfig(config=box_config(method)), **overrides)
    return scene, state


def test_copy_state_writes_in_place():
    scene, state = _box("dfsph")
    sim = tsim.Simulation(scene, state, device="cpu")
    dst = tsim._cloned(sim.state)
    ptrs = [t.data_ptr() for _, t in tsim._tensors(dst)]
    sim.step()
    # one value that is a view of another buffer of the destination
    src = sim.state.replace(dfsph_kappa=dst.dfsph_alpha[:],
                            dfsph_alpha=sim.state.dfsph_alpha)
    want = {p: t.clone() for p, t in tsim._tensors(src)}
    tsim.copy_state(dst, src)
    assert [t.data_ptr() for _, t in tsim._tensors(dst)] == ptrs
    for p, t in tsim._tensors(dst):
        assert torch.equal(t, want[p]), ".".join(p)
    with pytest.raises(ValueError, match="structure"):
        tsim.copy_state(dst, src.replace(cached_neighbors=None))
    with pytest.raises(ValueError, match="buffer"):
        tsim.copy_state(dst, src.replace(t=src.t.double()))


@pytest.mark.parametrize("method,overrides", [
    ("dfsph", {}),
    ("dfsph", dict(dfsph_warm_start=True, dfsph_warm_start_div=True)),
    ("wcsph", {}), ("pcisph", {}), ("iisph", {}),
    ("dfsph", dict(viscosity_method="implicit", viscosity=500.0,
                   viscosity_b=500.0))])
def test_run_equals_steps(method, overrides):
    """``Simulation.run(n)`` on the CPU is n calls of ``step()``: the
    diagnostics stacked per step and the final state, bit for bit."""
    n = 4
    runs = []
    for stepped in (False, True):
        scene, state = _box(method, **overrides)
        sim = tsim.Simulation(scene, state, device="cpu")
        if stepped:
            diags = [sim.step() for _ in range(n)]
            out = {k: torch.stack([d[k] for d in diags]) for k in diags[0]}
        else:
            out = sim.run(n)
        runs.append((out, sim.state))
    (ra, sa), (rb, sb) = runs
    assert set(ra) == set(rb)
    for k in ra:
        assert ra[k].shape == (n,) and torch.equal(ra[k], rb[k]), k
    assert int(sa.step_count) == n
    for (p, a), (_, b) in zip(tsim._tensors(sa), tsim._tensors(sb)):
        assert torch.equal(a, b), ".".join(p)

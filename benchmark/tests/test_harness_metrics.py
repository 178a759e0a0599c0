"""The per-layer readers on a synthetic trace, the trace arithmetic, and
the byte and operation counts on small shapes against hand counts."""
import json
import os

import pytest

import counts
import harness
import bench_trace
from conftest import BENCH, ROOT

FAM = bench_trace.Families(os.path.join(BENCH, "families.json"))
WORK = dict(pairs=1000, wall_pairs=100, rows_read=60, n=80, cells=9)


def rec(**over):
    kernels = [
        ("void pair_kernel<Density<Cubic, 3> >(PairArgs, int)", 0, 400_000),
        ("void pair_kernel<CorrectionAt<false, 4, 3, Cubic, 3> >(PairArgs, "
         "int)", 500_000, 1_000_000),
        ("permute_kernel", 1_000_000, 1_100_000),
        ("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int>",
         1_200_000, 1_300_000),
        ("void at::native::searchsorted_cuda_kernel<int>", 1_300_000,
         1_350_000),
        ("void at::native::vectorized_elementwise_kernel<4>", 1_350_000,
         1_400_000),
    ]
    r = dict(steps=2, wall_s=2e-3, busy_s=bench_trace.union_ns(
        [(s, e) for _, s, e in kernels]) / 1e9, kernels=kernels,
        families=FAM, diags=[{"solver_iters": 3.0, "div_iters": 1.0},
                             {"solver_iters": 5.0, "div_iters": 1.0}],
        cg_iters=None, work=WORK, gather_words=16)
    r.update(over)
    return r


def read(name, r):
    return harness.metric_reader(BENCH, name)(r)


def test_families():
    names = [k[0] for k in rec()["kernels"]]
    assert [FAM(n) for n in names] == ["pair:density", "pair:correction",
                                       "gather", "sort", "cell_table",
                                       "elementwise"]
    assert FAM.body("void pair_kernel<ViscMatvec<Cubic, 3> >(PairArgs, "
                    "int)") == "visc_matvec"
    assert FAM("void graph_loop::while_cond_kernel") == "graph_loop"


def test_union_and_gaps():
    assert bench_trace.union_ns([(0, 10), (5, 20), (30, 40)]) == 30
    dev = [("k", 0, 10), ("k", 15, 20)]
    spans = [("bench.read", 9, 16), ("bench.replay", 16, 40)]
    gaps = bench_trace.idle_gaps(dev, spans, 0, 30)
    assert gaps == [("bench.replay", 10e-9), ("bench.read", 5e-9)]


def test_readers():
    r = rec()
    busy = (0.4e6 + 0.5e6 + 0.1e6 + 0.1e6 + 0.05e6 + 0.05e6) / 1e9
    assert read("device_idle", r) == pytest.approx(100 * (1 - busy / 2e-3))
    assert read("pair_ms", r) == pytest.approx(0.9 / 2)
    assert read("sort_ms", r) == pytest.approx(0.15 / 2)
    assert read("solver_iters", r) == pytest.approx(5.0)
    assert read("cg_iters", r) is None
    assert read("cg_iters", rec(cg_iters=[40, 44])) == 42.0
    bound = counts.bound_s(*counts.pair_work("density", WORK)) + \
        counts.bound_s(*counts.pair_work("correction", WORK))
    assert read("pair_roofline", r) == pytest.approx(100 * bound / 0.9e-3)
    g = 100 * counts.gather_bytes(16, 80) / counts.HBM_BYTES_PER_S / 1e-4
    assert read("gather_roofline", r) == pytest.approx(g)


def test_readers_find_nothing():
    r = rec(kernels=[], busy_s=0.0, diags=[])
    for m in ("device_idle", "pair_ms", "pair_roofline", "sort_ms",
              "gather_roofline", "solver_iters", "cg_iters"):
        assert read(m, r) is None, m


def test_every_per_layer_metric_has_a_reader():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        man = json.load(f)
    for m in man["per_layer"]:
        assert callable(harness.metric_reader(BENCH, m["name"]))


def test_counts_by_hand():
    # density: 4 words a row read on 60 rows, cells (80 int32), the cell
    # table (10 int32), the produce mask (80 bytes), one output (80 float)
    b, ops = counts.pair_work("density", WORK)
    assert b == 4 * 4 * 60 + 4 * 80 + 4 * 10 + 80 + 4 * 80
    assert ops == 1000 * (8 + 15)
    # the matvec: 8 geometry ops a pair, 36 more with a fluid neighbour,
    # 1 with a wall
    _, ops = counts.pair_work("visc_matvec", WORK)
    assert ops == 1000 * 8 + 900 * 36 + 100 * 1
    assert counts.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert counts.bound_s(0, 67e12) == pytest.approx(1.0)
    assert counts.gather_bytes(16, 10) == 2 * 4 * 16 * 10 + 8 * 10

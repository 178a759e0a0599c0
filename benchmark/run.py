"""Run one cell of the benchmark once and print its result as one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cells, their configurations, traffic
mixes, limits and metrics are named in ``BENCHMARK.json``. With ``--trace
0`` the result carries the cell's end-to-end metrics, with ``--trace 1`` its
per-layer metrics, read from one segment replayed under ``torch.profiler``
(and ``busy_s``, ``window_s`` and a ``breakdown``). The compared numbers
and their limits end standard error and, under ``checks``, the result.

Exits with 2, printing no result, without a CUDA device (there is no
fallback to the CPU), and with 3 when a module of JAX or of the JAX package
was loaded by the end of the run.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # the program's caches stay inside the checkout, at fixed paths
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ.setdefault(var, os.path.join(ROOT, "build", sub))
    sys.path[:0] = [HERE, ROOT]
    import torch
    import harness

    chips = harness.load_cell(ROOT, args.workload)["cell"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run.py: the cell needs {chips} CUDA device(s); this host "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = harness.run_cell(ROOT, args.workload, args.seed, args.seconds,
                              bool(args.trace), T0)
    found = harness.foreign_modules()
    if found:
        print(f"run.py: modules of JAX or the JAX package were loaded: "
              f"{found}", file=sys.stderr)
        return 3
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())

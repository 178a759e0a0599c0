"""The control of the comparison that decides ``correct``: the plain
reference put in the program's place and computed in bfloat16, the
precision below the configurations' float32. Its step must come out as not
correct under every cell's limits.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...]

runs on the card, at the cell's own size, for each seed: the cell's set-up
and a short window (one segment's first steps), then the numbers of the
program's step and of the control's, each against the float64 reference
from the same start state, one JSON line per seed. The benchmark's own runs
never run it; the limits in ``checks/<cell>.json`` were set from its
readings (``PERF.md``).
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)



def control_step(start: dict, ph, ref, dtype=None) -> dict:
    """The step of the reference module ``ref`` from ``start`` in ``dtype``
    (bfloat16), its rows sorted by grid cell as the program sorts them, as
    float64."""
    import torch

    import check
    dtype = dtype or torch.bfloat16
    out = ref.step(start, ph, dtype=dtype)
    out = {k: (v.double() if torch.is_tensor(v) and v.is_floating_point()
               else v) for k, v in out.items()}
    return check.sort_rows(out, ph)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=0.5)
    args = ap.parse_args(argv)
    sys.path[:0] = [HERE, ROOT]
    import torch

    import check
    import harness
    if not torch.cuda.is_available():
        print("control.py: no CUDA device", file=sys.stderr)
        return 2
    spec = harness.load_cell(ROOT, args.workload)
    for seed in args.seeds:
        t0 = time.perf_counter()
        cell = harness.Cell(spec, seed)
        cell.setup(t0, False)
        cell.window(args.seconds)
        cell.free()
        prog = cell.reference_check()
        t = time.perf_counter()
        ctl = control_step(cell.start_state(), cell.ph, cell.ref_mod)
        ctl_s = time.perf_counter() - t
        ctl_nums = check.compare(ctl, cell.reference(), cell.ph)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": prog, "control": ctl_nums,
                          "reference_iters": cell.ref_iters,
                          "control_iters": [ctl.get(k) for k in
                                            check.ITERS + ("cg_iters",)],
                          "reference_s": cell.timings["reference_s"],
                          "control_s": ctl_s}), flush=True)
        del cell
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Time the fused gather (``csrc/permute.cu``) on the shapes the port gives it.

Loads the flagship ``large_scale_dfsph.json`` at full size with both DFSPH
warm starts, runs ``STEPS`` steps on the card, and takes the next step's sort
as ``chip_smoke.py`` phase 4 does: positions advanced, binned, the stable
sort's permutation. Then, with CUDA events back to back, ``REPS`` launches
each:

- ``flagship_cold``: the 10 fields a cold DFSPH step carries (16 words a
  row) and ``flagship_warm``: the 12 of a warm one (18 words);
- ``resort_pack`` / ``resort_unpack``: the global resort as rank 1 of 4
  takes it (``parallel/spatial.py`` ``global_resort``; the cell ids and the
  10 cold fields): its own rows packed into its (n / 4, W) int32 buffer,
  and its slice of the sorted state gathered from the all-gathered (n, W)
  buffer of every rank's rows. A checkout from before that resort
  (``spatial.resort_plan``, an all-to-all of the rows that move) times the
  sort's shapes only.

One JSON line per shape. Each timed call has three numbers
(``tools/cuda_timing.py``): ``ms``, back to back with the host's time per
call, as ``chip_smoke.py`` times every kernel; ``device_ms``, behind a sleep
on the stream, the device's time alone; ``host_us``, the host's time per
call. Timed: ``gather`` (``permute_fields`` on fields), ``kernel`` (for the
pack and the unpack ``permute_pack`` / ``permute_unpack`` where the
checkout has them, else null), ``composition`` (the pack and the unpack as
``pack_words`` after ``permute_fields``, ``permute_fields`` after
``unpack_words``) and ``index_select`` (once per field). Beside them
``copy_device_ms`` (one ``Tensor.copy_`` of as many words: what the card
moves at best), ``bound_ms`` (each word read and written once plus the
permutation, over the memory rate) and the card's name and power limit.
The outputs are checked bit-equal to ``index_select``.

    python3 tools/bench_gather.py [--label TEXT] [--root DIR]

``--root`` times the package of another checkout (for example the parent
commit unpacked under ``build/``) on the same scene file, so two designs can
be timed one after the other on one card.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import torch

from cuda_timing import bound_ms, cuda_ms, led_ms, nbytes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
STEPS = 2
# calls a timing: back to back, and behind the sleep
REPS, LED_REPS = 20, 50
RANK, RANKS = 1, 4


def times(fn) -> dict:
    device_ms, host_us = led_ms(fn, LED_REPS)
    return {"ms": cuda_ms(fn, REPS), "device_ms": device_ms,
            "host_us": host_us}


def bits(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(torch.int32)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--label", default="")
    ap.add_argument("--root", default=ROOT)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("bench_gather: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.abspath(args.root))
    from sph_project_tpu_torch import sim as simlib
    from sph_project_tpu_torch.core.params import MATERIAL_NONE
    from sph_project_tpu_torch.ops import neighbors as nblib
    from sph_project_tpu_torch.ops import permute as permlib
    from sph_project_tpu_torch.parallel import spatial
    from sph_project_tpu_torch.scene import load_scene
    from sph_project_tpu_torch.solvers import common

    card = subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    scene, state = load_scene(
        os.path.join(ROOT, "data", "scenes", "large_scale_dfsph.json"),
        dfsph_warm_start=True, dfsph_warm_start_div=True)
    sim = simlib.Simulation(scene, state)
    for _ in range(STEPS):
        sim.step()
    torch.cuda.synchronize()
    params, st = sim.params, sim.state
    p = common.enforce_domain_boundary(
        common.update_fluid_position(st.particles, st.rigid, params), params)
    cells = nblib.flat_cell_ids(p.pos, p.material != MATERIAL_NONE, params)
    perm = nblib.sort_permutation(cells)
    keys, extras = simlib.permuted_keys(params)
    cold = {k: getattr(p, k) for k in keys}
    cold["cells"] = cells
    warm = dict(cold, **{k: getattr(st, k) for k in extras})

    def line(shape, idx, src, rows, kernel=None, composition=None, want=None,
             moved=None):
        """One shape's times; ``moved``: the fields whose bytes the call
        must read and write once (``src`` unless given)."""
        moved = src if moved is None else moved
        lib = {k: torch.index_select(v, 0, idx) for k, v in src.items()}
        out = permlib.permute_fields(idx, src)
        ok = all(torch.equal(bits(out[k]), bits(lib[k])) for k in src)
        del lib, out
        flat = torch.empty(nbytes(moved.values()) // 4, dtype=torch.int32,
                           device=idx.device)
        copy = torch.empty_like(flat)
        rec = {"card": card, "label": args.label, "shape": shape,
               "fields": len(src), "rows": rows,
               "words": sum(v[0].numel() for v in src.values()),
               "gather": times(lambda: permlib.permute_fields(idx, src)),
               "kernel": None, "composition": None,
               "index_select": times(lambda: [torch.index_select(v, 0, idx)
                                              for v in src.values()]),
               "copy_device_ms": led_ms(lambda: copy.copy_(flat),
                                        LED_REPS)[0],
               "bound_ms": bound_ms(2 * nbytes(moved.values())
                                    + nbytes([idx]), 0)[0]}
        del flat, copy
        if kernel is not None:
            got = kernel()
            ok = ok and all(torch.equal(bits(g), bits(w))
                            for g, w in zip(got, want))
            rec["kernel"] = times(kernel)
        if composition is not None:
            rec["composition"] = times(composition)
        rec["bit_equal"] = ok
        print(json.dumps(rec), flush=True)
        return ok

    ok = line("flagship_cold", perm, cold, params.n_pad)
    ok &= line("flagship_warm", perm, warm, params.n_pad)

    # the resort as rank RANK of RANKS takes it (chip_smoke.py phase 9c)
    if hasattr(spatial, "resort_plan"):
        return 0 if ok else 1
    nl = params.n_pad // RANKS
    rows = {"cells": cells, **cold}
    mine = perm[RANK * nl:(RANK + 1) * nl]
    own = torch.arange(nl, device=perm.device)
    local = {k: v[RANK * nl:(RANK + 1) * nl].contiguous()
             for k, v in rows.items()}
    words = permlib.pack_words(rows)
    ok &= line("resort_pack", own, local, nl,
               lambda: [permlib.permute_pack(own, local)],
               lambda: permlib.pack_words(permlib.permute_fields(own, local)),
               [permlib.pack_words(local)])
    ok &= line("resort_unpack", mine, rows, nl,
               lambda: list(permlib.permute_unpack(mine, words,
                                                   rows).values()),
               lambda: permlib.permute_fields(
                   mine, permlib.unpack_words(words, rows)),
               [v[mine] for v in rows.values()], moved=local)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())

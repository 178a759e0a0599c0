"""Checkpoint / resume for SimState.

The JAX package's ``io/checkpoint.py`` file layout: one compressed
``state.npz`` holding ``__names__`` (an object array of leaf names) and
``leaf_<i>``, one array per leaf, named by the JAX tree path
(``.particles/.pos``, ``.rigid/.com``, ``.step_count``). A state saved by
either package restores in the other: leaves match by name, and a JAX
file's ``.cached_neighbors/...`` leaves (its pair engine's tables) are not
the port's and are dropped with a warning.

The port's pair environment is derived from the state, so :func:`restore`
rebuilds it from the restored positions instead of reading it: the rows are
put in the port's sorted layout (a no-op for the port's own files, whose
rows are sorted already) and the environment of the scene's engine is built
over them. Nothing else is recomputed, so a resumed run steps exactly as
the uninterrupted one.
"""
from __future__ import annotations

import os
import warnings

import numpy as np
import torch

from .. import bridge
from .. import sim as simlib
from ..core.params import MATERIAL_NONE, SimParams
from ..core.state import SimState
from ..ops import neighbors as nblib
from ..ops import permute as permlib


def _leaf_name(path) -> str:
    """The JAX tree-path name of a field path: ``.particles/.pos``."""
    return "/".join(f".{k}" for k in path)


def save(path: str, state: SimState) -> None:
    os.makedirs(path, exist_ok=True)
    leaves = list(bridge.walk(state))
    arrays = {f"leaf_{i}": v.cpu().numpy() for i, (_, v) in enumerate(leaves)}
    np.savez_compressed(os.path.join(path, "state.npz"),
                        __names__=np.asarray([_leaf_name(p) for p, _ in leaves],
                                             dtype=object),
                        **arrays)


def restore(path: str, template: SimState, params: SimParams) -> SimState:
    """Restore into the structure of ``template``, matching leaves BY NAME:
    a leaf the file lacks keeps the template's value, a leaf the template
    lacks is dropped (each with a warning), a shape mismatch raises, and no
    common leaf at all raises. Restored tensors take the template's device
    and dtype. The rows are then sorted by cell and ``cached_neighbors`` is
    the environment of ``params``' engine over them."""
    with np.load(os.path.join(path, "state.npz"), allow_pickle=True) as z:
        names = list(z["__names__"])
        by_name = {str(n): z[f"leaf_{i}"] for i, n in enumerate(names)}
    leaves = list(bridge.walk(template))
    t_names = [_leaf_name(p) for p, _ in leaves]
    if not set(t_names) & set(by_name):
        raise ValueError(
            f"checkpoint structure mismatch: no common leaves between "
            f"{sorted(by_name)[:3]}... and {t_names[:3]}...")
    arrays = {}
    for name, (p, tval) in zip(t_names, leaves):
        if name in by_name:
            a = by_name.pop(name)
            if tuple(a.shape) != tuple(tval.shape):
                raise ValueError(
                    f"checkpoint leaf {name} shape {a.shape} != "
                    f"template {tuple(tval.shape)}")
            arrays[p] = torch.from_numpy(np.array(a)).to(
                device=tval.device, dtype=tval.dtype)
        else:
            warnings.warn(f"checkpoint missing leaf {name}; "
                          f"keeping template value (new state field)")
            arrays[p] = tval
    if by_name:
        warnings.warn(f"checkpoint leaves not in template (dropped): "
                      f"{sorted(by_name)[:5]}")
    return _sorted_with_env(bridge.build(arrays), params)


def _sorted_with_env(state: SimState, params: SimParams) -> SimState:
    """Rows sorted by cell (the arrays a step carries across its sort, with
    the same stable sort, so that a resumed run goes on bit for bit, also in
    the arrays a step leaves where they are), then the pair environment over
    them."""
    p = state.particles
    cells = nblib.flat_cell_ids(p.pos, p.material != MATERIAL_NONE, params)
    perm = nblib.sort_permutation(cells)
    if not torch.equal(perm, torch.arange(params.n_pad, device=perm.device)):
        keys, extras = simlib.permuted_keys(params)
        carried = {("particles", k) for k in keys} | {(k,) for k in extras}
        rows = {k: v for k, v in bridge.walk(state) if k in carried}
        out = permlib.permute_fields(perm, {".".join(k): v
                                            for k, v in rows.items()})
        arrays = dict(bridge.walk(state))
        arrays.update({k: out[".".join(k)] for k in rows})
        state = bridge.build(arrays)
        cells = cells[perm]
    p = state.particles
    produce = simlib.produces_output(p, state.rigid, params)
    return state.replace(cached_neighbors=simlib.build_env(cells, produce,
                                                           params))

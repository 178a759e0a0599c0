"""Carry a simulation state across packages as a flat dict of numpy arrays.

``state_from_numpy`` builds the port's state from arrays named
``particles.<field>``, ``rigid.<field>`` and ``<field>`` (the SimState
arrays), which is how the JAX package's state flattens (the test code does
that flattening, so this module imports nothing of JAX). ``state_to_numpy``
is the inverse for the port's own state. Arrays are copied row for row and
keep their dtypes. :func:`walk` is the field walk both use, and the
checkpoint module names its leaves by it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterator, Tuple

import numpy as np
import torch

from .core.params import SimParams
from .core.state import ParticleState, RigidState, SimState

_GROUPS = {"particles": ParticleState, "rigid": RigidState}


def _names(cls) -> list:
    return [f.name for f in dataclasses.fields(cls) if f.name != "cached_neighbors"]


def paths() -> Iterator[Tuple[str, ...]]:
    """Every array of a SimState as its path, ``("particles", "pos")`` or
    ``("t",)``, in the order of the dataclass fields, which is the order the
    JAX package's state flattens in. The pair environment of the last sort
    (``cached_neighbors``) is derived from the state and is no part of it."""
    for name in _names(SimState):
        if name in _GROUPS:
            for field in _names(_GROUPS[name]):
                yield (name, field)
        else:
            yield (name,)


def walk(state: SimState) -> Iterator[Tuple[Tuple[str, ...], torch.Tensor]]:
    """``(path, tensor)`` for every array of ``state`` (see :func:`paths`)."""
    for path in paths():
        obj = state
        for key in path:
            obj = getattr(obj, key)
        yield path, obj


def build(arrays: Dict[Tuple[str, ...], torch.Tensor]) -> SimState:
    """The SimState whose array at each path of :func:`paths` is
    ``arrays[path]``."""
    groups = {g: cls(**{f: arrays[(g, f)] for f in _names(cls)})
              for g, cls in _GROUPS.items()}
    rest = {p[0]: arrays[p] for p in paths() if len(p) == 1}
    return SimState(**groups, **rest)


def state_from_numpy(arrays: Dict[str, np.ndarray], params: SimParams,
                     device="cpu") -> SimState:
    """The port's SimState from flattened arrays (see module docstring)."""
    def t(key):
        a = np.asarray(arrays[key])
        return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)

    state = build({p: t(".".join(p)) for p in paths()})
    if state.particles.pos.shape != (params.n_pad, params.dim):
        raise ValueError(f"state has {tuple(state.particles.pos.shape)} "
                         f"positions, params expect ({params.n_pad}, "
                         f"{params.dim})")
    return state


def state_to_numpy(state: SimState) -> Dict[str, np.ndarray]:
    """Flatten the port's state to numpy arrays (inverse of
    :func:`state_from_numpy`)."""
    return {".".join(p): v.cpu().numpy() for p, v in walk(state)}

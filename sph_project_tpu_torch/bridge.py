"""Carry a simulation state across packages as a flat dict of numpy arrays.

``state_from_numpy`` builds the port's state from arrays named
``particles.<field>``, ``rigid.<field>`` and ``<field>`` (the SimState
arrays), which is how the JAX package's state flattens (the test code does
that flattening, so this module imports nothing of JAX). ``state_to_numpy``
is the inverse for the port's own state. Arrays are copied row for row and
keep their dtypes.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from .core.params import SimParams
from .core.state import ParticleState, RigidState, SimState


def _names(cls) -> list:
    return [f.name for f in dataclasses.fields(cls) if f.name != "cached_neighbors"]


def state_from_numpy(arrays: Dict[str, np.ndarray], params: SimParams,
                     device="cpu") -> SimState:
    """The port's SimState from flattened arrays (see module docstring)."""
    def t(key):
        a = np.asarray(arrays[key])
        return torch.from_numpy(np.ascontiguousarray(a).copy()).to(device)

    particles = ParticleState(**{k: t(f"particles.{k}")
                                 for k in _names(ParticleState)})
    rigid = RigidState(**{k: t(f"rigid.{k}") for k in _names(RigidState)})
    rest = {k: t(k) for k in _names(SimState) if k not in ("particles", "rigid")}
    state = SimState(particles=particles, rigid=rigid, **rest)
    if particles.pos.shape != (params.n_pad, params.dim):
        raise ValueError(f"state has {tuple(particles.pos.shape)} positions, "
                         f"params expect ({params.n_pad}, {params.dim})")
    return state


def state_to_numpy(state: SimState) -> Dict[str, np.ndarray]:
    """Flatten the port's state to numpy arrays (inverse of
    :func:`state_from_numpy`)."""
    out = {}
    for k in _names(ParticleState):
        out[f"particles.{k}"] = getattr(state.particles, k).cpu().numpy()
    for k in _names(RigidState):
        out[f"rigid.{k}"] = getattr(state.rigid, k).cpu().numpy()
    for k in _names(SimState):
        if k not in ("particles", "rigid"):
            out[k] = getattr(state, k).cpu().numpy()
    return out

"""Simulation state as dataclasses of tensors.

Field for field the JAX package's ``core/state.py``: per-particle arrays are
shaped ``(n_pad, ...)`` and kept sorted by grid cell; an empty slot has
``material == MATERIAL_NONE``. Every tensor of one state lives on one device;
``.to(device)`` moves the whole state and ``.replace(**kw)`` returns a copy
with some fields swapped, as ``flax.struct`` does on the JAX side.
"""
from __future__ import annotations

import dataclasses
import typing as tp

import torch

from .params import SimParams


class _TensorTree:
    """``replace`` / ``to`` for a dataclass whose fields are tensors or
    nested dataclasses of tensors."""

    def replace(self, **kw):
        return dataclasses.replace(self, **kw)

    def to(self, device):
        out = {}
        for f in dataclasses.fields(self):
            v = getattr(self, f.name)
            if isinstance(v, (torch.Tensor, _TensorTree)):
                v = v.to(device)
            out[f.name] = v
        return dataclasses.replace(self, **out)


@dataclasses.dataclass
class ParticleState(_TensorTree):
    pos: torch.Tensor            # (N, dim) f32
    vel: torch.Tensor            # (N, dim) f32
    acc: torch.Tensor            # (N, dim) f32
    rest_volume: torch.Tensor    # (N,) f32 - Akinci pseudo-volume for rigid
    mass: torch.Tensor           # (N,) f32
    density: torch.Tensor        # (N,) f32
    pressure: torch.Tensor       # (N,) f32
    material: torch.Tensor       # (N,) i32 - 0 none / 1 fluid / 2 rigid
    object_id: torch.Tensor      # (N,) i32 - -1 for padding
    is_dynamic: torch.Tensor     # (N,) i32
    rigid_rest_pos: torch.Tensor  # (N, dim) f32
    entry_time: torch.Tensor     # (N,) f32
    entry_material: torch.Tensor  # (N,) i32

    @property
    def n(self) -> int:
        return self.pos.shape[0]

    @property
    def dim(self) -> int:
        return self.pos.shape[1]


@dataclasses.dataclass
class RigidState(_TensorTree):
    mass: torch.Tensor           # (O,) f32
    com: torch.Tensor            # (O, dim) f32
    com0: torch.Tensor           # (O, dim) f32
    rot: torch.Tensor            # (O, dim, dim) f32
    vel: torch.Tensor            # (O, dim) f32
    omega: torch.Tensor          # (O, dim) f32 (3D) / (O, 1) (2D)
    force: torch.Tensor          # (O, dim) f32
    torque: torch.Tensor         # (O, dim) or (O, 1) f32
    is_dynamic: torch.Tensor     # (O,) i32
    obj_material: torch.Tensor   # (O,) i32
    entry_time: torch.Tensor     # (O,) f32
    present: torch.Tensor        # (O,) i32


@dataclasses.dataclass
class SimState(_TensorTree):
    particles: ParticleState
    rigid: RigidState
    t: torch.Tensor              # () f32 simulation time
    step_count: torch.Tensor     # () i32
    visc_x: torch.Tensor         # (N, dim) f32
    dfsph_alpha: torch.Tensor    # (N,) f32
    dfsph_kappa: torch.Tensor    # (N,) f32
    dfsph_kappa_v: torch.Tensor  # (N,) f32
    sort_overflow_acc: torch.Tensor    # () i32
    window_overflow_max: torch.Tensor  # () i32
    iisph_density_star: torch.Tensor   # (N,) f32
    # the pair environment of the last sort (ops.pairs.PairEnv) or None
    cached_neighbors: tp.Any = None


def zeros_state(params: SimParams) -> SimState:
    """An empty state of ``params``' shapes, on the CPU."""
    n, d, o = params.n_pad, params.dim, params.max_objects
    f, i = torch.float32, torch.int32

    def z(*shape, dtype=f):
        return torch.zeros(shape, dtype=dtype)

    def full(shape, v, dtype=f):
        return torch.full(shape, v, dtype=dtype)

    particles = ParticleState(
        pos=z(n, d), vel=z(n, d), acc=z(n, d),
        rest_volume=full((n,), params.v0),
        mass=z(n), density=z(n), pressure=z(n),
        material=z(n, dtype=i), object_id=full((n,), -1, i),
        is_dynamic=z(n, dtype=i), rigid_rest_pos=z(n, d),
        entry_time=full((n,), -1.0), entry_material=z(n, dtype=i),
    )
    ang = d if d == 3 else 1
    rigid = RigidState(
        mass=z(o), com=z(o, d), com0=z(o, d),
        rot=torch.eye(d, dtype=f).repeat(o, 1, 1),
        vel=z(o, d), omega=z(o, ang), force=z(o, d), torque=z(o, ang),
        is_dynamic=z(o, dtype=i), obj_material=z(o, dtype=i),
        entry_time=full((o,), -1.0), present=z(o, dtype=i),
    )
    return SimState(
        particles=particles, rigid=rigid,
        t=z(), step_count=z(dtype=i),
        visc_x=z(n, d), dfsph_alpha=z(n), dfsph_kappa=z(n),
        dfsph_kappa_v=z(n),
        sort_overflow_acc=z(dtype=i), window_overflow_max=z(dtype=i),
        iisph_density_star=z(n),
    )

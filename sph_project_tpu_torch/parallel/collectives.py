"""The collectives of the multi-device path, over ``torch.distributed``.

The JAX package leaves these to ``shard_map`` and XLA: ``psum`` / ``pmax``
/ ``pmin`` over the mesh axis, ``ppermute`` to the neighbouring devices, and
the sharded sort's all-to-all. Here each is one call on the process group
of a :class:`Mesh`:

- :func:`all_reduce` and :func:`all_reduce_tables` (one buffer for a dict
  of per-object tables): the residuals, dots and wrenches;
- :func:`exchange`: one buffer to each neighbouring rank and one from each
  (``batch_isend_irecv``), the halo;
- :func:`all_gather` and :func:`all_to_all`: the global resort.

A step names its mesh by the axis in ``params.spmd_axis``; :func:`bind`
registers a mesh under its axis, as ``shard_map`` binds an axis name, and
:func:`mesh_of` finds it, so ``solvers/common.py`` reduces over it without
importing ``parallel/spatial.py``.

Under NCCL the buffers stay on the card. Gloo takes CUDA tensors for some
operations only, so under gloo every buffer of a CUDA tensor goes through
pinned host memory (:func:`_host_staged`): chosen by the group's backend
name, never by catching an error. Nothing here falls back: a failed
operation raises.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Sequence

import torch
import torch.distributed as dist


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D mesh of ranks: this process's rank, the world size, the device
    its tensors live on, the process group and its backend. Every rank of
    the default group is on the mesh, in rank order."""
    rank: int
    size: int
    device: torch.device
    group: object
    backend: str
    axis: str = "x"


_BOUND: Dict[str, Mesh] = {}

_OPS = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
        "min": dist.ReduceOp.MIN}


def bind(mesh: Mesh) -> None:
    """Make ``mesh`` the one that ``params.spmd_axis == mesh.axis`` names."""
    _BOUND[mesh.axis] = mesh


def mesh_of(axis: str) -> Mesh:
    mesh = _BOUND.get(axis)
    if mesh is None:
        raise RuntimeError(f"no mesh is bound to the axis {axis!r}; build "
                           "the step with parallel.spatial.spatial_step_fn")
    return mesh


def _host_staged(mesh: Mesh, t: torch.Tensor) -> bool:
    return mesh.backend == "gloo" and t.is_cuda


def _pinned(t: torch.Tensor) -> torch.Tensor:
    h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    h.copy_(t)
    return h


def all_reduce(x: torch.Tensor, op: str, mesh: Mesh) -> torch.Tensor:
    """``x`` reduced elementwise over the ranks (``op``: sum, max, min);
    a new tensor, the same on every rank."""
    out = x.clone()
    buf = _pinned(out) if _host_staged(mesh, out) else out
    dist.all_reduce(buf, op=_OPS[op], group=mesh.group)
    if buf is not out:
        out.copy_(buf)
    return out


def all_reduce_tables(tables: Dict[str, torch.Tensor], op: str,
                      mesh: Mesh) -> Dict[str, torch.Tensor]:
    """:func:`all_reduce` of every tensor of ``tables`` (one dtype) in one
    buffer."""
    names = sorted(tables)
    flat = torch.cat([tables[k].reshape(-1) for k in names])
    flat = all_reduce(flat, op, mesh)
    out, off = {}, 0
    for k in names:
        n = tables[k].numel()
        out[k] = flat[off:off + n].view(tables[k].shape)
        off += n
    return out


def all_gather(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's ``x`` (each of the same shape) concatenated along the
    first axis, in rank order."""
    src = _pinned(x) if _host_staged(mesh, x) else x.contiguous()
    parts = [torch.empty_like(src) for _ in range(mesh.size)]
    dist.all_gather(parts, src, group=mesh.group)
    return torch.cat(parts).to(x.device)


def exchange(to_left: torch.Tensor, to_right: torch.Tensor, mesh: Mesh):
    """Send ``to_left`` to rank - 1 and ``to_right`` to rank + 1; returns
    (from_left, from_right): rank - 1's ``to_right`` and rank + 1's
    ``to_left``, zeros at the ends of the mesh. Both buffers have the same
    shape and dtype on every rank."""
    staged = _host_staged(mesh, to_left)
    sends = [_pinned(t) if staged else t.contiguous()
             for t in (to_left, to_right)]
    recvs = [torch.zeros_like(s) for s in sends]
    ops: List[dist.P2POp] = []
    for side, peer in ((0, mesh.rank - 1), (1, mesh.rank + 1)):
        if 0 <= peer < mesh.size:
            ops.append(dist.P2POp(dist.isend, sends[side], peer, mesh.group))
            ops.append(dist.P2POp(dist.irecv, recvs[side], peer, mesh.group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return tuple(r.to(to_left.device) for r in recvs)


def all_to_all(send: torch.Tensor, send_counts: Sequence[int],
               recv_counts: Sequence[int], mesh: Mesh) -> torch.Tensor:
    """Rows ``send[sum(send_counts[:d]):][:send_counts[d]]`` to rank ``d``;
    returns the rows received, grouped by source rank in rank order."""
    src = _pinned(send) if _host_staged(mesh, send) else send.contiguous()
    out = torch.empty((sum(recv_counts),) + tuple(send.shape[1:]),
                      dtype=send.dtype, device=src.device,
                      pin_memory=src.is_pinned())
    dist.all_to_all_single(out, src, output_split_sizes=list(recv_counts),
                           input_split_sizes=list(send_counts),
                           group=mesh.group)
    return out.to(send.device)


def pack_words(fields: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The rows of every field (32-bit dtypes, equal first axes) side by
    side as int32 words, (n, W): one buffer for one collective, the bits
    kept."""
    n = next(iter(fields.values())).shape[0]
    return torch.cat([v.reshape(n, -1).contiguous().view(torch.int32)
                      for v in fields.values()], 1)


def unpack_words(words: torch.Tensor,
                 like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Inverse of :func:`pack_words`: fields of ``like``'s dtypes and row
    shapes, each contiguous, with ``words``' rows."""
    out, off = {}, 0
    for k, v in like.items():
        w = math.prod(v.shape[1:])
        out[k] = words[:, off:off + w].contiguous().view(v.dtype).reshape(
            (words.shape[0],) + tuple(v.shape[1:]))
        off += w
    return out


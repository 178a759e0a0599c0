"""The collectives of the multi-device path, over ``torch.distributed``.

The JAX package leaves these to ``shard_map`` and XLA: ``psum`` / ``pmax``
/ ``pmin`` over the mesh axis, ``ppermute`` to the neighbouring devices, and
the sharded sort's gathers. Here each is one call on the process group of a
:class:`Mesh`:

- :func:`all_reduce` and :func:`all_reduce_tables` (one buffer for a dict
  of per-object tables): the residuals, dots and wrenches;
- :func:`exchange`: one buffer to each neighbouring rank and one from each,
  the halo: under NCCL ``ncclSend`` / ``ncclRecv`` on the caller's stream
  (``parallel/nccl.py``, which a captured loop body can hold), under gloo
  ``batch_isend_irecv``;
- :func:`all_gather`: every rank's rows in rank order, the global resort.

Every output is a buffer of fixed shape allocated by the call itself, on
the caller's device, so a step of these calls has the same shapes every
time, as a CUDA graph needs (:func:`capturable` says where one can hold
them).

A step names its mesh by the axis in ``params.spmd_axis``; :func:`bind`
registers a mesh under its axis, as ``shard_map`` binds an axis name, and
:func:`mesh_of` finds it, so ``solvers/common.py`` reduces over it without
importing ``parallel/spatial.py``.

Under NCCL the buffers stay on the card. Gloo takes CUDA tensors for some
operations only, so under gloo every buffer of a CUDA tensor goes through
pinned host memory (:func:`_host_staged`): chosen by the group's backend
name, never by catching an error. Nothing here falls back: a failed
operation raises. :func:`traffic` records the collectives a region makes,
with the bytes each rank receives.
"""
from __future__ import annotations

import contextlib
import dataclasses
import os
from typing import Dict, List

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

# the log of :func:`traffic`, when one is open
_log: List[dict] | None = None

# the NCCL communicators of the halo exchange, by process group and rank
_P2P: dict = {}

# all_gather_into_tensor, under the name of the PyTorch at hand
_all_gather_into = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor


def bind(mesh: Mesh) -> None:
    """Make ``mesh`` the one that ``params.spmd_axis == mesh.axis`` names."""
    _BOUND[mesh.axis] = mesh


def mesh_of(axis: str) -> Mesh:
    mesh = _BOUND.get(axis)
    if mesh is None:
        raise RuntimeError(f"no mesh is bound to the axis {axis!r}; build "
                           "the step with parallel.spatial.spatial_step_fn")
    return mesh


def capturable(mesh: Mesh) -> bool:
    """Whether a step over ``mesh`` can be captured into a CUDA graph: NCCL
    on the card, and past one rank with NCCL's graph-mixing support off
    (``NCCL_GRAPH_MIXING_SUPPORT=0`` in the environment before NCCL's first
    use; ``parallel/launch.py`` sets it for its NCCL ranks). Under gloo a
    collective of CUDA tensors copies them to pinned host memory and waits
    for gloo on the host, which a capture cannot hold; on the CPU there is
    no graph. The solvers' loops become conditional WHILE nodes whose
    bodies hold NCCL operations (the residuals' all-reduces, the halo
    exchanges). On four H100s (``tools/probe_nccl_capture.py``, PERF.md §7)
    NCCL could not be captured into such a body with graph-mixing support
    on ("invalid argument"), and could with it off; at one rank NCCL's
    all-reduce and all-gather are local copies, which a body holds either
    way. With the support off, NCCL requires that no launch outside a
    graph follows a replay still running: synchronise first."""
    if mesh.backend != "nccl" or mesh.device.type != "cuda":
        return False
    return mesh.size == 1 or \
        os.environ.get("NCCL_GRAPH_MIXING_SUPPORT") == "0"


@contextlib.contextmanager
def traffic():
    """Record the collectives made inside: yields a list that gets, per
    call, ``{"op", "shape", "dtype", "recv_bytes"}`` (the output's shape
    and dtype, and the bytes this rank receives from the others)."""
    global _log
    log, before = [], _log
    _log = log
    try:
        yield log
    finally:
        _log = before


def _note(op: str, out: torch.Tensor, recv_bytes: int) -> None:
    if _log is not None:
        _log.append(dict(op=op, shape=tuple(out.shape), dtype=str(out.dtype),
                         recv_bytes=int(recv_bytes)))


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
    _note(f"all_reduce_{op}", out,
          (mesh.size - 1) * out.numel() * out.element_size())
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
    first axis, in rank order: a new (size * n, ...) tensor on ``x``'s
    device."""
    out = torch.empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    if _host_staged(mesh, x):
        buf = torch.empty(out.shape, dtype=out.dtype, pin_memory=True)
        _all_gather_into(buf, _pinned(x), group=mesh.group)
        out.copy_(buf)
    else:
        _all_gather_into(out, x.contiguous(), group=mesh.group)
    _note("all_gather", out, (mesh.size - 1) * x.numel() * x.element_size())
    return out


def _p2p(mesh: Mesh):
    """The mesh's NCCL communicator for the halo, made at its first use (an
    eager step: making it is collective and cannot be captured)."""
    key = (id(mesh.group), mesh.rank)
    comm = _P2P.get(key)
    if comm is None:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("exchange: the halo's NCCL communicator is "
                               "made at its first use, which a capture "
                               "cannot hold: step eagerly first")
        from . import nccl
        comm = _P2P[key] = nccl.Communicator(mesh.rank, mesh.size,
                                             mesh.device, mesh.group)
    return comm


def exchange(to_left: torch.Tensor, to_right: torch.Tensor, mesh: Mesh):
    """Send ``to_left`` to rank - 1 and ``to_right`` to rank + 1; returns
    (from_left, from_right): rank - 1's ``to_right`` and rank + 1's
    ``to_left``, zeros at the ends of the mesh, new tensors on the inputs'
    device. Both buffers have the same shape and dtype on every rank."""
    staged = _host_staged(mesh, to_left)
    sends = [_pinned(t) if staged else t.contiguous()
             for t in (to_left, to_right)]
    recvs = [torch.zeros_like(s) for s in sends]
    peers = [(side, peer) for side, peer in ((0, mesh.rank - 1),
                                             (1, mesh.rank + 1))
             if 0 <= peer < mesh.size]
    if peers and mesh.backend == "nccl":
        _p2p(mesh).send_recv([(sends[side], recvs[side], peer)
                              for side, peer in peers])
    elif peers:
        ops: List[dist.P2POp] = []
        for side, peer in peers:
            ops.append(dist.P2POp(dist.isend, sends[side], peer, mesh.group))
            ops.append(dist.P2POp(dist.irecv, recvs[side], peer, mesh.group))
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    if staged:
        recvs = [torch.empty_like(t).copy_(r)
                 for t, r in zip((to_left, to_right), recvs)]
    _note("exchange", recvs[0], len(peers) * recvs[0].numel()
          * recvs[0].element_size())
    return recvs[0], recvs[1]

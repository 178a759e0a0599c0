"""Point-to-point transfers through NCCL's C API, on the caller's stream.

The halo exchange of the spatial decomposition (``collectives.exchange``)
sends one buffer to each neighbouring rank and receives one from each. Under
NCCL, PyTorch's ``batch_isend_irecv`` runs them on a stream of its own and
joins it to the caller's with events, which a CUDA graph can hold in its
top level but not in the body of a conditional WHILE node: there the
capture ends the process (SIGSEGV on four H100s, torch 2.11,
``tools/probe_nccl_capture.py``). ``ncclSend`` / ``ncclRecv`` on the
caller's stream can be captured into such a body, with NCCL's graph-mixing
support off (``NCCL_GRAPH_MIXING_SUPPORT=0``, ``collectives.capturable``).

:class:`Communicator` is an NCCL communicator of the process group's ranks,
made from a unique id that rank 0 draws and broadcasts over the group, in
the ``libnccl`` PyTorch itself loaded (no other library). Every rank makes
it at the same point (it is collective), on the card it has selected.
"""
from __future__ import annotations

import ctypes
import functools
from typing import Sequence, Tuple

import torch
import torch.distributed as dist

# nccl.h's ncclDataType_t for the dtypes the exchange sends
_DTYPES = {torch.int32: 2, torch.float32: 7}


class _UniqueId(ctypes.Structure):
    _fields_ = [("internal", ctypes.c_byte * 128)]


@functools.cache
def _lib() -> ctypes.CDLL:
    """The ``libnccl`` loaded into this process (by PyTorch's CUDA build)."""
    with open("/proc/self/maps") as f:
        paths = sorted({line.split()[-1] for line in f
                        if "libnccl" in line and line.split()[-1][:1] == "/"})
    if not paths:
        raise RuntimeError("nccl: no libnccl is loaded in this process (a "
                           "PyTorch built with NCCL loads it)")
    lib = ctypes.CDLL(paths[0])
    lib.ncclGetUniqueId.argtypes = [ctypes.POINTER(_UniqueId)]
    lib.ncclCommInitRank.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.c_int, _UniqueId, ctypes.c_int]
    lib.ncclCommDestroy.argtypes = [ctypes.c_void_p]
    for fn in (lib.ncclSend, lib.ncclRecv):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    for fn in (lib.ncclGetUniqueId, lib.ncclCommInitRank, lib.ncclCommDestroy,
               lib.ncclSend, lib.ncclRecv, lib.ncclGroupStart,
               lib.ncclGroupEnd):
        fn.restype = ctypes.c_int
    return lib


def _check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"nccl: {what} failed, ncclResult_t {err}")


class Communicator:
    """An NCCL communicator of every rank of ``group`` (collective: each
    rank constructs it at the same point, ``device`` its selected card)."""

    def __init__(self, rank: int, size: int, device: torch.device, group):
        lib = _lib()
        uid = _UniqueId()
        if rank == 0:
            _check(lib.ncclGetUniqueId(ctypes.byref(uid)), "ncclGetUniqueId")
        box = [bytes(uid)]
        dist.broadcast_object_list(box, src=0, group=group, device=device)
        uid = _UniqueId.from_buffer_copy(box[0])
        self.comm = ctypes.c_void_p()
        self.device = device
        with torch.cuda.device(device):
            _check(lib.ncclCommInitRank(ctypes.byref(self.comm), size, uid,
                                        rank), "ncclCommInitRank")

    def send_recv(self, pairs: Sequence[Tuple[torch.Tensor, torch.Tensor,
                                              int]]) -> None:
        """For each (send, recv, peer): ``send`` to rank ``peer`` and
        ``recv`` filled from it, in one NCCL group on the current stream.
        Contiguous tensors of one shape and dtype a pair on this card."""
        lib = _lib()
        stream = torch.cuda.current_stream(self.device).cuda_stream
        _check(lib.ncclGroupStart(), "ncclGroupStart")
        try:
            for send, recv, peer in pairs:
                if send.dtype not in _DTYPES or recv.dtype != send.dtype or \
                        send.numel() != recv.numel() or \
                        not (send.is_contiguous() and recv.is_contiguous()):
                    raise ValueError(f"nccl: a {send.dtype} / {recv.dtype} "
                                     f"pair of {send.numel()} / "
                                     f"{recv.numel()} elements")
                dt = _DTYPES[send.dtype]
                _check(lib.ncclSend(send.data_ptr(), send.numel(), dt, peer,
                                    self.comm, stream), "ncclSend")
                _check(lib.ncclRecv(recv.data_ptr(), recv.numel(), dt, peer,
                                    self.comm, stream), "ncclRecv")
        finally:
            _check(lib.ncclGroupEnd(), "ncclGroupEnd")

    def close(self) -> None:
        """Free the communicator (its work must be done)."""
        if self.comm:
            _check(_lib().ncclCommDestroy(self.comm), "ncclCommDestroy")
            self.comm = ctypes.c_void_p()

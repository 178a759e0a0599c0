#!/usr/bin/env python3
"""Which NCCL operations a CUDA graph can hold: in the captured graph, and
inside the body of a conditional WHILE node (``ops/graph_loop.py``), at world
size D with one card a rank.

    python3 tools/probe_nccl_capture.py [--ranks D] [--cases NAME ...]
                                        [--env NAME=VALUE ...]

Each case starts D processes of its own (a failed capture can end a process:
PyTorch's asynchronous point-to-point inside a body ends it with SIGSEGV),
joined over NCCL. Each rank runs the case's operation on 8 float32 values:
``all_reduce``, ``all_gather`` (``all_gather_into_tensor``), ``a2a``
(``all_to_all_single``), ``p2p_torch`` (``batch_isend_irecv`` to both ring
neighbours) or ``p2p_capi`` (``ncclSend`` / ``ncclRecv`` to both, through
NCCL's C API, the library PyTorch loaded, on a communicator of its own),
either once in the captured graph (``_main``) or in the body of a toy loop
of 3 iterations (``_body``), captured with ``graph_loop.capture`` after an
eager run of the same function (the host loop), and replays it twice. One
line per case: each rank's exit code and its result (the replays equal to
the host loop, or the error). ``--env`` sets variables for the ranks (for
example ``NCCL_GRAPH_MIXING_SUPPORT=0``). Needs D cards.
"""
from __future__ import annotations

import argparse
import ctypes
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPS = ("all_reduce", "all_gather", "a2a", "p2p_torch", "p2p_capi")
CASES = tuple(f"{op}_{where}" for where in ("main", "body") for op in OPS)
# ncclFloat32 in nccl.h's ncclDataType_t
NCCL_FLOAT32 = 7
CASE_SECONDS = 90


def nccl_comm(dist, rank: int, world: int):
    """(libnccl, a communicator of the ranks): the unique id made on rank 0
    and broadcast over the process group."""
    path = next(line.split()[-1] for line in open("/proc/self/maps")
                if "libnccl" in line)
    lib = ctypes.CDLL(path)

    class UniqueId(ctypes.Structure):
        _fields_ = [("internal", ctypes.c_byte * 128)]

    uid = UniqueId()
    if rank == 0 and lib.ncclGetUniqueId(ctypes.byref(uid)) != 0:
        raise RuntimeError("ncclGetUniqueId failed")
    box = [bytes(uid)]
    dist.broadcast_object_list(box, src=0)
    uid = UniqueId.from_buffer_copy(box[0])
    comm = ctypes.c_void_p()
    lib.ncclCommInitRank.argtypes = [ctypes.POINTER(ctypes.c_void_p),
                                     ctypes.c_int, UniqueId, ctypes.c_int]
    if lib.ncclCommInitRank(ctypes.byref(comm), world, uid, rank) != 0:
        raise RuntimeError("ncclCommInitRank failed")
    for fn in (lib.ncclSend, lib.ncclRecv):
        fn.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
        fn.restype = ctypes.c_int
    return lib, comm


def rank_main(case: str, rank: int, world: int, port: int) -> None:
    import torch
    import torch.distributed as dist
    sys.path.insert(0, ROOT)
    from sph_project_tpu_torch.ops import graph_loop

    torch.cuda.set_device(rank)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=world)
    dev = torch.device("cuda", rank)
    left, right = (rank - 1) % world, (rank + 1) % world
    op_name = case.rsplit("_", 1)[0]
    lib, comm = nccl_comm(dist, rank, world) if op_name == "p2p_capi" \
        else (None, None)

    def op(t):
        t = t.contiguous()
        if op_name == "all_reduce":
            r = t.clone()
            dist.all_reduce(r)
            return r
        if op_name == "all_gather":
            r = torch.empty(world * t.numel(), device=dev)
            dist.all_gather_into_tensor(r, t)
            return r[:t.numel()] + r[-t.numel():]
        if op_name == "a2a":
            r = torch.empty_like(t)
            dist.all_to_all_single(r, t)
            return r
        a, b = torch.zeros_like(t), torch.zeros_like(t)
        if op_name == "p2p_torch":
            for work in dist.batch_isend_irecv([
                    dist.P2POp(dist.isend, t, left),
                    dist.P2POp(dist.irecv, a, left),
                    dist.P2POp(dist.isend, t, right),
                    dist.P2POp(dist.irecv, b, right)]):
                work.wait()
            return a + b
        stream = torch.cuda.current_stream(dev).cuda_stream
        lib.ncclGroupStart()
        for peer, buf in ((left, a), (right, b)):
            if lib.ncclSend(t.data_ptr(), t.numel(), NCCL_FLOAT32, peer, comm,
                            stream) or \
                    lib.ncclRecv(buf.data_ptr(), buf.numel(), NCCL_FLOAT32,
                                 peer, comm, stream):
                raise RuntimeError("ncclSend / ncclRecv failed")
        if lib.ncclGroupEnd() != 0:
            raise RuntimeError("ncclGroupEnd failed")
        return a + b

    base = torch.arange(8, dtype=torch.float32, device=dev) + 10 * rank
    limit = torch.full((), 3.0, device=dev)

    def fn():
        b = op(base * 2)
        if case.endswith("_main"):
            return b
        return graph_loop.while_loop(
            lambda c: c[0] < limit,
            lambda c: (c[0] + 1.0, op(c[1] + 1.0) / world),
            (torch.zeros((), device=dev), b))[1]

    with graph_loop.warming():
        want = fn()
    torch.cuda.synchronize()
    dist.barrier()
    graph, _, out = graph_loop.capture(fn, dev)
    graph.replay()
    torch.cuda.synchronize()
    first = out.clone()
    graph.replay()
    torch.cuda.synchronize()
    same = torch.equal(first, want) and torch.equal(out, want)
    print(f"RESULT rank {rank} {case}: replays "
          f"{'equal to' if same else 'DIFFER from'} the host loop", flush=True)
    # the process group's teardown can wait on the replayed work: leave now
    os._exit(0)


def main() -> int:
    if len(sys.argv) > 1 and sys.argv[1] == "--rank":
        rank_main(sys.argv[2], int(sys.argv[3]), int(sys.argv[4]),
                  int(sys.argv[5]))
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--cases", nargs="+", default=list(CASES),
                    choices=CASES)
    ap.add_argument("--env", nargs="*", default=[], metavar="NAME=VALUE")
    args = ap.parse_args()
    import torch
    if torch.cuda.device_count() < args.ranks:
        print(f"probe_nccl_capture: {args.ranks} ranks need {args.ranks} "
              f"cards, this host has {torch.cuda.device_count()}",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from sph_project_tpu_torch.ops import _build
    _build.build_all(("graph_loop",))
    card = subprocess.run(["nvidia-smi", "-i", "0",
                           "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60, check=True).stdout.strip()
    env = dict(os.environ, NCCL_DEBUG="WARN",
               **dict(kv.split("=", 1) for kv in args.env))
    print(f"{card}; torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"NCCL {'.'.join(map(str, torch.cuda.nccl.version()))}; "
          f"{args.ranks} ranks; env {args.env}", flush=True)
    for i, case in enumerate(args.cases):
        procs = [subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", case,
             str(r), str(args.ranks), str(29700 + i)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            env=env) for r in range(args.ranks)]
        deadline = time.monotonic() + CASE_SECONDS
        lines = []
        for r, p in enumerate(procs):
            try:
                out, _ = p.communicate(
                    timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
                out += "\ntimed out"
            keep = [ln for ln in out.splitlines()
                    if ln.startswith("RESULT") or "NCCL WARN" in ln
                    or "Error:" in ln or ln == "timed out"]
            lines.append(f"  rank {r} exit {p.returncode}: "
                         + " | ".join(keep[-4:])[:600])
        print(f"== {case}: exit codes {[p.returncode for p in procs]}",
              flush=True)
        print("\n".join(lines), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Apply the per-step sort permutation to every carried particle field.

``permute_fields(perm, arrays)`` returns ``{k: v[perm]}``. On CUDA tensors it
launches the fused gather of ``csrc/permute.cu`` (all fields in one launch,
int fields kept int, bit-exact); on CPU tensors it runs
:func:`permute_fields_plain`, the same function in plain PyTorch. The CUDA
path never falls back to the plain one.

The multi-device path (``parallel/``) sends fields side by side as the int32
words of one (n, W) buffer, in dict order, each row's words in order:
:func:`pack_words` and :func:`unpack_words` make and read that layout, here
beside the kernel that writes and reads it. :func:`permute_pack` gathers
the fields' rows straight into such a buffer, and :func:`permute_unpack`
gathers a received buffer's rows straight into fields, each in one launch
of the same kernel (the global resort, ``parallel/spatial.py``).
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, List, Sequence, Tuple

import torch

from . import _build
from . import graph_loop

MAX_FIELDS = 24
# 32-bit words of a row over all fields: the columns of the staged tile
MAX_WORDS = 64
# destination rows per block (csrc/permute.cu PERMUTE_TILE)
TILE = 256
launches = {"permute": 0}
# a captured step's replays add theirs (ops/graph_loop.py)
graph_loop.register_counts(launches)


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


def permute_fields_plain(perm: torch.Tensor,
                         arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``{k: v[perm]}`` with plain indexing."""
    return {k: v[perm] for k, v in arrays.items()}


def permute_pack_plain(perm: torch.Tensor,
                       arrays: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``pack_words({k: v[perm]})``, as the rows of the packed fields taken
    by ``perm``."""
    return pack_words(arrays)[perm]


def permute_unpack_plain(perm: torch.Tensor, words: torch.Tensor,
                         like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``{k: v[perm]}`` of ``unpack_words(words, like)``, as the fields of
    the buffer's rows taken by ``perm``."""
    return unpack_words(words[perm], like)


@functools.cache
def _lib():
    lib = _build.load("permute")
    fn = lib.sph_permute
    fn.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan(sources: Sequence[Tuple[int, int]],
         dests: Sequence[Tuple[int, int]]) -> List[int]:
    """The kernel's layout table (``csrc/permute.cu`` ``sph_permute``).

    ``sources``: (words a row, first column); ``dests``: (words a row,
    32-bit words from the address to its next 16-byte boundary); each of
    contiguous rows, the destinations' words the columns in order. Every
    column comes from exactly one source. Each destination's tile rows are
    staged as one span, placed where the 16-byte boundaries of the span and
    of its rows in memory agree; the spans start in banks 4 apart, so the
    words of a row staged into several spans collide less. A source whose
    columns lie in one destination is staged by offset and row step, any
    other through the column table."""
    at, cols, dst_rows = 0, [], []
    for o, (w, head) in enumerate(dests):
        at = -(-at // 32) * 32 + 4 * (o % 8) + (4 - head) % 4
        dst_rows.append((w, at))
        cols += [(at + c, w) for c in range(w)]
        at += TILE * w
    if not 1 <= len(cols) <= MAX_WORDS:
        raise ValueError(f"rows of {len(cols)} words: the gather takes "
                         f"1..{MAX_WORDS}")
    covered = [0] * len(cols)
    src_rows = []
    for w, col in sources:
        span = cols[col:col + w]
        if len(span) != w:
            raise ValueError(f"a source's columns {col}..{col + w} pass the "
                             f"{len(cols)} columns of the destinations")
        for c in range(col, col + w):
            covered[c] += 1
        at0, step = span[0]
        affine = all(a == at0 + c and s == step for c, (a, s) in enumerate(span))
        src_rows.append((w, col, at0 if affine else 0, step if affine else 0))
    if covered != [1] * len(cols):
        raise ValueError("every destination column needs exactly one source")
    table = [TILE, len(src_rows), len(dst_rows), len(cols), -(-at // 4) * 4]
    for row in (*src_rows, *dst_rows, *cols):
        table += row
    return table


@functools.lru_cache(maxsize=64)
def _layout(sources: tuple, dests: tuple):
    table = plan(sources, dests)
    return (ctypes.c_int * len(table))(*table)


def _row_words(k: str, v: torch.Tensor) -> int:
    row_bytes = math.prod(v.shape[1:]) * v.element_size()
    if v.dim() < 1 or row_bytes % 4 or row_bytes == 0:
        raise ValueError(f"{k}: row of {row_bytes} bytes is not 32-bit words")
    return row_bytes // 4


def _check_perm(perm: torch.Tensor) -> int:
    if perm.dtype != torch.int64 or perm.dim() != 1 or not perm.is_contiguous():
        raise ValueError("perm must be a contiguous 1-D int64 tensor")
    return perm.shape[0]


def _check_fields(perm: torch.Tensor, arrays: Dict[str, torch.Tensor]) -> List[int]:
    """Words a row of each field; every field contiguous on ``perm``'s
    device with its rows."""
    n = _check_perm(perm)
    if not 1 <= len(arrays) <= MAX_FIELDS:
        raise ValueError(f"permute takes 1..{MAX_FIELDS} fields, got {len(arrays)}")
    words = []
    for k, v in arrays.items():
        if v.device != perm.device or v.shape[0] != n or not v.is_contiguous():
            raise ValueError(f"field {k}: must be contiguous on {perm.device} "
                             f"with {n} rows")
        words.append(_row_words(f"field {k}", v))
    return words


def _gather(perm: torch.Tensor, sources, dests) -> None:
    """One launch of the kernel (``sources``: (tensor, words a row, first
    column); ``dests``: (tensor, words a row))."""
    n = perm.shape[0]
    if n == 0:
        return
    ptrs = [t.data_ptr() for t, _ in dests]
    if any(p % 4 for p in ptrs):
        raise ValueError("a destination is not 4-byte aligned")
    layout = _layout(tuple((w, c) for _, w, c in sources),
                     tuple((w, (16 - p % 16) % 16 // 4)
                           for (_, w), p in zip(dests, ptrs)))
    src = (ctypes.c_void_p * len(sources))(*[t.data_ptr() for t, *_ in sources])
    dst = (ctypes.c_void_p * len(dests))(*ptrs)
    stream = torch.cuda.current_stream(perm.device).cuda_stream
    err = _lib()(perm.data_ptr(), n, layout, src, dst, stream)
    if err != 0:
        raise RuntimeError(f"permute kernel launch failed: CUDA error {err}")
    launches["permute"] += 1


def _offsets(words: Sequence[int]) -> List[int]:
    return [sum(words[:i]) for i in range(len(words))]


def permute_fields_cuda(perm: torch.Tensor,
                        arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The fused gather kernel. Every array is contiguous, on ``perm``'s
    device, has ``perm.shape[0]`` rows and 32-bit-word-multiple rows."""
    words = _check_fields(perm, arrays)
    outs = {k: torch.empty_like(v) for k, v in arrays.items()}
    cols = _offsets(words)
    _gather(perm, list(zip(arrays.values(), words, cols)),
            list(zip(outs.values(), words)))
    return outs


def permute_pack_cuda(perm: torch.Tensor,
                      arrays: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The kernel gathering the fields' rows into one (n, W) int32 buffer,
    the fields side by side in their order."""
    words = _check_fields(perm, arrays)
    out = torch.empty((perm.shape[0], sum(words)), dtype=torch.int32,
                      device=perm.device)
    _gather(perm, list(zip(arrays.values(), words, _offsets(words))),
            [(out, sum(words))])
    return out


def permute_unpack_cuda(perm: torch.Tensor, words: torch.Tensor,
                        like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The kernel gathering a (n, W) int32 buffer's rows into fields of
    ``like``'s dtypes and row shapes, taken from the buffer's columns in
    ``like``'s order."""
    n = _check_perm(perm)
    if not 1 <= len(like) <= MAX_FIELDS:
        raise ValueError(f"permute takes 1..{MAX_FIELDS} fields, got {len(like)}")
    if words.dtype != torch.int32 or words.dim() != 2 or \
            words.device != perm.device or words.shape[0] != n or \
            not words.is_contiguous():
        raise ValueError(f"the buffer must be a contiguous (n, W) int32 "
                         f"tensor on {perm.device} with {n} rows")
    widths = [_row_words(f"field {k}", v) for k, v in like.items()]
    if sum(widths) != words.shape[1]:
        raise ValueError(f"the buffer has {words.shape[1]} words a row, the "
                         f"fields {sum(widths)}")
    outs = {k: torch.empty((n,) + tuple(v.shape[1:]), dtype=v.dtype,
                           device=perm.device) for k, v in like.items()}
    _gather(perm, [(words, words.shape[1], 0)],
            list(zip(outs.values(), widths)))
    return outs


def _on_card(perm: torch.Tensor) -> bool:
    """True for a CUDA ``perm``, False for a CPU one; raises otherwise."""
    if perm.device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {perm.device}")
    return perm.device.type == "cuda"


def permute_fields(perm: torch.Tensor,
                   arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``{k: v[perm]}`` for all fields: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if _on_card(perm):
        return permute_fields_cuda(perm, arrays)
    return permute_fields_plain(perm, arrays)


def permute_pack(perm: torch.Tensor,
                 arrays: Dict[str, torch.Tensor]) -> torch.Tensor:
    """``pack_words(permute_fields(perm, arrays))`` in one gather: the
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if _on_card(perm):
        return permute_pack_cuda(perm, arrays)
    return permute_pack_plain(perm, arrays)


def permute_unpack(perm: torch.Tensor, words: torch.Tensor,
                   like: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``permute_fields(perm, unpack_words(words, like))`` in one gather:
    the kernel for CUDA tensors, the plain version for CPU tensors."""
    if _on_card(perm):
        return permute_unpack_cuda(perm, words, like)
    return permute_unpack_plain(perm, words, like)

"""Apply the per-step sort permutation to every carried particle field.

``permute_fields(perm, arrays)`` returns ``{k: v[perm]}``. On CUDA tensors it
launches the fused gather of ``csrc/permute.cu`` (all fields in one launch,
int fields kept int, bit-exact); on CPU tensors it runs
:func:`permute_fields_plain`, the same function in plain PyTorch. The CUDA
path never falls back to the plain one.
"""
from __future__ import annotations

import ctypes
from typing import Dict

import torch

from . import _build

MAX_FIELDS = 24
launches = {"permute": 0}


def permute_fields_plain(perm: torch.Tensor,
                         arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``{k: v[perm]}`` with plain indexing."""
    return {k: v[perm] for k, v in arrays.items()}


def _lib():
    lib = _build.load("permute")
    fn = lib.sph_permute
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def permute_fields_cuda(perm: torch.Tensor,
                        arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The fused gather kernel. Every array is contiguous, on ``perm``'s
    device, has ``perm.shape[0]`` rows and 32-bit-word-multiple rows."""
    n = perm.shape[0]
    dev = perm.device
    if perm.dtype != torch.int64 or perm.dim() != 1 or not perm.is_contiguous():
        raise ValueError("perm must be a contiguous 1-D int64 tensor")
    if not 1 <= len(arrays) <= MAX_FIELDS:
        raise ValueError(f"permute takes 1..{MAX_FIELDS} fields, got {len(arrays)}")
    outs, ins, words = {}, [], []
    for k, v in arrays.items():
        if v.device != dev or v.shape[0] != n or not v.is_contiguous():
            raise ValueError(f"field {k}: must be contiguous on {dev} with {n} rows")
        row_bytes = v[0].numel() * v.element_size() if n else 0
        if row_bytes % 4 or row_bytes == 0:
            raise ValueError(f"field {k}: row of {row_bytes} bytes is not 32-bit words")
        outs[k] = torch.empty_like(v)
        ins.append(v)
        words.append(row_bytes // 4)
    nf = len(ins)
    in_ptrs = (ctypes.c_void_p * nf)(*[v.data_ptr() for v in ins])
    out_ptrs = (ctypes.c_void_p * nf)(*[o.data_ptr() for o in outs.values()])
    word_arr = (ctypes.c_int * nf)(*words)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = _lib()(perm.data_ptr(), ctypes.addressof(in_ptrs),
                 ctypes.addressof(out_ptrs), ctypes.addressof(word_arr),
                 nf, n, stream)
    if err != 0:
        raise RuntimeError(f"permute kernel launch failed: CUDA error {err}")
    launches["permute"] += 1
    return outs


def permute_fields(perm: torch.Tensor,
                   arrays: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """``{k: v[perm]}`` for all fields: the CUDA kernel for CUDA tensors, the
    plain version for CPU tensors."""
    if perm.device.type == "cuda":
        return permute_fields_cuda(perm, arrays)
    if perm.device.type != "cpu":
        raise ValueError(f"unsupported device {perm.device}")
    return permute_fields_plain(perm, arrays)

"""The rotation factor of the polar decomposition, batched.

``polar_rotation(A)`` returns R of A = R S for each (dim, dim) matrix of
the (O, dim, dim) float32 ``A``: U V^T of the SVD, with U's column of the
smallest singular value scaled by det(U V^T), so that a reflection becomes
a rotation. The shape-matching rigid backend (``rigid/shape_matching.py``)
takes it of each body's covariance, as the JAX package takes
``jnp.linalg.svd`` and ``jnp.linalg.det`` inside its jitted step
(``rigid/shape_matching.py`` :21).

On CUDA tensors it launches ``csrc/polar.cu`` (one thread a body, a Jacobi
SVD in float64): ``torch.linalg.svd`` and ``det`` on the card check their
convergence on the host, which a captured step cannot hold. On CPU tensors
it runs :func:`polar_rotation_plain`, the same function through
``torch.linalg``. The CUDA path never falls back to the plain one.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..solvers.common import matmul
from . import _build
from . import graph_loop

launches = {"polar": 0}
# a captured step's replays add theirs (ops/graph_loop.py)
graph_loop.register_counts(launches)


def polar_rotation_plain(A: torch.Tensor) -> torch.Tensor:
    """U V^T of the SVD, with U's last column scaled by det(U V^T)."""
    U, _, Vh = torch.linalg.svd(A)
    det = torch.linalg.det(matmul(U, Vh))
    fix = torch.cat([torch.ones(det.shape + (A.shape[-1] - 1,),
                                dtype=A.dtype, device=A.device),
                     det[..., None]], -1)
    return matmul(U * fix[..., None, :], Vh)


@functools.cache
def _lib():
    fn = _build.load("polar").sph_polar
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                   ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def polar_rotation_cuda(A: torch.Tensor,
                        sweeps: torch.Tensor | None = None) -> torch.Tensor:
    """The kernel: ``A`` a contiguous (O, dim, dim) float32 CUDA tensor,
    dim 2 or 3. ``sweeps``, a contiguous (O,) int32 tensor on the same card,
    receives the Jacobi sweeps each matrix took."""
    if A.device.type != "cuda" or A.dtype != torch.float32 or A.dim() != 3 \
            or A.shape[1] != A.shape[2] or A.shape[1] not in (2, 3) \
            or not A.is_contiguous():
        raise ValueError(f"polar_rotation_cuda takes a contiguous (O, d, d) "
                         f"float32 CUDA tensor with d 2 or 3, not {A.dtype} "
                         f"{tuple(A.shape)} on {A.device}")
    if sweeps is not None and (sweeps.device != A.device
                               or sweeps.dtype != torch.int32
                               or sweeps.shape != A.shape[:1]
                               or not sweeps.is_contiguous()):
        raise ValueError("sweeps must be a contiguous (O,) int32 tensor on "
                         "A's card")
    R = torch.empty_like(A)
    stream = torch.cuda.current_stream(A.device).cuda_stream
    err = _lib()(A.data_ptr(), R.data_ptr(), A.shape[0], A.shape[1],
                 None if sweeps is None else sweeps.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"polar kernel launch failed: CUDA error {err}")
    launches["polar"] += 1
    return R


def polar_rotation(A: torch.Tensor) -> torch.Tensor:
    """The rotation factor of each matrix of ``A``: the CUDA kernel for CUDA
    tensors, the plain version for CPU tensors."""
    if A.device.type == "cuda":
        return polar_rotation_cuda(A.contiguous())
    if A.device.type == "cpu":
        return polar_rotation_plain(A)
    raise ValueError(f"polar_rotation: unsupported device {A.device}")

"""SPH smoothing kernels on tensors: the cubic spline, and PBF's poly6 W with
the spiky gradient.

The JAX package's ``ops/kernels.py``, written with the same expression order
so float32 results agree: Python-float constants are folded in double on the
host and enter the tensor arithmetic as float32, as JAX folds them. The kind
``"poly6"`` (``params.kernel_type`` of a PBF scene) swaps poly6 W and the
spiky gradient in for the cubic spline; both are the 3D forms in every
dimension, as in the JAX package. The CUDA pair bodies
(``csrc/pair_bodies.cuh``) take the same folded constants from
:func:`cubic_constants` and :func:`kind_constants`.
"""
from __future__ import annotations

import math

import torch


def _cubic_norm(h: float, dim: int) -> float:
    if dim == 1:
        k = 4.0 / 3.0
    elif dim == 2:
        k = 40.0 / 7.0 / math.pi
    else:
        k = 8.0 / math.pi
    return k / h ** dim


POLY6_FAC = 315.0 / 64.0 / math.pi
SPIKY_FAC = -45.0 / math.pi


def cubic_W(r: torch.Tensor, h: float, dim: int) -> torch.Tensor:
    """Cubic-spline kernel W(|r|). ``r`` is the distance (any shape)."""
    k = _cubic_norm(h, dim)
    q = r / h
    q2 = q * q
    w_near = k * (6.0 * q * q2 - 6.0 * q2 + 1.0)
    one_q = 1.0 - q
    w_far = k * 2.0 * one_q * one_q * one_q
    w = torch.where(q <= 0.5, w_near, w_far)
    return torch.where(q <= 1.0, w, torch.zeros_like(w))


def cubic_w_gw_d2(d2: torch.Tensor, h: float, dim: int,
                  need_w: bool = True, need_gw: bool = True):
    """(W, gw) from the SQUARED distance, with gradW = gw * R.

    As on the JAX side, the outer q < 1 cutoff is left to the caller's pair
    mask (out-of-support entries may hold garbage that the masked sum drops).
    """
    k = _cubic_norm(h, dim)
    inv_r = torch.sqrt(1.0 / torch.clamp_min(d2, 1e-24))
    q = torch.clamp_max(d2 * inv_r / h, 1.0)
    near = q <= 0.5
    w = gw = None
    if need_w:
        q2 = q * q
        one_q = 1.0 - q
        w = torch.where(near, k * (6.0 * q * q2 - 6.0 * q2 + 1.0),
                        k * 2.0 * one_q * one_q * one_q)
    if need_gw:
        one_q = 1.0 - q
        # c/(q h^2): the near branch's q cancels; the far one uses h*inv_r = 1/q
        gw_near = 3.0 * q - 2.0
        gw_far = -one_q * one_q * (h * inv_r)
        gw = (6.0 * k / (h * h)) * torch.where(near, gw_near, gw_far)
        # the reference zeroes the gradient inside |R| <= 1e-5
        gw = torch.where(d2 > 1e-10, gw, torch.zeros_like(gw))
    return w, gw


def cubic_grad_W(R: torch.Tensor, h: float, dim: int,
                 dist: torch.Tensor | None = None) -> torch.Tensor:
    """Gradient of the cubic spline for displacements R (..., dim): zero
    inside |R| <= 1e-5 and outside q > 1."""
    if dist is None:
        dist = torch.linalg.vector_norm(R, dim=-1)
    return grad_W_coef(dist, h, dim)[..., None] * R


def poly6_W(r: torch.Tensor, h: float) -> torch.Tensor:
    """PBF's poly6 kernel; zero at r == 0, like the reference."""
    x = (h * h - r * r) / (h * h * h)
    w = POLY6_FAC * x * x * x
    return torch.where((r > 0) & (r < h), w, torch.zeros_like(w))


def spiky_grad_coef(dist: torch.Tensor, h: float) -> torch.Tensor:
    """Scalar c(|R|) of PBF's spiky gradient, gradW = c * R."""
    safe = torch.clamp_min(dist, 1e-12)
    x = (h - dist) / (h * h * h)
    c = SPIKY_FAC * x * x / safe
    return torch.where((dist > 0) & (dist < h), c, torch.zeros_like(c))


def spiky_grad_W(R: torch.Tensor, h: float,
                 dist: torch.Tensor | None = None) -> torch.Tensor:
    """PBF's spiky gradient for displacements R (..., dim)."""
    if dist is None:
        dist = torch.linalg.vector_norm(R, dim=-1)
    return spiky_grad_coef(dist, h)[..., None] * R


def _check_kind(kind: str) -> None:
    if kind not in ("cubic", "poly6"):
        raise ValueError(f"unknown kernel kind {kind!r}")


def W(r: torch.Tensor, h: float, dim: int, kind: str = "cubic") -> torch.Tensor:
    """Kernel dispatch: PBF swaps in poly6."""
    _check_kind(kind)
    return cubic_W(r, h, dim) if kind == "cubic" else poly6_W(r, h)


def W0(h: float, dim: int, kind: str = "cubic") -> float:
    """W(0) as a Python float (the self-density term); 0 under poly6."""
    _check_kind(kind)
    return _cubic_norm(h, dim) if kind == "cubic" else 0.0


def grad_W(R: torch.Tensor, h: float, dim: int,
           dist: torch.Tensor | None = None,
           kind: str = "cubic") -> torch.Tensor:
    """Gradient dispatch: PBF swaps in the spiky gradient."""
    _check_kind(kind)
    if kind == "cubic":
        return cubic_grad_W(R, h, dim, dist)
    return spiky_grad_W(R, h, dist)


def grad_W_coef(dist: torch.Tensor, h: float, dim: int,
                kind: str = "cubic") -> torch.Tensor:
    """Scalar c(|R|) with gradW = c * R."""
    _check_kind(kind)
    if kind != "cubic":
        return spiky_grad_coef(dist, h)
    k = 6.0 * _cubic_norm(h, dim)
    q = dist / h
    safe = torch.clamp_min(dist, 1e-12)
    c_near = k * q * (3.0 * q - 2.0)
    one_q = 1.0 - q
    c_far = -k * one_q * one_q
    c = torch.where(q <= 0.5, c_near, c_far)
    c = torch.where((dist > 1e-5) & (q <= 1.0), c, torch.zeros_like(c))
    return c / (safe * h)


def w_d2(d2: torch.Tensor, h: float, dim: int, kind: str) -> torch.Tensor:
    """W from the squared distance, as the JAX package's shared passes take
    it (``common._w_d2``): the cubic d2-form, or poly6 at sqrt(d2)."""
    if kind == "cubic":
        return cubic_w_gw_d2(d2, h, dim, need_gw=False)[0]
    return W(torch.sqrt(d2), h, dim, kind)


def gw_d2(d2: torch.Tensor, h: float, dim: int, kind: str) -> torch.Tensor:
    """gradW / R from the squared distance (``common._gw_coef``)."""
    if kind == "cubic":
        return cubic_w_gw_d2(d2, h, dim, need_w=False)[1]
    return grad_W_coef(torch.sqrt(d2), h, dim, kind)


def cubic_constants(h: float, dim: int) -> list:
    """The folded constants of :func:`cubic_w_gw_d2`, in the order the CUDA
    pair kernel reads them: h, k, 2k, 6k/h^2."""
    k = _cubic_norm(h, dim)
    return [h, k, k * 2.0, 6.0 * k / (h * h)]


def kind_constants(h: float, dim: int) -> list:
    """The folded constants of the distance forms :func:`W` and
    :func:`grad_W_coef` take for either kind, in the order the CUDA pair
    kernels read them (``PairArgs.kc``): h, h^2, h^3, the poly6 factor, the
    spiky factor, then the cubic gradient's 6k."""
    return [h, h * h, h * h * h, POLY6_FAC, SPIKY_FAC,
            6.0 * _cubic_norm(h, dim)]

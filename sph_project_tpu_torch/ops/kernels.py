"""SPH smoothing kernels on tensors (the cubic spline).

The JAX package's ``ops/kernels.py``, cubic kernel only, written with the
same expression order so float32 results agree: Python-float constants are
folded in double on the host and enter the tensor arithmetic as float32, as
JAX folds them. The CUDA pair bodies (``csrc/pair_bodies.cuh``) take the same
folded constants from :func:`cubic_constants`.
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


def _require_cubic(kind: str) -> None:
    if kind != "cubic":
        raise NotImplementedError(
            f"{kind} kernel is not ported yet (ROADMAP Queue A.9b, PBF)")


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


def W(r: torch.Tensor, h: float, dim: int, kind: str = "cubic") -> torch.Tensor:
    _require_cubic(kind)
    return cubic_W(r, h, dim)


def W0(h: float, dim: int, kind: str = "cubic") -> float:
    """W(0) as a Python float (the self-density term)."""
    _require_cubic(kind)
    return _cubic_norm(h, dim)


def grad_W_coef(dist: torch.Tensor, h: float, dim: int,
                kind: str = "cubic") -> torch.Tensor:
    """Scalar c(|R|) with gradW = c * R."""
    _require_cubic(kind)
    k = 6.0 * _cubic_norm(h, dim)
    q = dist / h
    safe = torch.clamp_min(dist, 1e-12)
    c_near = k * q * (3.0 * q - 2.0)
    one_q = 1.0 - q
    c_far = -k * one_q * one_q
    c = torch.where(q <= 0.5, c_near, c_far)
    c = torch.where((dist > 1e-5) & (q <= 1.0), c, torch.zeros_like(c))
    return c / (safe * h)


def cubic_constants(h: float, dim: int) -> list:
    """The folded constants of :func:`cubic_w_gw_d2`, in the order the CUDA
    pair kernel reads them: h, k, 2k, 6k/h^2."""
    k = _cubic_norm(h, dim)
    return [h, k, k * 2.0, 6.0 * k / (h * h)]

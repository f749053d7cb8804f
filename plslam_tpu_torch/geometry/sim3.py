"""Sim3 (7-dof similarity transform) operations on batched float32 tensors.

Port of `plslam_tpu/geometry/sim3.py`. A Sim3 ``S`` is ``(s, R, t)`` with
``s: (...,)``, ``R: (...,3,3)``, ``t: (...,3)`` acting as
``x -> s * R @ x + t``. Tangent vectors are (...,7) ordered
``[omega(3), upsilon(3), sigma(1)]`` (rotation, translation, log-scale).
Every op is batched over leading dims and branch-free, so it works under
`torch.func` transforms and never waits for the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import se3
from .triangulation import solve3x3

_EPS = 1e-7


class Sim3(NamedTuple):
    s: torch.Tensor  # (...,)
    R: torch.Tensor  # (...,3,3)
    t: torch.Tensor  # (...,3)


def identity(batch=(), device=None, dtype=torch.float32) -> Sim3:
    batch = tuple(batch)
    return Sim3(torch.ones(batch, dtype=dtype, device=device),
                torch.eye(3, dtype=dtype, device=device).expand(
                    batch + (3, 3)),
                torch.zeros(batch + (3,), dtype=dtype, device=device))


def from_se3(T, s=None) -> Sim3:
    if s is None:
        s = torch.ones(T.shape[:-2], dtype=T.dtype, device=T.device)
    return Sim3(s, T[..., :3, :3], T[..., :3, 3])


def to_se3(S: Sim3):
    """The SE3 ``[R | t/s]`` (the essential graph's pose recovery)."""
    return se3.rt_to_mat(S.R, S.t / S.s[..., None])


def _rot(R, v):
    return torch.einsum("...ij,...j->...i", R, v)


def compose(A: Sim3, B: Sim3) -> Sim3:
    """A o B : x -> A(B(x))."""
    return Sim3(A.s * B.s, A.R @ B.R, A.s[..., None] * _rot(A.R, B.t) + A.t)


def inverse(S: Sim3) -> Sim3:
    Rt = S.R.transpose(-1, -2)
    s_inv = 1.0 / S.s
    return Sim3(s_inv, Rt, -s_inv[..., None] * _rot(Rt, S.t))


def apply(S: Sim3, pts):
    """Apply to (...,3) or (...,N,3) points."""
    if pts.ndim == S.R.ndim - 1:
        return S.s[..., None] * _rot(S.R, pts) + S.t
    return (S.s[..., None, None] * torch.einsum("...ij,...nj->...ni", S.R,
                                                pts) + S.t[..., None, :])


def _calc_w_coeffs(theta, sigma):
    """Coefficients (A, B, C) of W = A*Omega + B*Omega^2 + C*I for the Sim3
    exp (Strasdat's closed form), with Taylor branches at small theta
    and/or sigma selected by `torch.where` over safe denominators."""
    scale = torch.exp(sigma)
    theta2 = theta * theta
    sigma2 = sigma * sigma
    small_t = theta < 1e-4
    small_s = sigma.abs() < 1e-4
    th_safe = torch.where(small_t, 1.0, theta)
    sg_safe = torch.where(small_s, 1.0, sigma)
    c = theta2 + sigma2
    c_safe = torch.where(c < _EPS, 1.0, c)
    a_ = scale * torch.sin(theta)
    b_ = scale * torch.cos(theta)

    # sigma ~ 0 branch
    C_s0 = torch.ones_like(theta)
    A_s0 = torch.where(small_t, 0.5 - theta2 / 24.0,
                       (1.0 - torch.cos(theta)) / (th_safe * th_safe))
    B_s0 = torch.where(small_t, 1.0 / 6.0 - theta2 / 120.0,
                       (theta - torch.sin(theta))
                       / (th_safe * th_safe * th_safe))
    # general sigma branch
    C_s = (scale - 1.0) / sg_safe
    A_s_t0 = ((sigma - 1.0) * scale + 1.0) / (sg_safe * sg_safe)
    B_s_t0 = (((0.5 * sigma2 - sigma + 1.0) * scale - 1.0)
              / (sg_safe * sg_safe * sg_safe))
    A_s_t = (a_ * sigma + (1.0 - b_) * theta) / (th_safe * c_safe)
    B_s_t = (C_s - ((b_ - 1.0) * sigma + a_ * theta) / c_safe) / (
        th_safe * th_safe)
    A_s = torch.where(small_t, A_s_t0, A_s_t)
    B_s = torch.where(small_t, B_s_t0, B_s_t)
    return (torch.where(small_s, A_s0, A_s), torch.where(small_s, B_s0, B_s),
            torch.where(small_s, C_s0, C_s))


def _calc_w(w, sigma):
    theta = torch.sqrt(torch.sum(w * w, dim=-1).clamp_min(_EPS * _EPS))
    A, B, C = _calc_w_coeffs(theta, sigma)
    Om = se3.hat(w)
    eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(Om.shape)
    return (A[..., None, None] * Om + B[..., None, None] * (Om @ Om)
            + C[..., None, None] * eye)


def expmap(xi) -> Sim3:
    """(...,7) [omega, upsilon, sigma] -> Sim3."""
    w, v, sigma = xi[..., :3], xi[..., 3:6], xi[..., 6]
    return Sim3(torch.exp(sigma), se3.so3_exp(w), _rot(_calc_w(w, sigma), v))


def logmap(S: Sim3):
    """Sim3 -> (...,7) tangent, the inverse of `expmap`: omega and sigma in
    closed form, upsilon from the 3x3 system ``W v = t`` (solved by the
    adjugate, well conditioned for |omega| < pi)."""
    w = se3.so3_log(S.R)
    sigma = torch.log(S.s)
    v = solve3x3(_calc_w(w, sigma), S.t)
    return torch.cat([w, v, sigma[..., None]], dim=-1)

"""SO3 / SE3 Lie-group operations on batched float32 tensors.

Port of `plslam_tpu/geometry/se3.py`. Same conventions:

- A pose ``T`` is a (..., 4, 4) homogeneous matrix mapping world -> camera.
- A tangent vector ``xi`` is (..., 6) ordered ``[omega(3), upsilon(3)]``
  (rotation first), the g2o ``SE3Quat::exp`` update convention.
- Quaternions are (..., 4) in ``[w, x, y, z]`` (Hamilton) order.

Every function is branch-free (``torch.where``), so none of them waits for
the device.
"""
from __future__ import annotations

import torch

_EPS = 1e-8


def hat(w):
    """Skew-symmetric matrix of (...,3) -> (...,3,3)."""
    wx, wy, wz = w.unbind(-1)
    z = torch.zeros_like(wx)
    return torch.stack([
        torch.stack([z, -wz, wy], dim=-1),
        torch.stack([wz, z, -wx], dim=-1),
        torch.stack([-wy, wx, z], dim=-1),
    ], dim=-2)


def vee(W):
    """Inverse of hat: (...,3,3) -> (...,3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye3(w):
    return torch.eye(3, dtype=w.dtype, device=w.device).expand(
        w.shape[:-1] + (3, 3))


def _sinc_terms(theta2):
    """Stable (sin t / t, (1-cos t)/t^2, (t - sin t)/t^3) from theta^2, with
    Taylor branches below theta^2 = 1e-8."""
    t2s = theta2.clamp_min(1e-8)
    theta = torch.sqrt(t2s)
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / t2s)
    c = torch.where(small, 1.0 / 6.0 - theta2 / 120.0,
                    (theta - torch.sin(theta)) / (t2s * theta))
    return a, b, c


def so3_exp(w):
    """Rodrigues: (...,3) axis-angle -> (...,3,3) rotation."""
    theta2 = torch.sum(w * w, dim=-1)
    a, b, _ = _sinc_terms(theta2)
    W = hat(w)
    return _eye3(w) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def so3_log(R):
    """(...,3,3) rotation -> (...,3) axis-angle, via Shepperd quaternion
    extraction and ``2 atan2(|v|, w)`` (stable up to theta = pi)."""
    q = rot_to_quat(R)
    q = q * torch.where(q[..., 0:1] < 0, -1.0, 1.0)
    qw = q[..., 0]
    v = q[..., 1:]
    vn = torch.linalg.vector_norm(v, dim=-1)
    theta = 2.0 * torch.atan2(vn, qw)
    small = vn < 1e-6
    scale = torch.where(small, 2.0 / qw.clamp_min(_EPS),
                        theta / vn.clamp_min(_EPS))
    return v * scale[..., None]


def left_jacobian(w):
    """SO3 left Jacobian J_l(w): (...,3) -> (...,3,3)."""
    theta2 = torch.sum(w * w, dim=-1)
    _, b, c = _sinc_terms(theta2)
    W = hat(w)
    return _eye3(w) + b[..., None, None] * W + c[..., None, None] * (W @ W)


def left_jacobian_inv(w):
    """Inverse of the SO3 left Jacobian."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(theta2.clamp_min(_EPS * _EPS))
    W = hat(w)
    half = 0.5 * theta
    cot = torch.where(
        theta2 < 1e-8, 1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half).clamp_min(_EPS))
        / theta2.clamp_min(_EPS * _EPS))
    return _eye3(w) - 0.5 * W + cot[..., None, None] * (W @ W)


def se3_exp(xi):
    """(...,6) [omega, upsilon] -> (...,4,4) via the SE3 exponential map."""
    w = xi[..., :3]
    v = xi[..., 3:]
    R = so3_exp(w)
    t = torch.einsum("...ij,...j->...i", left_jacobian(w), v)
    return rt_to_mat(R, t)


def se3_log(T):
    """(...,4,4) -> (...,6) [omega, upsilon]."""
    w = so3_log(T[..., :3, :3])
    v = torch.einsum("...ij,...j->...i", left_jacobian_inv(w), T[..., :3, 3])
    return torch.cat([w, v], dim=-1)


def rt_to_mat(R, t):
    """(...,3,3), (...,3) -> (...,4,4)."""
    top = torch.cat([R, t[..., None]], dim=-1)
    # [0, 0, 0, 1] from eye, not by assigning a Python scalar: on CUDA that
    # assignment is a host-to-device copy, which waits for the device
    bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:].expand(
        R.shape[:-2] + (1, 4))
    return torch.cat([top, bottom], dim=-2)


def se3_inv(T):
    """Inverse of a rigid transform, exploiting R^T structure."""
    Rt = T[..., :3, :3].transpose(-1, -2)
    return rt_to_mat(Rt, -torch.einsum("...ij,...j->...i", Rt, T[..., :3, 3]))


def transform(T, pts):
    """Apply (...,4,4) to points (...,N,3) or (...,3)."""
    R = T[..., :3, :3]
    t = T[..., :3, 3]
    if pts.ndim == T.ndim - 1:
        return torch.einsum("...ij,...j->...i", R, pts) + t
    return torch.einsum("...ij,...nj->...ni", R, pts) + t[..., None, :]


def rot_to_quat(R):
    """(...,3,3) -> (...,4) [w,x,y,z], Shepperd's method (branch-free: the
    candidate with the largest pivot is selected by argmax)."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22

    def piv(x):
        return torch.sqrt(x.clamp_min(_EPS)) * 0.5

    qw0 = piv(1.0 + tr)
    q0 = torch.stack([qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
                      (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = piv(1.0 + m00 - m11 - m22)
    q1 = torch.stack([(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
                      (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = piv(1.0 - m00 + m11 - m22)
    q2 = torch.stack([(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
                      (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = piv(1.0 - m00 - m11 + m22)
    q3 = torch.stack([(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
                      (m12 + m21) / (4 * qz3), qz3], dim=-1)
    cand = torch.stack([q0, q1, q2, q3], dim=-2)            # (...,4,4)
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    q = torch.gather(cand, -2, idx[..., None, None].expand(idx.shape + (1, 4)))
    q = q[..., 0, :]
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_to_rot(q):
    """(...,4) [w,x,y,z] -> (...,3,3)."""
    q = q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)

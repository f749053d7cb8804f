"""Reprojection residuals and analytic Jacobians for points and line
endpoints.

Port of `plslam_tpu/optim/residuals.py` (the monocular edges). The pose
tangent is [omega(3), upsilon(3)] with left-multiplicative updates
``T' = exp(xi) @ T``, so ``dX_c/domega = -hat(X_c)`` and ``dX_c/dupsilon = I``.
"""
from __future__ import annotations

import torch

from ..geometry import se3


def project_jacobian(cam, Xc):
    """d(pixel)/d(X_c): (..., 2, 3) for camera-frame points (..., 3)."""
    x, y = Xc[..., 0], Xc[..., 1]
    iz = 1.0 / Xc[..., 2].clamp_min(1e-6)
    iz2 = iz * iz
    zeros = torch.zeros_like(x)
    row_u = torch.stack([cam.fx * iz, zeros, -cam.fx * x * iz2], dim=-1)
    row_v = torch.stack([zeros, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    return torch.stack([row_u, row_v], dim=-2)


def point_residual(cam, T_cw, X_w, uv_obs):
    """Reprojection residual r = proj(T X) - uv and Jacobians.

    Returns (r (...,2), J_pose (...,2,6), J_point (...,2,3), z (...,))."""
    Xc = se3.transform(T_cw, X_w)
    z = Xc[..., 2]
    iz = 1.0 / z.clamp_min(1e-6)
    u = cam.fx * Xc[..., 0] * iz + cam.cx
    v = cam.fy * Xc[..., 1] * iz + cam.cy
    r = torch.stack([u, v], dim=-1) - uv_obs
    Jproj = project_jacobian(cam, Xc)
    J_pose = torch.cat([Jproj @ -se3.hat(Xc), Jproj], dim=-1)
    J_point = Jproj @ T_cw[..., :3, :3]
    return r, J_pose, J_point, z


def line_endpoint_residual(cam, T_cw, X_w, line2d):
    """Signed distance of a projected 3D endpoint to an observed 2D line
    (..., 3) with unit-normalized (l0, l1), in pixels.

    Returns (r (...,), J_pose (...,6), J_point (...,3), z (...,))."""
    Xc = se3.transform(T_cw, X_w)
    z = Xc[..., 2]
    iz = 1.0 / z.clamp_min(1e-6)
    u = cam.fx * Xc[..., 0] * iz + cam.cx
    v = cam.fy * Xc[..., 1] * iz + cam.cy
    r = line2d[..., 0] * u + line2d[..., 1] * v + line2d[..., 2]
    dr_dXc = torch.einsum("...i,...ij->...j", line2d[..., :2],
                          project_jacobian(cam, Xc))
    J_pose = torch.cat([torch.einsum("...j,...jk->...k", dr_dXc,
                                     -se3.hat(Xc)), dr_dXc], dim=-1)
    J_point = torch.einsum("...j,...jk->...k", dr_dXc, T_cw[..., :3, :3])
    return r, J_pose, J_point, z


def huber_weight(chi2, delta2):
    """Huber robust-kernel weight rho'(chi2): 1 inside delta^2, else
    delta / sqrt(chi2)."""
    return torch.where(chi2 <= delta2, 1.0,
                       torch.sqrt(delta2 / chi2.clamp_min(1e-12)))

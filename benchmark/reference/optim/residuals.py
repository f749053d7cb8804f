"""Reprojection residuals and analytic Jacobians for points and line
endpoints.

Frozen copy of the port's `optim/residuals.py`: monocular and stereo point edges and
line endpoint edges. The pose
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


def point_residual_stereo(cam, bf, T_cw, X_w, uv_obs, ur_obs):
    """3-component stereo residual (u_l, v_l, u_r) and Jacobians
    (`EdgeStereoSE3ProjectXYZ`): the right-image column is predicted as
    u_r = u_l - bf / z with bf = fx * baseline. Observations with
    ur_obs <= 0 are monocular: their third residual and Jacobian row are
    zero, so mixed edge sets share one batched form.

    Returns (r (...,3), J_pose (...,3,6), J_point (...,3,3), z (...,))."""
    Xc = se3.transform(T_cw, X_w)
    x, y, z = Xc[..., 0], Xc[..., 1], Xc[..., 2]
    iz = 1.0 / z.clamp_min(1e-6)
    iz2 = iz * iz
    u = cam.fx * x * iz + cam.cx
    v = cam.fy * y * iz + cam.cy
    has = ur_obs > 0
    r = torch.stack([u - uv_obs[..., 0], v - uv_obs[..., 1],
                     torch.where(has, u - bf * iz - ur_obs, 0.0)], dim=-1)
    zeros = torch.zeros_like(x)
    row_u = torch.stack([cam.fx * iz, zeros, -cam.fx * x * iz2], dim=-1)
    row_v = torch.stack([zeros, cam.fy * iz, -cam.fy * y * iz2], dim=-1)
    row_ur = (row_u + torch.stack([zeros, zeros, bf * iz2], dim=-1)) \
        * has.to(torch.float32)[..., None]
    Jproj = torch.stack([row_u, row_v, row_ur], dim=-2)
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

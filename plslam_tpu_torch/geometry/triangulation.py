"""Batched two-view triangulation of points and line segments.

Port of `plslam_tpu/geometry/triangulation.py`: every candidate point
triangulates at once through the DLT normal equations, solved in closed form
(adjugate) instead of a per-point SVD; a 3-D line is the intersection of the
first view's endpoint rays with the plane back-projected from the second
view's line.
"""
from __future__ import annotations

import torch

from . import camera, se3


def projection_matrix(K, T_cw):
    """K [R|t]: (...,3,4) projection from world to pixels, for the (3,3)
    intrinsic matrix K (`camera.intrinsics`)."""
    return torch.einsum("ij,...jk->...ik", K, T_cw[..., :3, :4])


def triangulate_dlt(P1, P2, uv1, uv2):
    """Batched DLT triangulation of pixel pairs (...,2) seen by the
    projections P1, P2 ((3,4) or (...,3,4)); returns (...,3) world points.

    Finite-point form: with w = 1, B X = -c in least squares over the four
    row-normalized DLT rows, via the closed-form 3x3 normal equations."""
    def rows(P, uv):
        return (uv[..., 0:1] * P[..., 2, :] - P[..., 0, :],
                uv[..., 1:2] * P[..., 2, :] - P[..., 1, :])

    A = torch.stack(torch.broadcast_tensors(*rows(P1, uv1), *rows(P2, uv2)),
                    dim=-2)                                      # (...,4,4)
    A = A / torch.linalg.vector_norm(A, dim=-1, keepdim=True).clamp_min(1e-12)
    B, c = A[..., :, :3], A[..., :, 3]
    N = torch.einsum("...ki,...kj->...ij", B, B)
    g = -torch.einsum("...ki,...k->...i", B, c)
    return solve3x3(N, g)


def _adjugate(N):
    a, b, c = N[..., 0, 0], N[..., 0, 1], N[..., 0, 2]
    d, e, f = N[..., 1, 0], N[..., 1, 1], N[..., 1, 2]
    g, h, i = N[..., 2, 0], N[..., 2, 1], N[..., 2, 2]
    adj = torch.stack([
        torch.stack([e * i - f * h, c * h - b * i, b * f - c * e], -1),
        torch.stack([f * g - d * i, a * i - c * g, c * d - a * f], -1),
        torch.stack([d * h - e * g, b * g - a * h, a * e - b * d], -1),
    ], -2)
    det = a * adj[..., 0, 0] + b * adj[..., 1, 0] + c * adj[..., 2, 0]
    return adj, det


def _inv_det(det, eps: float):
    return 1.0 / torch.where(det.abs() < eps, eps, det)


def solve3x3(N, g, eps: float = 1e-12):
    """Batched closed-form 3x3 solve N x = g (adjugate / Cramer)."""
    adj, det = _adjugate(N)
    x = adj[..., 0] * g[..., 0:1] + adj[..., 1] * g[..., 1:2] \
        + adj[..., 2] * g[..., 2:3]
    return x * _inv_det(det, eps)[..., None]


def inv3x3(N, eps: float = 1e-12):
    """Batched closed-form 3x3 inverse (adjugate / det)."""
    adj, det = _adjugate(N)
    return adj * _inv_det(det, eps)[..., None, None]


def backproject_plane(K, T_cw, line_2d):
    """Plane (...,4) in world coordinates (n . X + d = 0, unnormalized)
    through the camera center and the observed line `line_2d` (...,3), a
    homogeneous line in undistorted pixels: P^T l."""
    return torch.einsum("...ji,...j->...i", projection_matrix(K, T_cw),
                        line_2d)


def line_from_endpoints_2d(uv_a, uv_b):
    """Homogeneous 2-D line (...,3) through two pixels, scaled so that
    (l0, l1) is a unit normal."""
    one = torch.ones_like(uv_a[..., :1])
    l = torch.linalg.cross(torch.cat([uv_a, one], -1),
                           torch.cat([uv_b, one], -1))
    return l / torch.linalg.vector_norm(l[..., :2], dim=-1,
                                        keepdim=True).clamp_min(1e-12)


def intersect_ray_plane(origin, direction, plane):
    """Rays (origin (...,3), direction (...,3)) against planes (...,4):
    (points (...,3), ray parameter t (...,))."""
    denom = torch.sum(plane[..., :3] * direction, dim=-1)
    t = -(torch.sum(plane[..., :3] * origin, dim=-1) + plane[..., 3]) \
        / torch.where(denom.abs() < 1e-12, 1e-12, denom)
    return origin + t[..., None] * direction, t


def triangulate_line_two_view(cam, T1_cw, T2_cw, uv1_a, uv1_b, uv2_a, uv2_b):
    """Two-view line-segment triangulation (`Initializer::LineTriangulate`):
    view 1's endpoint rays meet the plane back-projected from view 2's
    infinite line. Returns (Xa_w, Xb_w, depth_a, depth_b), the depths in view
    1 (the rays have unit z, so the ray parameter is the depth)."""
    K = camera.intrinsics(cam, T1_cw.device).to(T1_cw.dtype)
    plane2_w = backproject_plane(K, T2_cw, line_from_endpoints_2d(uv2_a, uv2_b))
    T1_wc = se3.se3_inv(T1_cw)
    R1_wc, c1_w = T1_wc[..., :3, :3], T1_wc[..., :3, 3]
    ray = lambda uv: torch.einsum("...ij,...j->...i", R1_wc,
                                  camera.unproject(cam, uv))
    Xa, ta = intersect_ray_plane(c1_w, ray(uv1_a), plane2_w)
    Xb, tb = intersect_ray_plane(c1_w, ray(uv1_b), plane2_w)
    return Xa, Xb, ta, tb


def parallax_cos(c1_w, c2_w, X_w):
    """Cosine of the parallax angle at X between two camera centers."""
    v1 = c1_w - X_w
    v2 = c2_w - X_w
    n1 = torch.linalg.vector_norm(v1, dim=-1).clamp_min(1e-12)
    n2 = torch.linalg.vector_norm(v2, dim=-1).clamp_min(1e-12)
    return torch.sum(v1 * v2, dim=-1) / (n1 * n2)

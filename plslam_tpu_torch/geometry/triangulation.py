"""Batched two-view triangulation of points.

Port of the point half of `plslam_tpu/geometry/triangulation.py`: every
candidate triangulates at once through the DLT normal equations, solved in
closed form (adjugate) instead of a per-point SVD. The line functions wait
for the port of lines (ROADMAP Queue 1 item 11).
"""
from __future__ import annotations

import torch


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


def parallax_cos(c1_w, c2_w, X_w):
    """Cosine of the parallax angle at X between two camera centers."""
    v1 = c1_w - X_w
    v2 = c2_w - X_w
    n1 = torch.linalg.vector_norm(v1, dim=-1).clamp_min(1e-12)
    n2 = torch.linalg.vector_norm(v2, dim=-1).clamp_min(1e-12)
    return torch.sum(v1 * v2, dim=-1) / (n1 * n2)

"""Batched RANSAC PnP for relocalization.

Port of `plslam_tpu/solvers/pnp.py` (`PnPsolver`: EPnP + RANSAC): every
hypothesis is generated, solved and scored at once. The minimal solver is
EPnP on 4-point sets (control points by PCA, barycentric coordinates, the
4-vector null space of M, a case-1 beta start and 5 Gauss-Newton steps on
the 6 control-point distances, Procrustes); the 6-point DLT solver stays as
`minimal="dlt"`. Minimal sets come from a CPU `torch.Generator`
(`twoview.sample_minimal_sets`) or are passed in as `sets`. On CUDA the
batched eigh and SVD check their solver status, so a call waits for the
device (relocalization reads its verdict back anyway).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from .twoview import sample_minimal_sets

CHI2 = 5.991
_PAIR_I = (0, 0, 0, 1, 1, 2)
_PAIR_J = (1, 2, 3, 2, 3, 3)


class PnPResult(NamedTuple):
    ok: torch.Tensor         # () bool
    T: torch.Tensor          # (4,4) world -> camera
    inliers: torch.Tensor    # (N,) bool
    n_inliers: torch.Tensor  # () int32


def _diag3(d):
    """(...,) -> (..., 3) of [1, 1, d]."""
    one = torch.ones_like(d)
    return torch.stack([one, one, d], -1)


def _dlt_projection(X, uv):
    """Minimal 6-point DLT: (..., 6, 3), (..., 6, 2) -> (..., 3, 4)
    projection matrices in normalized image coordinates."""
    Xh = torch.cat([X, torch.ones_like(X[..., :1])], -1)         # (..., 6, 4)
    z = torch.zeros_like(Xh)
    r1 = torch.cat([Xh, z, -uv[..., 0:1] * Xh], -1)               # (..., 6, 12)
    r2 = torch.cat([z, Xh, -uv[..., 1:2] * Xh], -1)
    A = torch.cat([r1, r2], -2)                                   # (..., 12, 12)
    A = A / torch.linalg.vector_norm(A, dim=-1,
                                     keepdim=True).clamp_min(1e-12)
    _, v = torch.linalg.eigh(A.transpose(-1, -2) @ A)
    return v[..., :, 0].reshape(v.shape[:-2] + (3, 4))


def _pose_from_projection(P):
    """(..., 3, 4) normalized projection -> (R, t), R in SO(3) by
    Procrustes, the scale sign fixed by det."""
    U, S, Vt = torch.linalg.svd(P[..., :3])
    d = torch.linalg.det(U @ Vt)
    R = (U * _diag3(d)[..., None, :]) @ Vt
    scale = S.sum(-1) / 3.0 * torch.sign(d)
    return R, P[..., 3] / torch.where(scale.abs() < 1e-12, 1e-12,
                                      scale)[..., None]


def _procrustes_rt(Xw, Xc):
    """Rigid (R, t) minimizing ||R Xw + t - Xc|| (`estimate_R_and_t`),
    batched over leading dims of (..., S, 3)."""
    mw, mc = Xw.mean(-2), Xc.mean(-2)
    H = (Xw - mw[..., None, :]).transpose(-1, -2) @ (Xc - mc[..., None, :])
    U, _, Vt = torch.linalg.svd(H)
    V, Ut = Vt.transpose(-1, -2), U.transpose(-1, -2)
    d = torch.linalg.det(V @ Ut)
    R = (V * _diag3(d)[..., None, :]) @ Ut
    return R, mc - torch.einsum("...ij,...j->...i", R, mw)


def _epnp_minimal(X, xn):
    """EPnP on minimal sets: X (..., S, 3) world points, xn (..., S, 2)
    normalized image coordinates -> (R (..., 3, 3), t (..., 3))."""
    S = X.shape[-2]
    batch = X.shape[:-2]
    c0 = X.mean(-2)                                               # (..., 3)
    A = X - c0[..., None, :]
    cov = A.transpose(-1, -2) @ A / S
    w, V = torch.linalg.eigh(cov)                                 # ascending
    sc = torch.sqrt(w.clamp_min(1e-12))
    C = torch.cat([c0[..., None, :],
                   c0[..., None, :] + sc[..., :, None]
                   * V.transpose(-1, -2)], -2)                    # (..., 4, 3)
    # barycentric coordinates: [C^T; 1] a_i = [X_i; 1]
    ones = lambda n: torch.ones(batch + (1, n), dtype=X.dtype,
                                device=X.device)
    Ch = torch.cat([C.transpose(-1, -2), ones(4)], -2)            # (..., 4, 4)
    Xh = torch.cat([X.transpose(-1, -2), ones(S)], -2)            # (..., 4, S)
    alpha = torch.linalg.solve_ex(Ch, Xh, check_errors=False
                                  ).result.transpose(-1, -2)      # (..., S, 4)
    # M (2S, 12) with fx = fy = 1, cx = cy = 0
    zeros = torch.zeros_like(alpha)
    mu = torch.stack([alpha, zeros, -alpha * xn[..., 0:1]], -1)   # (..., S, 4, 3)
    mv = torch.stack([zeros, alpha, -alpha * xn[..., 1:2]], -1)
    M = torch.cat([mu.reshape(batch + (S, 12)),
                   mv.reshape(batch + (S, 12))], -2)
    _, Vm = torch.linalg.eigh(M.transpose(-1, -2) @ M)
    nullv = Vm[..., :, :4]                                        # (..., 12, 4)

    pi, pj = list(_PAIR_I), list(_PAIR_J)
    dw = C[..., pi, :] - C[..., pj, :]
    rho = torch.sum(dw * dw, -1)                                  # (..., 6)
    Vc = nullv.transpose(-1, -2).reshape(batch + (4, 4, 3))       # (.., vec, cp, 3)
    dv = Vc[..., :, pi, :] - Vc[..., :, pj, :]                    # (..., 4, 6, 3)

    # case-1 start: x = beta * v1
    d1 = torch.sum(dv[..., 0, :, :] ** 2, -1)                     # (..., 6)
    b1 = torch.sum(torch.sqrt(d1.clamp_min(1e-18)) * torch.sqrt(rho), -1) \
        / d1.sum(-1).clamp_min(1e-18)
    betas = torch.cat([b1[..., None], torch.zeros_like(dv[..., :3, 0, 0])],
                      -1)                                         # (..., 4)
    # Gauss-Newton on f_k(beta) = ||sum_i beta_i dv_i[k]||^2 - rho_k
    G = torch.einsum("...akd,...bkd->...kab", dv, dv)             # (..., 6, 4, 4)
    eye4 = torch.eye(4, dtype=X.dtype, device=X.device)
    for _ in range(5):
        Gb = torch.einsum("...kab,...b->...ka", G, betas)         # (..., 6, 4)
        f = torch.einsum("...a,...ka->...k", betas, Gb) - rho
        J = 2.0 * Gb
        Jt = J.transpose(-1, -2)
        db = torch.linalg.solve_ex(Jt @ J + 1e-9 * eye4, (Jt @ f[..., None]),
                                   check_errors=False).result[..., 0]
        betas = betas - db
    Cc = torch.einsum("...a,...acd->...cd", betas, Vc)            # (..., 4, 3)
    Xc = alpha @ Cc                                               # (..., S, 3)
    # depth-sign fix (compute_ccs / compute_pcs)
    flip = Xc[..., 2].sum(-1) < 0
    Xc = torch.where(flip[..., None, None], -Xc, Xc)
    return _procrustes_rt(X, Xc)


def ransac_pnp(generator, X, uv, mask, cam, sigma2=None, n_iters: int = 256,
               min_inliers: int = 10, minimal: str = "epnp",
               sets=None) -> PnPResult:
    """X: (N,3) world points, uv: (N,2) observed undistorted pixels, mask:
    (N,) candidate validity. `n_iters` minimal sets ("epnp": 4 points, the
    reference's; "dlt": 6) are solved and scored at once; the winner is the
    first hypothesis with the most inliers (in front, chi2 < 5.991).
    `sets` (n_iters, n_min) gives the sets, else `generator` draws them."""
    N = X.shape[0]
    if sigma2 is None:
        sigma2 = torch.ones(N, device=X.device)
    xn = torch.stack([(uv[:, 0] - cam.cx) / cam.fx,
                      (uv[:, 1] - cam.cy) / cam.fy], -1)
    if sets is None:
        sets = sample_minimal_sets(generator, mask, n_iters,
                                   4 if minimal == "epnp" else 6)
    sets = sets.to(X.device)
    if minimal == "epnp":
        Rs, ts = _epnp_minimal(X[sets], xn[sets])
    else:
        Rs, ts = _pose_from_projection(_dlt_projection(X[sets], xn[sets]))
    Xc = X @ Rs.transpose(-1, -2) + ts[:, None, :]                # (iters, N, 3)
    z = Xc[..., 2]
    u = cam.fx * Xc[..., 0] / z.clamp_min(1e-6) + cam.cx
    v = cam.fy * Xc[..., 1] / z.clamp_min(1e-6) + cam.cy
    chi = ((u - uv[:, 0]) ** 2 + (v - uv[:, 1]) ** 2) / sigma2
    goods = mask & (z > 0) & (chi < CHI2)
    n_good = goods.sum(-1, dtype=torch.int32)
    best = torch.argmax(n_good)
    pick = lambda x: x.index_select(0, best.reshape(1))[0]
    n = pick(n_good)
    return PnPResult(ok=n >= min_inliers, T=se3.rt_to_mat(pick(Rs), pick(ts)),
                     inliers=pick(goods),
                     n_inliers=n)

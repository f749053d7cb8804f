"""Two-view monocular bootstrap: parallel-hypothesis H/F RANSAC + SfM.

Port of `plslam_tpu/solvers/twoview.py`: all 200 homography and 200
fundamental hypotheses are fitted and scored as one batch, every candidate
motion is checked at once, and the model choice (RH > 0.40), score caps,
reconstruction gates and winner rule are the JAX package's.

The minimal sets cannot follow the JAX package's threefry stream, so they are
Gumbel top-k over uniforms drawn from a CPU `torch.Generator` (the same sets
on every device for one seed); `initialize_two_view` also takes precomputed
sets. SVD and eigenvector signs differ between LAPACK and cuSOLVER, so only
R, t and the triangulation verdicts are comparable across packages, never the
raw H or F.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import triangulation as tri

CHI2_H = 5.991
CHI2_F = 3.841
SCORE_REF = 5.991  # both models accumulate score against this cap


def normalize_points(uv, mask):
    """Hartley normalization (zero mean, unit mean-abs-dev per axis) over
    the masked points; returns (normalized uv, 3x3 T with x_n = T x)."""
    m = mask.to(torch.float32)
    n = m.sum().clamp_min(1.0)
    mean = torch.sum(uv * m[:, None], dim=0) / n
    d = (uv - mean).abs() * m[:, None]
    s = 1.0 / (torch.sum(d, dim=0) / n).clamp_min(1e-6)
    z, o = torch.zeros_like(s[0]), torch.ones_like(s[0])
    T = torch.stack([torch.stack([s[0], z, -mean[0] * s[0]]),
                     torch.stack([z, s[1], -mean[1] * s[1]]),
                     torch.stack([z, z, o])])
    return (uv - mean) * s, T


def _nullvec(A):
    """Smallest right-singular vector of A via eigh(A^T A), batched."""
    _, v = torch.linalg.eigh(torch.einsum("...ki,...kj->...ij", A, A))
    return v[..., :, 0]


def fit_homography(uv1, uv2):
    """DLT homography from 8 correspondences (..., 8, 2) -> (..., 3, 3)."""
    x1, y1 = uv1[..., 0], uv1[..., 1]
    x2, y2 = uv2[..., 0], uv2[..., 1]
    z, o = torch.zeros_like(x1), torch.ones_like(x1)
    r1 = torch.stack([z, z, z, -x1, -y1, -o, y2 * x1, y2 * y1, y2], dim=-1)
    r2 = torch.stack([x1, y1, o, z, z, z, -x2 * x1, -x2 * y1, -x2], dim=-1)
    h = _nullvec(torch.cat([r1, r2], dim=-2))
    return h.reshape(h.shape[:-1] + (3, 3))


def fit_fundamental(uv1, uv2):
    """8-point fundamental (..., 8, 2) -> rank-2 (..., 3, 3)."""
    x1, y1 = uv1[..., 0], uv1[..., 1]
    x2, y2 = uv2[..., 0], uv2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)
    f = _nullvec(A)
    U, S, Vh = torch.linalg.svd(f.reshape(f.shape[:-1] + (3, 3)))
    S = torch.cat([S[..., :2], torch.zeros_like(S[..., 2:])], dim=-1)
    return U @ (S[..., :, None] * Vh)


def _hom(uv):
    return torch.cat([uv, torch.ones_like(uv[..., :1])], dim=-1)


def _inv(M):
    return torch.linalg.inv_ex(M).inverse   # no error check: no host wait


def _take(x, i):
    """x[i] for a 0-d index tensor i (indexing with it would read i back to
    the host)."""
    return x.index_select(0, i.reshape(1))[0]


def score_homography(H21, uv1, uv2, mask, sigma2: float = 1.0):
    """Symmetric-transfer score (`CheckHomography`); H21 may be batched.
    Returns (score, inliers (..., N) bool)."""
    def transfer(H, pa, ub):
        q = torch.einsum("...ij,nj->...ni", H, pa)
        q = q[..., :2] / torch.where(q[..., 2:].abs() < 1e-12, 1e-12,
                                     q[..., 2:])
        return torch.sum((q - ub) ** 2, dim=-1) / sigma2

    chi_12 = transfer(H21, _hom(uv1), uv2)
    chi_21 = transfer(_inv(H21), _hom(uv2), uv1)
    ok = (chi_12 < CHI2_H) & (chi_21 < CHI2_H) & mask
    score = torch.where(ok, (SCORE_REF - chi_12) + (SCORE_REF - chi_21),
                        0.0).sum(-1)
    return score, ok


def score_fundamental(F21, uv1, uv2, mask, sigma2: float = 1.0):
    """Epipolar-distance score (`CheckFundamental`); F21 may be batched."""
    def epi_chi(F, pa, pb):  # distance of pb to the line F @ pa
        l = torch.einsum("...ij,nj->...ni", F, pa)
        num = torch.sum(l * pb, dim=-1)
        den = (l[..., 0] ** 2 + l[..., 1] ** 2).clamp_min(1e-12)
        return num * num / den / sigma2

    p1, p2 = _hom(uv1), _hom(uv2)
    chi_2 = epi_chi(F21, p1, p2)
    chi_1 = epi_chi(F21.transpose(-1, -2), p2, p1)
    ok = (chi_2 < CHI2_F) & (chi_1 < CHI2_F) & mask
    score = (torch.where((chi_2 < CHI2_F) & mask, SCORE_REF - chi_2, 0.0)
             + torch.where((chi_1 < CHI2_F) & mask, SCORE_REF - chi_1, 0.0)
             ).sum(-1)
    return score, ok


def sample_minimal_sets(generator: torch.Generator, match_mask,
                        n_iters: int, set_size: int = 8):
    """(n_iters, set_size) int64 indices drawn without replacement from the
    valid matches: Gumbel top-k over uniforms from the CPU `generator`,
    ties to the lowest index."""
    u = torch.rand((n_iters, match_mask.shape[0]), generator=generator)
    g = -torch.log(-torch.log(u.clamp_min(1e-20)))
    g = torch.where(match_mask[None, :], g.to(match_mask.device),
                    -torch.inf)
    return torch.sort(g, dim=1, descending=True, stable=True)[1][:, :set_size]


def decompose_essential(E):
    """E -> (4, 3, 3) rotations + (4, 3) unit translations."""
    U, _, Vh = torch.linalg.svd(E)
    U = U * torch.sign(torch.linalg.det(U))
    Vh = Vh * torch.sign(torch.linalg.det(Vh))
    z, o = torch.zeros_like(E[0, 0]), torch.ones_like(E[0, 0])
    W = torch.stack([torch.stack([z, -o, z]), torch.stack([o, z, z]),
                     torch.stack([z, z, o])])
    R1, R2 = U @ W @ Vh, U @ W.T @ Vh
    t = U[:, 2] / torch.linalg.vector_norm(U[:, 2]).clamp_min(1e-12)
    return torch.stack([R1, R1, R2, R2]), torch.stack([t, -t, t, -t])


def decompose_homography(H21, K):
    """Faugeras SVD decomposition of a homography into 8 motions:
    (Rs (8,3,3), ts (8,3) unit-norm)."""
    U, d, Vh = torch.linalg.svd(_inv(K) @ H21 @ K)
    s = torch.linalg.det(U) * torch.linalg.det(Vh)
    d1, d2, d3 = d[0], d[1], d[2]
    denom = (d1 * d1 - d3 * d3).clamp_min(1e-12)
    aux1 = torch.sqrt(((d1 * d1 - d2 * d2) / denom).clamp_min(0.0))
    aux3 = torch.sqrt(((d2 * d2 - d3 * d3) / denom).clamp_min(0.0))
    x1 = torch.stack([aux1, aux1, -aux1, -aux1])
    x3 = torch.stack([aux3, -aux3, aux3, -aux3])
    zero4, one4 = torch.zeros_like(x1), torch.ones_like(x1)
    prod = ((d1 * d1 - d2 * d2) * (d2 * d2 - d3 * d3)).clamp_min(0.0)

    # case d' = +d2
    den_p = ((d1 + d3) * d2).clamp_min(1e-12)
    aux_st = torch.sqrt(prod) / den_p
    ct = ((d2 * d2 + d1 * d3) / den_p).expand(4)
    st = torch.stack([aux_st, -aux_st, -aux_st, aux_st])
    Rp_pos = torch.stack([torch.stack([ct, zero4, -st], -1),
                          torch.stack([zero4, one4, zero4], -1),
                          torch.stack([st, zero4, ct], -1)], -2)
    tp_pos = (d1 - d3) * torch.stack([x1, zero4, -x3], dim=-1)

    # case d' = -d2
    den_n = ((d1 - d3).abs() * d2).clamp_min(1e-12)
    sgn = torch.sign(d1 - d3)
    aux_sp = torch.sqrt(prod) / den_n * sgn
    cp = ((d1 * d3 - d2 * d2) / den_n * sgn).expand(4)
    sp = torch.stack([aux_sp, -aux_sp, -aux_sp, aux_sp])
    Rp_neg = torch.stack([torch.stack([cp, zero4, sp], -1),
                          torch.stack([zero4, -one4, zero4], -1),
                          torch.stack([sp, zero4, -cp], -1)], -2)
    tp_neg = (d1 + d3) * torch.stack([x1, zero4, x3], dim=-1)

    Rp = torch.cat([Rp_pos, Rp_neg])
    tp = torch.cat([tp_pos, tp_neg])
    Rs = s * (U @ Rp @ Vh)
    ts = torch.einsum("ij,nj->ni", U, tp)
    ts = ts / torch.linalg.vector_norm(ts, dim=-1, keepdim=True
                                       ).clamp_min(1e-12)
    return Rs, ts


def check_rt(R, t, uv1, uv2, mask, K, sigma2: float = 1.0):
    """Score motion hypotheses (R (...,3,3), t (...,3)) by triangulating
    every match (`CheckRT`): finite, positive depth in both views,
    reprojection chi2 < 4 sigma^2 in both, parallax below the gate.

    Returns (n_good (...), parallax_deg (...) of the 50th-best good point,
    X (..., N, 3), good (..., N))."""
    eye = torch.eye(3, dtype=R.dtype, device=R.device)
    P1 = K @ torch.cat([eye, torch.zeros_like(eye[:, :1])], dim=-1)
    P2 = K @ torch.cat([R, t[..., None]], dim=-1)
    X = tri.triangulate_dlt(P1, P2[..., None, :, :], uv1, uv2)   # (...,N,3)
    finite = torch.isfinite(X).all(-1)
    z1 = X[..., 2]
    z2 = (torch.einsum("...ij,...nj->...ni", R, X) + t[..., None, :])[..., 2]

    def reproj_chi(P, uv):
        q = torch.einsum("...ij,...nj->...ni", P[..., :3], X) \
            + P[..., None, :, 3]
        q2 = q[..., :2] / torch.where(q[..., 2:].abs() < 1e-12, 1e-12,
                                      q[..., 2:])
        return torch.sum((q2 - uv) ** 2, dim=-1) / sigma2

    chi1 = reproj_chi(P1, uv1)
    chi2v = reproj_chi(P2, uv2)
    c2 = -torch.einsum("...ji,...j->...i", R, t)
    cosp = tri.parallax_cos(torch.zeros_like(c2)[..., None, :],
                            c2[..., None, :], X)
    good = (mask & finite & (z1 > 0) & (z2 > 0) & (chi1 < 4.0 * sigma2)
            & (chi2v < 4.0 * sigma2) & (cosp < 0.99998))
    n_good = good.sum(-1, dtype=torch.int32)
    sorted_cos = torch.sort(torch.where(good, cosp, 1.0), dim=-1)[0]
    idx50 = (n_good - 1).clamp(0, 50).long()
    c50 = sorted_cos.gather(-1, idx50[..., None])[..., 0]
    parallax = torch.rad2deg(torch.arccos(c50.clamp(-1.0, 1.0)))
    return n_good, torch.where(n_good > 0, parallax, 0.0), X, good


class TwoViewResult(NamedTuple):
    success: torch.Tensor          # () bool
    used_homography: torch.Tensor  # () bool
    R: torch.Tensor                # (3,3) frame1 -> frame2
    t: torch.Tensor                # (3,) unit-scale translation
    X: torch.Tensor                # (N,3) triangulated points (frame 1)
    good: torch.Tensor             # (N,) bool triangulation validity
    n_good: torch.Tensor           # () int32
    inliers: torch.Tensor          # (N,) bool model inliers


def initialize_two_view(generator, uv1, uv2, match_mask, K, n_iters: int = 200,
                        sigma: float = 1.0, min_triangulated: int = 50,
                        idx=None) -> TwoViewResult:
    """Relative pose + structure from two views (`Initializer::Initialize`).
    `generator` draws the minimal sets (`sample_minimal_sets`) unless `idx`
    (n_iters, 8) gives them. On CUDA the batched eigh and SVD check their
    solver status, so an attempt waits for the device a few times (the
    initialization path only)."""
    sigma2 = sigma * sigma
    uv1n, T1 = normalize_points(uv1, match_mask)
    uv2n, T2 = normalize_points(uv2, match_mask)
    if idx is None:
        idx = sample_minimal_sets(generator, match_mask, n_iters)
    s1, s2 = uv1n[idx], uv2n[idx]                        # (iters, 8, 2)

    H21 = _inv(T2)[None] @ fit_homography(s1, s2) @ T1[None]
    h_scores, _ = score_homography(H21, uv1, uv2, match_mask, sigma2)
    H_best = _take(H21, torch.argmax(h_scores))
    SH = h_scores.max()
    _, h_inliers = score_homography(H_best, uv1, uv2, match_mask, sigma2)

    F21 = T2.T[None] @ fit_fundamental(s1, s2) @ T1[None]
    f_scores, _ = score_fundamental(F21, uv1, uv2, match_mask, sigma2)
    F_best = _take(F21, torch.argmax(f_scores))
    SF = f_scores.max()
    _, f_inliers = score_fundamental(F_best, uv1, uv2, match_mask, sigma2)

    use_h = SH / (SH + SF).clamp_min(1e-12) > 0.40

    # candidate motions: 8 from H, 4 from F, padded to 16
    Rs_h, ts_h = decompose_homography(H_best, K)
    Rs_f, ts_f = decompose_essential(K.T @ F_best @ K)
    eye4 = torch.eye(3, device=K.device).expand(4, 3, 3)
    Rs = torch.cat([Rs_h, Rs_f, eye4])
    ts = torch.cat([ts_h, ts_f, torch.zeros_like(ts_f)])
    slot = torch.arange(16, device=K.device)
    cand_valid = torch.where(use_h, slot < 8, (slot >= 8) & (slot < 12))
    model_inliers = torch.where(use_h, h_inliers, f_inliers)

    n_goods, parallaxes, Xs, goods = check_rt(Rs, ts, uv1, uv2,
                                              model_inliers, K, sigma2)
    n_goods = torch.where(cand_valid, n_goods, -1)
    best = torch.argmax(n_goods)
    n_best = _take(n_goods, best)
    n_inliers = model_inliers.sum(dtype=torch.int32)
    min_good = (0.9 * n_inliers).to(torch.int32).clamp_min(min_triangulated)
    n_second = torch.where(slot == best, -1, n_goods).max()
    unique = n_second.to(torch.float32) < 0.75 * n_best.to(torch.float32)
    success = (n_best >= min_good) & unique & (_take(parallaxes, best) > 1.0)
    return TwoViewResult(success=success, used_homography=use_h,
                         R=_take(Rs, best), t=_take(ts, best),
                         X=_take(Xs, best), good=_take(goods, best),
                         n_good=n_best, inliers=model_inliers)

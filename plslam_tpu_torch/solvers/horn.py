"""Horn absolute orientation and batched Sim3 RANSAC.

Port of `plslam_tpu/solvers/horn.py` (`Sim3Solver`: 3-point RANSAC, the
closed form by SVD, inliers by reprojection in both images). All hypotheses
are solved and scored at once. The minimal sets are drawn from a CPU
`torch.Generator` (`twoview.sample_minimal_sets`) or passed in as `sets`.
On CUDA the batched SVD checks its solver status, so a call waits for the
device (the loop Sim3 stage reads its counts back anyway).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry.sim3 import Sim3
from .twoview import sample_minimal_sets

CHI2 = 9.21  # per-image gate (`src/Sim3Solver.cc:87-88`)


def horn_sim3(A, B, fix_scale: bool = False) -> Sim3:
    """Closed-form similarity A -> B from paired points (..., n, 3)."""
    ca = A.mean(dim=-2, keepdim=True)
    cb = B.mean(dim=-2, keepdim=True)
    A0, B0 = A - ca, B - cb
    H = torch.einsum("...ni,...nj->...ij", B0, A0)
    U, S, Vt = torch.linalg.svd(H)
    d = torch.linalg.det(U @ Vt)
    D = torch.stack([torch.ones_like(d), torch.ones_like(d), d], -1)
    R = (U * D[..., None, :]) @ Vt
    if fix_scale:
        s = torch.ones(A.shape[:-2], dtype=A.dtype, device=A.device)
    else:
        s = torch.sum(S * D, dim=-1) / torch.sum(A0 * A0, dim=(-1, -2)
                                                 ).clamp_min(1e-12)
    t = cb[..., 0, :] - s[..., None] * torch.einsum("...ij,...j->...i", R,
                                                    ca[..., 0, :])
    return Sim3(s, R, t)


class Sim3RansacResult(NamedTuple):
    ok: torch.Tensor
    S12: Sim3              # maps frame-2 coordinates into frame 1
    inliers: torch.Tensor  # (N,) bool
    n_inliers: torch.Tensor


def _project(cam, Xc):
    z = Xc[..., 2].clamp_min(1e-6)
    return torch.stack([cam.fx * Xc[..., 0] / z + cam.cx,
                        cam.fy * Xc[..., 1] / z + cam.cy], -1)


def _apply_each(S: Sim3, X):
    """(B,) hypotheses applied to the same (N, 3) points -> (B, N, 3)."""
    return S.s[:, None, None] * (X @ S.R.transpose(-1, -2)) + S.t[:, None, :]


def ransac_sim3(generator, X1, X2, uv1, uv2, mask, cam, sigma2_1=None,
                sigma2_2=None, n_iters: int = 1024, min_inliers: int = 20,
                fix_scale: bool = False, sets=None) -> Sim3RansacResult:
    """X1 / X2: (N,3) camera-frame landmarks of matched keypoints in keyframes
    1 and 2, uv1 / uv2 their observed pixels. Finds S12 with X1 ~ S12(X2)
    from `n_iters` 3-point Horn fits, scoring inliers by reprojection in
    both images (`Sim3Solver::CheckInliers`); the winner is the first
    hypothesis with the most inliers. `sets` (n_iters, 3) gives the
    minimal sets, else `generator` draws them."""
    N = X1.shape[0]
    if sigma2_1 is None:
        sigma2_1 = torch.ones(N, device=X1.device)
    if sigma2_2 is None:
        sigma2_2 = torch.ones(N, device=X1.device)
    if sets is None:
        sets = sample_minimal_sets(generator, mask, n_iters, 3)
    sets = sets.to(X1.device)
    A, B = X2[sets], X1[sets]                          # (iters, 3, 3)
    S12s = horn_sim3(A, B, fix_scale)
    S21s = horn_sim3(B, A, fix_scale)
    e1 = torch.sum((_project(cam, _apply_each(S12s, X2)) - uv1) ** 2,
                   -1) / sigma2_1
    e2 = torch.sum((_project(cam, _apply_each(S21s, X1)) - uv2) ** 2,
                   -1) / sigma2_2
    goods = mask & (e1 < CHI2) & (e2 < CHI2)           # (iters, N)
    n_good = goods.sum(-1, dtype=torch.int32)
    best = torch.argmax(n_good)
    pick = lambda x: x.index_select(0, best.reshape(1))[0]
    n = pick(n_good)
    return Sim3RansacResult(ok=n >= min_inliers,
                            S12=Sim3(pick(S12s.s), pick(S12s.R),
                                     pick(S12s.t)),
                            inliers=pick(goods), n_inliers=n)

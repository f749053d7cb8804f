"""Pose-only Levenberg-Marquardt with staged chi2 outlier reclassification.

Frozen copy of the port's `optim/pose_opt.py`: point edges (monocular, or with
`pt_ur` the 3-dof stereo edges of a depth sensor) plus line endpoint edges;
`rounds` x `iters_per_round` LM iterations on the masked 6x6 normal
equations, Huber kernels in all but the last round, and chi2 gates (5.991
mono points, 7.815 stereo points, 3.84 per line endpoint) re-tested after
every round.

The loops are Python loops over tensor ops with no host synchronization:
an iteration's accept test selects with `torch.where`, the 6x6 solve does not
check for singularity (a non-finite step is rejected instead), and no tensor
is copied from the host.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import se3
from . import residuals

CHI2_POINT = 5.991
CHI2_STEREO = 7.815   # 3-dof stereo point edges
CHI2_LINE = 3.84


class PoseObs(NamedTuple):
    """Fixed-shape observation set for pose-only optimization."""

    pt_xyz: torch.Tensor     # (P, 3) world points
    pt_uv: torch.Tensor      # (P, 2) observed (undistorted) pixels
    pt_sigma2: torch.Tensor  # (P,) per-octave variance (scale^2)
    pt_mask: torch.Tensor    # (P,) bool, structurally present edges
    ln_xyz: torch.Tensor     # (L, 3) world line endpoints
    ln_l2d: torch.Tensor     # (L, 3) observed 2D lines (unit normal)
    ln_mask: torch.Tensor    # (L,) bool
    ln_info: torch.Tensor    # (L,) information weight
    # stereo: per-keypoint right-image column (<= 0: a monocular edge);
    # None keeps the 2-component monocular edges
    pt_ur: Optional[torch.Tensor] = None   # (P,)
    bf: float = 0.0                        # fx * baseline

    @staticmethod
    def empty_lines(n: int = 1, device=None):
        """(ln_xyz, ln_l2d, ln_mask, ln_info) of `n` masked dummy edges."""
        l2d = torch.stack([torch.ones(n, device=device),
                           torch.zeros(n, device=device),
                           torch.full((n,), -1e9, device=device)], dim=-1)
        return (torch.zeros((n, 3), device=device), l2d,
                torch.zeros((n,), dtype=torch.bool, device=device),
                torch.ones((n,), device=device))


class PoseOptResult(NamedTuple):
    T: torch.Tensor          # (4,4) optimized pose
    pt_inlier: torch.Tensor  # (P,) bool
    ln_inlier: torch.Tensor  # (L,) bool
    n_inliers: torch.Tensor  # () int32 point inliers


def _pt_edges(cam, T, obs: PoseObs):
    """Point residuals, pose Jacobians, depths and the chi2 gate: 5.991 for
    monocular edges, 7.815 per stereo edge (`pt_ur` > 0)."""
    if obs.pt_ur is None:
        r, J, _, z = residuals.point_residual(cam, T, obs.pt_xyz, obs.pt_uv)
        return r, J, z, CHI2_POINT
    r, J, _, z = residuals.point_residual_stereo(cam, obs.bf, T, obs.pt_xyz,
                                                 obs.pt_uv, obs.pt_ur)
    return r, J, z, torch.where(obs.pt_ur > 0, CHI2_STEREO, CHI2_POINT)


def _normal_equations(cam, T, obs: PoseObs, pt_in, ln_in, robust: bool):
    """Masked 6x6 H, 6 b, the per-edge chi2 and depths at pose T, and the
    point edges' chi2 gate."""
    r_p, J_p, z_p, gate_p = _pt_edges(cam, T, obs)
    w_p = 1.0 / obs.pt_sigma2
    chi2_p = torch.sum(r_p * r_p, dim=-1) * w_p
    m_p = (obs.pt_mask & pt_in & (z_p > 0)).to(torch.float32) * w_p
    if robust:
        m_p = m_p * residuals.huber_weight(chi2_p, gate_p)
    # [J | r] products give H and J^T r in one matrix product each, whose
    # sums run in the same order whether or not the call is batched over
    # streams (`torch.func.vmap`; a matrix-vector J^T r is not)
    Jr_p = torch.cat([J_p, r_p[..., None]], -1)
    G_p = torch.einsum("nij,nik,n->jk", Jr_p, Jr_p, m_p)

    r_l, J_l, _, z_l = residuals.line_endpoint_residual(cam, T, obs.ln_xyz,
                                                        obs.ln_l2d)
    chi2_l = r_l * r_l * obs.ln_info
    m_l = (obs.ln_mask & ln_in & (z_l > 0)).to(torch.float32) * obs.ln_info
    if robust:
        m_l = m_l * residuals.huber_weight(chi2_l, CHI2_LINE)
    Jr_l = torch.cat([J_l, r_l[..., None]], -1)
    G_l = torch.einsum("nj,nk,n->jk", Jr_l, Jr_l, m_l)
    return (G_p[:6, :6] + G_l[:6, :6], -G_p[:6, 6] - G_l[:6, 6], chi2_p,
            chi2_l, z_p, z_l, gate_p)


def _rho(chi2, gate, robust: bool):
    if not robust:
        return chi2
    return torch.where(chi2 > gate,
                       2.0 * torch.sqrt(gate * chi2.clamp_min(0.0)) - gate,
                       chi2)


def _cost(cam, T, obs: PoseObs, pt_in, ln_in, robust: bool):
    """Robustified total cost of the inlier edges at pose T."""
    r_p, _, z_p, gate_p = _pt_edges(cam, T, obs)
    chi2_p = torch.sum(r_p * r_p, dim=-1) / obs.pt_sigma2
    c_p = torch.where(obs.pt_mask & pt_in & (z_p > 0),
                      _rho(chi2_p, gate_p, robust), 0.0).sum()
    r_l, _, _, z_l = residuals.line_endpoint_residual(cam, T, obs.ln_xyz,
                                                      obs.ln_l2d)
    chi2_l = r_l * r_l * obs.ln_info
    c_l = torch.where(obs.ln_mask & ln_in & (z_l > 0),
                      _rho(chi2_l, CHI2_LINE, robust), 0.0).sum()
    return c_p + c_l


def pose_optimize(cam, T_init, obs: PoseObs, rounds: int = 4,
                  iters_per_round: int = 10) -> PoseOptResult:
    """Staged LM of `Optimizer::PoseOptimization`: rounds 1..rounds-1 use
    Huber kernels; after every round all edges are re-tested against the
    chi2 gates and only inliers enter the next round."""
    eye6 = torch.eye(6, device=T_init.device)
    T = T_init
    pt_in, ln_in = obs.pt_mask, obs.ln_mask
    all_pt = torch.ones_like(obs.pt_mask)
    all_ln = torch.ones_like(obs.ln_mask)
    for rd in range(rounds):
        robust = rd < rounds - 1
        lam = torch.full((), 1e-3, device=T.device)
        c_cur = _cost(cam, T, obs, pt_in, ln_in, robust)
        for _ in range(iters_per_round):
            H, b, *_ = _normal_equations(cam, T, obs, pt_in, ln_in, robust)
            Hd = H + lam * torch.diag(torch.diag(H)) + 1e-8 * eye6
            dx = torch.linalg.solve_ex(Hd, b[:, None],
                                       check_errors=False).result[:, 0]
            T_new = se3.se3_exp(dx) @ T
            c_new = _cost(cam, T_new, obs, pt_in, ln_in, robust)
            accept = (c_new < c_cur) & torch.isfinite(T_new).all()
            T = torch.where(accept, T_new, T)
            lam = torch.where(accept, (lam * 0.5).clamp_min(1e-10),
                              (lam * 4.0).clamp_max(1e6))
            c_cur = torch.where(accept, c_new, c_cur)
        _, _, chi2_p, chi2_l, z_p, z_l, gate_p = _normal_equations(
            cam, T, obs, all_pt, all_ln, robust)
        pt_in = (chi2_p <= gate_p) & (z_p > 0) & obs.pt_mask
        ln_in = (chi2_l <= CHI2_LINE) & (z_l > 0) & obs.ln_mask
    return PoseOptResult(T, pt_in, ln_in, pt_in.sum(dtype=torch.int32))

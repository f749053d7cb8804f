"""Trajectory evaluation: ATE (TUM protocol, Horn/umeyama alignment) and
RPE, on the host in numpy.

A copy of `plslam_tpu/utils/metrics.py`, which is numpy already: the port
imports nothing of the JAX package."""
from __future__ import annotations

import numpy as np


def umeyama_align(src, dst, with_scale: bool = True):
    """Least-squares similarity aligning src (N,3) onto dst (N,3).
    Returns (s, R, t)."""
    mu_s = src.mean(0)
    mu_d = dst.mean(0)
    S = src - mu_s
    D = dst - mu_d
    W = D.T @ S / len(src)
    U, d, Vt = np.linalg.svd(W)
    Sg = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        Sg[2, 2] = -1
    R = U @ Sg @ Vt
    if with_scale:
        var = (S * S).sum() / len(src)
        s = (d * np.diag(Sg)).sum() / max(var, 1e-12)
    else:
        s = 1.0
    t = mu_d - s * R @ mu_s
    return s, R, t


def centers_of(T_cw: np.ndarray) -> np.ndarray:
    """(N,4,4) world->cam -> (N,3) camera centers."""
    return np.stack([-T[:3, :3].T @ T[:3, 3] for T in np.asarray(T_cw)])


def ate_rmse(T_est, T_gt, with_scale: bool = True) -> float:
    c_e = centers_of(T_est)
    c_g = centers_of(T_gt)
    s, R, t = umeyama_align(c_e, c_g, with_scale)
    c_al = (s * (R @ c_e.T)).T + t
    return float(np.sqrt(((c_al - c_g) ** 2).sum(-1).mean()))


def rpe_rmse(T_est, T_gt, delta: int = 1):
    """Relative pose error over `delta`-frame intervals: (trans_rmse,
    rot_rmse_deg)."""
    T_est = np.asarray(T_est)
    T_gt = np.asarray(T_gt)
    et, er = [], []
    for i in range(len(T_est) - delta):
        rel_e = T_est[i + delta] @ np.linalg.inv(T_est[i])
        rel_g = T_gt[i + delta] @ np.linalg.inv(T_gt[i])
        E = np.linalg.inv(rel_g) @ rel_e
        et.append(np.linalg.norm(E[:3, 3]))
        ang = np.degrees(np.arccos(np.clip((np.trace(E[:3, :3]) - 1) / 2, -1, 1)))
        er.append(ang)
    return float(np.sqrt(np.mean(np.square(et)))), float(np.sqrt(np.mean(np.square(er))))

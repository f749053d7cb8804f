"""Synthetic rendered sequences with exact ground truth.

Port of `plslam_tpu/datasets/synthetic.py`, which is numpy already: a
deterministic scene of textured planes (world-attached texture, rendered by
inverse plane-homography warping with a z-buffer) plus 3D line segments,
imaged along an analytic camera trajectory. Only the trajectory's SE3
exponential changes, to the port's `geometry/se3.se3_exp`.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..geometry import se3 as _se3


class Plane(NamedTuple):
    origin: np.ndarray   # (3,) world position of texture (0,0)
    e1: np.ndarray       # (3,) world direction of texture u axis (unit)
    e2: np.ndarray       # (3,) world direction of texture v axis (unit)
    scale: float         # meters per texture pixel
    tex: np.ndarray      # (Ht, Wt) float32 texture


class Scene(NamedTuple):
    planes: Sequence[Plane]
    lines: np.ndarray    # (L, 6) world segments [xa ya za xb yb zb]
    points: np.ndarray   # (P, 3) sparse check landmarks (texture corners)
    K: np.ndarray        # (3, 3)
    width: int
    height: int


def _make_texture(rng, h, w):
    """High-contrast, smooth, corner-rich texture."""
    tex = rng.uniform(0, 255, (h // 8, w // 8)).astype(np.float32)
    tex = np.kron(tex, np.ones((8, 8), np.float32))  # blocky 8px squares
    # soften edges slightly so gradients are stable under resampling
    k = np.array([0.25, 0.5, 0.25], np.float32)
    for ax in (0, 1):
        tex = np.apply_along_axis(lambda r: np.convolve(r, k, mode="same"),
                                  ax, tex)
    return tex


def make_scene(n_lines: int = 48, seed: int = 0, width: int = 640,
               height: int = 480, fx: float = 500.0, fy: float = 500.0,
               layout: str = "room") -> Scene:
    """'room': back wall + floor + side wall; 'wall': one fronto-parallel
    plane; 'box': four walls and a floor around the origin."""
    rng = np.random.default_rng(seed)
    ts = 0.01  # 1 texture pixel = 1 cm
    planes = []

    def plane(origin, e1, e2, hw=(800, 1200)):
        return Plane(np.asarray(origin, np.float32),
                     np.asarray(e1, np.float32), np.asarray(e2, np.float32),
                     ts, _make_texture(rng, *hw))

    if layout == "room":
        planes.append(plane([-6.0, -4.0, 9.0], [1, 0, 0], [0, 1, 0], (800, 1200)))
        planes.append(plane([-6.0, 2.5, 2.0], [1, 0, 0], [0, 0.12, 1.0], (800, 1200)))
        planes.append(plane([-5.5, -4.0, 2.0], [0.08, 0, 1.0], [0, 1, 0], (800, 800)))
    elif layout == "wall":
        planes.append(plane([-6.0, -4.5, 6.0], [1, 0, 0], [0, 1, 0], (900, 1200)))
    elif layout == "box":
        planes.append(plane([-6.0, -4.0, 6.0], [1, 0, 0], [0, 1, 0], (800, 1200)))
        planes.append(plane([6.0, -4.0, -6.0], [-1, 0, 0], [0, 1, 0], (800, 1200)))
        planes.append(plane([6.0, -4.0, 6.0], [0, 0, -1], [0, 1, 0], (800, 1200)))
        planes.append(plane([-6.0, -4.0, -6.0], [0, 0, 1], [0, 1, 0], (800, 1200)))
        planes.append(plane([-6.0, 2.5, -6.0], [1, 0, 0], [0, 0, 1], (1200, 1200)))
    else:
        raise ValueError(layout)
    planes = [Plane(p.origin, p.e1 / np.linalg.norm(p.e1),
                    p.e2 / np.linalg.norm(p.e2), p.scale, p.tex)
              for p in planes]

    # 3D line segments floating in front of the walls
    la = np.stack([rng.uniform(-3.5, 3.5, n_lines),
                   rng.uniform(-2.5, 2.5, n_lines),
                   rng.uniform(3.5, 8.0, n_lines)], -1)
    axes = np.eye(3)[rng.integers(0, 3, n_lines)]
    dirs = axes + rng.normal(0, 0.08, (n_lines, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    lb = la + dirs * rng.uniform(0.8, 2.5, (n_lines, 1))
    lines = np.concatenate([la, lb], -1).astype(np.float32)

    # sparse landmark points = texture block corners of the first plane
    p = planes[0]
    gs = 64
    us, vs = np.meshgrid(np.arange(64, p.tex.shape[1] - 64, gs),
                         np.arange(64, p.tex.shape[0] - 64, gs))
    pts = (p.origin[None, :] + us.reshape(-1, 1) * p.e1[None, :] * p.scale
           + vs.reshape(-1, 1) * p.e2[None, :] * p.scale).astype(np.float32)

    K = np.array([[fx, 0, width / 2.0], [0, fy, height / 2.0], [0, 0, 1]],
                 np.float32)
    return Scene(planes, lines, pts, K, width, height)


def trajectory(n_frames: int, kind: str = "orbit", amplitude: float = 1.0):
    """(n_frames, 4, 4) float32 ground-truth world->camera poses.

    'orbit': slow lateral arc with gentle rotation (TUM fr1_xyz-like);
    'forward': dominantly forward motion; 'loop': out and back; 'sweeps':
    out and back with a fixed 600-frame period; 'circle': a 360-degree
    circuit looking radially outward (for the 'box' scene)."""
    Ts = []
    for i in range(n_frames):
        s = i / max(n_frames - 1, 1)
        if kind == "orbit":
            xi = amplitude * np.array([
                0.03 * np.sin(2 * np.pi * s), 0.10 * s,
                0.02 * np.sin(4 * np.pi * s),
                1.2 * s, 0.25 * np.sin(2 * np.pi * s), 0.1 * s,
            ], np.float32)
        elif kind == "forward":
            xi = amplitude * np.array(
                [0.0, 0.25 * s, 0.0, 0.3 * np.sin(2 * np.pi * s), 0.0, 3.0 * s],
                np.float32)
        elif kind in ("loop", "sweeps"):
            w = np.sin(np.pi * s) if kind == "loop" else np.sin(np.pi * i / 300.0)
            xi = amplitude * np.array(
                [0.02 * w, 0.15 * w, 0.01 * w, 1.6 * w, 0.2 * w, 0.3 * w],
                np.float32)
        elif kind == "circle":
            th = 2.0 * np.pi * s
            r = amplitude
            C = np.array([r * np.sin(th), 0.0, r * np.cos(th)])
            # camera axes in world: z = radial out, x = tangent, y = down
            zax = np.array([np.sin(th), 0.0, np.cos(th)])
            xax = np.array([np.cos(th), 0.0, -np.sin(th)])
            yax = np.array([0.0, 1.0, 0.0])
            R = np.stack([xax, yax, zax])          # world -> cam rows
            T = np.eye(4, dtype=np.float32)
            T[:3, :3] = R
            T[:3, 3] = -R @ C
            Ts.append(T)
            continue
        else:
            raise ValueError(kind)
        Ts.append(_se3.se3_exp(torch.from_numpy(xi)).numpy())
    return np.stack(Ts)


def render_rgbd(scene: Scene, T_cw: np.ndarray, bg: float = 24.0):
    """(grayscale (H,W) f32, depth (H,W) f32 with 0 = invalid)."""
    img, z = render(scene, T_cw, bg, return_depth=True)
    depth = np.where(np.isfinite(z), z, 0.0).astype(np.float32)
    return img, depth


def render(scene: Scene, T_cw: np.ndarray, bg: float = 24.0,
           return_depth: bool = False):
    """Render one grayscale frame (H, W) float32 by inverse-warping each
    plane's texture through its plane-induced projective map, z-buffered,
    then drawing the 3D segments on top."""
    h, w = scene.height, scene.width
    K = scene.K
    R, t = T_cw[:3, :3], T_cw[:3, 3]
    img = np.full((h, w), bg, np.float32)
    zbuf = np.full((h, w), np.inf, np.float32)

    ys, xs = np.mgrid[0:h, 0:w]
    pix = np.stack([xs, ys, np.ones_like(xs)], -1).astype(np.float64)

    for p in scene.planes:
        # texture (u,v,1) -> camera coords: M = [R e1 s, R e2 s, R o + t]
        M = np.stack([R @ p.e1 * p.scale, R @ p.e2 * p.scale,
                      R @ p.origin + t], -1)
        Pi = np.linalg.inv(K @ M)      # image pixel -> texture homogeneous
        q = pix @ Pi.T
        wq = q[..., 2]
        valid = np.abs(wq) > 1e-12
        u = np.where(valid, q[..., 0] / np.where(valid, wq, 1), -1)
        v = np.where(valid, q[..., 1] / np.where(valid, wq, 1), -1)
        th, tw = p.tex.shape
        inside = valid & (u >= 0) & (u < tw - 1) & (v >= 0) & (v < th - 1)
        z = (np.stack([u, v, np.ones_like(u)], -1) @ M.T)[..., 2]
        front = inside & (z > 0.2) & (z < zbuf)
        # bilinear sample
        ui = np.clip(u.astype(np.int64), 0, tw - 2)
        vi = np.clip(v.astype(np.int64), 0, th - 2)
        fu = (u - ui).astype(np.float32)
        fv = (v - vi).astype(np.float32)
        s00 = p.tex[vi, ui]
        s01 = p.tex[vi, ui + 1]
        s10 = p.tex[vi + 1, ui]
        s11 = p.tex[vi + 1, ui + 1]
        val = (s00 * (1 - fu) * (1 - fv) + s01 * fu * (1 - fv)
               + s10 * (1 - fu) * fv + s11 * fu * fv)
        img = np.where(front, val, img)
        zbuf = np.where(front, z, zbuf)

    for seg in scene.lines:
        a_c = R @ seg[:3] + t
        b_c = R @ seg[3:] + t
        if a_c[2] < 0.25 or b_c[2] < 0.25:
            continue
        ua = (K @ (a_c / a_c[2]))[:2]
        ub = (K @ (b_c / b_c[2]))[:2]
        n = int(max(abs(ub - ua).max(), 1)) + 1
        zs = np.linspace(a_c[2], b_c[2], n)
        for (u, v), zz in zip(np.linspace(ua, ub, n), zs):
            ui, vi = int(round(u)), int(round(v))
            if 1 <= ui < w - 1 and 1 <= vi < h - 1:
                img[vi, ui - 1:ui + 2] = (240.0, 240.0, 240.0)
                zbuf[vi, ui] = min(zbuf[vi, ui], zz)
    out = np.clip(img, 0, 255).astype(np.float32)
    if return_depth:
        return out, zbuf
    return out


def ate_rmse(T_est: np.ndarray, T_gt: np.ndarray, align_scale: bool = True):
    """Absolute trajectory error after Horn (Sim3 with `align_scale`, else
    SE3) alignment of the camera centers, TUM protocol. T_est / T_gt:
    (N, 4, 4) world->camera. Returns the RMSE over the camera centers."""
    c_est = np.stack([-T[:3, :3].T @ T[:3, 3] for T in T_est])
    c_gt = np.stack([-T[:3, :3].T @ T[:3, 3] for T in T_gt])
    mu_e, mu_g = c_est.mean(0), c_gt.mean(0)
    E, G = c_est - mu_e, c_gt - mu_g
    U, D, Vt = np.linalg.svd(G.T @ E)
    S = np.eye(3)
    if np.linalg.det(U) * np.linalg.det(Vt) < 0:
        S[2, 2] = -1
    Rot = U @ S @ Vt
    s = (D * np.diag(S)).sum() / max((E * E).sum(), 1e-12) \
        if align_scale else 1.0
    c_al = (s * (Rot @ c_est.T)).T + mu_g - s * Rot @ mu_e
    return float(np.sqrt((np.linalg.norm(c_al - c_gt, axis=-1) ** 2).mean()))

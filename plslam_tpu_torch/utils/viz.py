"""Offline visualization — the Viewer/FrameDrawer/MapDrawer equivalents
(`src/Viewer.cc`, `src/FrameDrawer.cc`, `src/MapDrawer.cc`) without a GL
window: render annotated frames and map/trajectory overviews to image
arrays (save with cv2.imwrite or feed to any sink). Headless-first.

Port of `plslam_tpu/utils/viz.py` on the port's feature tuples and
`MapState`: tensors on any device are read to the host first; cv2 is
imported when a function draws."""
from __future__ import annotations

import numpy as np
import torch


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def draw_frame(img, feats=None, lfeats=None, matched=None, ln_matched=None):
    """FrameDrawer::DrawFrame equivalent: keypoints (green = map-matched,
    blue = unmatched) and line segments (red) on a gray frame. Returns
    (H, W, 3) uint8."""
    import cv2
    vis = cv2.cvtColor(_np(img).astype(np.uint8), cv2.COLOR_GRAY2BGR)
    if feats is not None:
        uv = _np(feats.uv)
        valid = _np(feats.valid)
        m = _np(matched) if matched is not None else np.zeros(len(uv), bool)
        for i in np.nonzero(valid)[0]:
            color = (0, 255, 0) if (i < len(m) and m[i]) else (255, 128, 0)
            cv2.circle(vis, tuple(np.round(uv[i]).astype(int)), 2, color, -1)
    if lfeats is not None:
        ua = _np(lfeats.uv_a)
        ub = _np(lfeats.uv_b)
        lv = _np(lfeats.valid)
        lm = _np(ln_matched) if ln_matched is not None else np.zeros(len(ua), bool)
        for i in np.nonzero(lv)[0]:
            color = (0, 0, 255) if (i < len(lm) and lm[i]) else (0, 160, 255)
            cv2.line(vis, tuple(np.round(ua[i]).astype(int)),
                     tuple(np.round(ub[i]).astype(int)), color, 1)
    return vis


def draw_map_topdown(ms, trajectory=None, size=800, margin=0.1):
    """MapDrawer equivalent: top-down (x-z) view of map points (black), map
    lines (red), keyframes (blue frustum dots) and the trajectory (green).
    Returns (size, size, 3) uint8."""
    import cv2
    vis = np.full((size, size, 3), 255, np.uint8)
    pts = _np(ms.pt_xyz)[_np(ms.pt_valid)]
    n_kf = int(_np(ms.n_kf))
    kf_c = np.stack([-_np(ms.kf_T[k])[:3, :3].T @ _np(ms.kf_T[k])[:3, 3]
                     for k in range(max(n_kf, 1))]) if n_kf else np.zeros((0, 3))
    all_xy = [pts[:, [0, 2]]] if len(pts) else []
    if len(kf_c):
        all_xy.append(kf_c[:, [0, 2]])
    if trajectory:
        tc = np.stack([-_np(T)[:3, :3].T @ _np(T)[:3, 3]
                       for _, T in trajectory])
        all_xy.append(tc[:, [0, 2]])
    if not all_xy:
        return vis
    xy = np.concatenate(all_xy)
    lo = xy.min(0) - margin
    hi = xy.max(0) + margin
    span = np.maximum(hi - lo, 1e-6)

    def to_px(p):
        q = (p - lo) / span
        return np.stack([q[..., 0] * (size - 1),
                         (1 - q[..., 1]) * (size - 1)], -1).astype(int)

    for p in to_px(pts[:, [0, 2]]) if len(pts) else []:
        cv2.circle(vis, tuple(p), 1, (60, 60, 60), -1)
    lns = _np(ms.ln_xyz)[_np(ms.ln_valid)]
    for seg in lns:
        a = to_px(seg[0][[0, 2]])
        b = to_px(seg[1][[0, 2]])
        cv2.line(vis, tuple(a), tuple(b), (0, 0, 200), 1)
    if trajectory:
        px = to_px(tc[:, [0, 2]])
        for a, b in zip(px[:-1], px[1:]):
            cv2.line(vis, tuple(a), tuple(b), (0, 160, 0), 2)
    for p in to_px(kf_c[:, [0, 2]]) if len(kf_c) else []:
        cv2.circle(vis, tuple(p), 4, (200, 0, 0), 1)
    return vis

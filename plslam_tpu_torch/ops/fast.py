"""Dense dual-threshold FAST-9/16 corner scores with 3x3 NMS.

Port of `plslam_tpu/ops/fast.py`. The ring pixels come from `torch.roll`,
which wraps around the image edge like the JAX version's `jnp.roll`; the wrap
only touches pixels within 3 of the border, which the border mask (margin >=
3) removes. `nms3` keeps ``score >= max`` of the 3x3 window, so equal
neighbours both survive, as in the JAX version.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

# Bresenham circle of radius 3, 16 points, starting at (row-3, col) going
# clockwise — the standard FAST-9/16 ring.
RING_OFFSETS = np.array(
    [
        (-3, 0), (-3, 1), (-2, 2), (-1, 3), (0, 3), (1, 3), (2, 2), (3, 1),
        (3, 0), (3, -1), (2, -2), (1, -3), (0, -3), (-1, -3), (-2, -2), (-3, -1),
    ],
    dtype=np.int32,
)
ARC_LEN = 9  # FAST-9: need >= 9 contiguous ring pixels brighter/darker


def _arc_ok(mask):
    """(16, H, W) bool ring mask -> (H, W): a cyclic run of >= 9 set ring
    pixels, by pointer doubling over the ring axis (runs 2 -> 4 -> 8 -> 9)."""
    r2 = mask & mask.roll(-1, 0)
    r4 = r2 & r2.roll(-2, 0)
    r8 = r4 & r4.roll(-4, 0)
    return (r8 & mask.roll(-8, 0)).any(0)


def _ring_diff(img):
    """(16, H, W): ring pixel minus centre, ring[i][y, x] = img[y+dy, x+dx]."""
    ring = torch.stack([img.roll((-int(dy), -int(dx)), (0, 1))
                        for dy, dx in RING_OFFSETS])
    return ring - img[None]


def _score(diff, threshold: float):
    """The corner score of a ring difference stack (`fast_score_map`)."""
    bright = diff > threshold
    dark = diff < -threshold
    sb = torch.where(bright, diff - threshold, 0.0).sum(0)
    sd = torch.where(dark, -diff - threshold, 0.0).sum(0)
    return torch.maximum(torch.where(_arc_ok(bright), sb, 0.0),
                         torch.where(_arc_ok(dark), sd, 0.0))


def fast_score_map(img, threshold: float):
    """Dense FAST-9/16 corner score, (H, W) float32 -> (H, W) float32: the
    sum over ring pixels of |I_ring - I_c| - t for the dominant polarity,
    zero where the contiguous-arc test fails."""
    return _score(_ring_diff(img), threshold)


def nms3(score):
    """3x3 non-maximum suppression (keeps score >= window max)."""
    m = F.max_pool2d(score[None, None], 3, stride=1, padding=1)[0, 0]
    return torch.where(score >= m, score, 0.0)


def border_mask(h: int, w: int, margin: int, device=None):
    """(h, w) bool mask, False within `margin` of the border."""
    ys = torch.arange(h, device=device)[:, None]
    xs = torch.arange(w, device=device)[None, :]
    return (ys >= margin) & (ys < h - margin) & (xs >= margin) & (xs < w - margin)


def fast_dual_threshold(img, th_high: float, th_low: float, margin: int,
                        high_bonus: float = 1e6, return_raw: bool = False):
    """NMS'd corner score preferring high-threshold corners: the low
    threshold's score, plus `high_bonus` where the high threshold's arc test
    also passes (the data-parallel form of the 20 -> 7 per-cell fallback).
    With `return_raw`, also the pre-NMS low-threshold score map (sub-pixel
    refinement needs the neighbours NMS zeroes)."""
    diff = _ring_diff(img)
    s_low = _score(diff, th_low)
    hi = _arc_ok(diff > th_high) | _arc_ok(diff < -th_high)
    score = torch.where(hi & (s_low > 0.0), s_low + high_bonus, s_low)
    score = nms3(score)
    h, w = img.shape
    out = torch.where(border_mask(h, w, margin, img.device), score, 0.0)
    if return_raw:
        return out, s_low
    return out

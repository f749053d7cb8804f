"""Keypoint depth lookup (the RGB-D path of `plslam_tpu/ops/stereo.py`)."""
from __future__ import annotations

import torch


def depth_at(depth_img, uv):
    """Nearest-pixel depth for keypoints (`Frame::ComputeStereoFromRGBD`):
    depth_img (H, W), uv (N, 2) -> (N,). Rounds half to even, like
    `jnp.round`, and clamps to the image."""
    h, w = depth_img.shape
    u = torch.round(uv[:, 0]).long().clamp(0, w - 1)
    v = torch.round(uv[:, 1]).long().clamp(0, h - 1)
    return depth_img[v, u]

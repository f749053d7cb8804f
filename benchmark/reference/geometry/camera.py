"""Pinhole camera with radial-tangential distortion on float32 tensors.

Frozen copy of the port's `geometry/camera.py`: analytic keypoint undistortion by a
fixed 10-step fixed-point iteration (the `cv::undistortPoints` contract),
pinhole projection and unprojection. The intrinsics are Python floats rounded to float32, so a
`Camera` works on any device and matches the JAX package's float32 scalars.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class Camera(NamedTuple):
    """Intrinsics + distortion (float32 values held as Python floats)."""

    fx: float
    fy: float
    cx: float
    cy: float
    k1: float
    k2: float
    p1: float
    p2: float
    k3: float
    width: int
    height: int

    @staticmethod
    def create(fx, fy, cx, cy, k1=0.0, k2=0.0, p1=0.0, p2=0.0, k3=0.0,
               width=640, height=480) -> "Camera":
        f = lambda v: float(np.float32(v))
        return Camera(f(fx), f(fy), f(cx), f(cy), f(k1), f(k2), f(p1), f(p2),
                      f(k3), int(width), int(height))


def intrinsics(cam: Camera, device=None):
    """(3,3) float32 intrinsic matrix K on `device`, built by fill kernels
    (no host-to-device copy, so no wait for the device)."""
    f = lambda v: torch.full((), v, dtype=torch.float32, device=device)
    z = f(0.0)
    return torch.stack([torch.stack([f(cam.fx), z, f(cam.cx)]),
                        torch.stack([z, f(cam.fy), f(cam.cy)]),
                        torch.stack([z, z, f(1.0)])])


def distort_normalized(cam: Camera, xn):
    """Apply radtan distortion to normalized coords (...,2) -> (...,2)."""
    x, y = xn[..., 0], xn[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (cam.k1 + r2 * (cam.k2 + r2 * cam.k3))
    xd = x * radial + 2.0 * cam.p1 * x * y + cam.p2 * (r2 + 2.0 * x * x)
    yd = y * radial + cam.p1 * (r2 + 2.0 * y * y) + 2.0 * cam.p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort_normalized(cam: Camera, xd, iters: int = 10):
    """Invert radtan distortion by fixed-point iteration."""
    x = xd
    for _ in range(iters):
        x = xd - (distort_normalized(cam, x) - x)
    return x


def undistort_pixels(cam: Camera, uv):
    """Distorted pixels -> undistorted pixels (the `mvKeys -> mvKeysUn`
    map)."""
    xn = torch.stack([(uv[..., 0] - cam.cx) / cam.fx,
                      (uv[..., 1] - cam.cy) / cam.fy], dim=-1)
    xu = undistort_normalized(cam, xn)
    return torch.stack([cam.fx * xu[..., 0] + cam.cx,
                        cam.fy * xu[..., 1] + cam.cy], dim=-1)



"""Image pyramid and Gaussian blur.

Port of `plslam_tpu/ops/pyramid.py`. The JAX pyramid resizes with
`jax.image.resize(method="linear")`, which antialiases when it downscales: a
triangle kernel widened by the scale factor, normalized per output sample.
`F.interpolate` does not compute that, so the port builds the same per-axis
weight matrices in numpy (`resize_weights`, following
`jax._src.image.scale.compute_weight_mat`) and applies them as two float32
matrix products, ``Wy^T @ img @ Wx``. Levels >= 1 agree with JAX to float
rounding, not bit for bit (the products sum in another order); level 0 is the
input image itself.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def level_shapes(height: int, width: int, n_levels: int, scale: float):
    """Static (H, W) per level, matching cv::resize rounding."""
    shapes = []
    for l in range(n_levels):
        inv = 1.0 / (scale ** l)
        shapes.append((int(round(height * inv)), int(round(width * inv))))
    return shapes


def gaussian_kernel1d(ksize: int, sigma: float) -> np.ndarray:
    r = ksize // 2
    x = np.arange(-r, r + 1, dtype=np.float64)
    k = np.exp(-(x * x) / (2.0 * sigma * sigma))
    return (k / k.sum()).astype(np.float32)


def resize_weights(in_size: int, out_size: int) -> np.ndarray:
    """(in_size, out_size) float32 weights of JAX's antialiased linear
    resize along one axis (scale = out/in, no translation), as XLA compiles
    `compute_weight_mat` for the CPU: the division by the constant kernel
    scale becomes a product with its float32 reciprocal, and the two
    multiply-adds are fused (emulated here in float64, then rounded once).
    Written with plain float32 operations instead, the weights move by up to
    ~3e-6 and level images by up to ~6e-4 grey levels."""
    f32, f64 = np.float32, np.float64
    inv_scale = f32(1.0 / (out_size / in_size))
    kernel_scale = max(inv_scale, f32(1.0))
    sample_f = ((np.arange(out_size, dtype=f32) + f32(0.5)).astype(f64)
                * f64(inv_scale) - 0.5).astype(f32)
    x = np.abs(sample_f[None, :] - np.arange(in_size, dtype=f32)[:, None])
    w = np.maximum(f32(0.0), (1.0 - x.astype(f64)
                              * f64(f32(1.0) / kernel_scale)).astype(f32))
    total = np.sum(w, axis=0, keepdims=True, dtype=f32)
    w = np.where(np.abs(total) > 1000.0 * float(np.finfo(np.float32).eps),
                 w / np.where(total != 0, total, f32(1.0)), f32(0.0))
    inside = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(inside[None, :], w, f32(0.0)).astype(f32)


def pyramid_weights(height: int, width: int, n_levels: int, scale: float):
    """[(Wy, Wx)] per level >= 1, each resizing level l-1 to level l."""
    shapes = level_shapes(height, width, n_levels, scale)
    return [(resize_weights(shapes[l - 1][0], shapes[l][0]),
             resize_weights(shapes[l - 1][1], shapes[l][1]))
            for l in range(1, n_levels)]


def blur(img, taps):
    """Separable Gaussian blur, replicate-padded. img: (H, W) float32;
    taps: (ksize,) float32. Sums the shifted rows in tap order, as the JAX
    version does."""
    r = taps.shape[0] // 2
    h, w = img.shape
    x = F.pad(img[None, None], (0, 0, r, r), mode="replicate")[0, 0]
    acc = taps[0] * x[0:h, :]
    for i in range(1, taps.shape[0]):
        acc = acc + taps[i] * x[i:i + h, :]
    x = F.pad(acc[None, None], (r, r, 0, 0), mode="replicate")[0, 0]
    acc = taps[0] * x[:, 0:w]
    for i in range(1, taps.shape[0]):
        acc = acc + taps[i] * x[:, i:i + w]
    return acc


def resize_bilinear(img, wy, wx):
    """Antialiased linear resize by the weight matrices of
    `resize_weights`: (H, W) -> (h, w) with wy (H, h), wx (W, w)."""
    return wy.T @ img @ wx


def build_pyramid(img, weights):
    """img: (H, W) float32 -> list of per-level float32 images, each level
    resized from the previous one (`weights` from `pyramid_weights`, as
    tensors on img's device)."""
    levels = [img]
    for wy, wx in weights:
        levels.append(resize_bilinear(levels[-1], wy, wx))
    return levels

"""Oriented binary descriptors: IC-angle orientation + steered binary tests.

Port of `plslam_tpu/ops/orb.py`, by meaning rather than by TPU layout. The
JAX version fetches 8-aligned 40x40 tile blocks and selects the 31x31 window
with bf16 one-hot contractions; here each keypoint's 31x31 window is gathered
directly from the zero-padded image, at the same window origin the JAX tile
arithmetic arrives at (`_window_origin`, including its clamping near the
padded edge).

- IC angle: ``atan2(m01, m10)`` over the radius-15 disc.
- Descriptor: the angle is quantized to 30 bins of 12 degrees; bin b uses
  the test pattern rotated by b * 12 degrees and rounded in numpy float64
  (`binned_offsets`, the rounding of `_binned_test_matrix`); bit i =
  ``round(blur)[B_i] - round(blur)[A_i] > 0``.
"""
from __future__ import annotations

import math
import os

import numpy as np
import torch
import torch.nn.functional as F

HALF_PATCH = 15          # IC-angle circular patch radius
DESC_BITS = 256
PATTERN_CLIP = 13        # pattern coords in [-13, 13]
N_ANGLE_BINS = 30        # 12 deg bins (rBRIEF quantization)
TILE = 8
PATCH40 = 40

# the JAX package's `learned_pattern.npy`, copied byte for byte
LEARNED_PATTERN_PATH = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "learned_pattern.npy")


def make_gauss_pattern(seed: int = 20260816) -> np.ndarray:
    """(256, 4) int32 [ax, ay, bx, by] seeded Gaussian test pattern (the JAX
    package's "gauss" pattern)."""
    rng = np.random.default_rng(seed)
    sigma = 31.0 / 5.0
    pts = np.clip(np.round(rng.normal(0.0, sigma, size=(DESC_BITS, 4))),
                  -PATTERN_CLIP, PATTERN_CLIP).astype(np.int32)
    return pts


def load_pattern(name: str) -> np.ndarray:
    """(256, 4) int32 test pattern: "gauss", or "learned" read from this
    package's `ops/learned_pattern.npy` (raises if that file is missing)."""
    if name == "gauss":
        return make_gauss_pattern()
    if name == "learned":
        if not os.path.exists(LEARNED_PATTERN_PATH):
            raise FileNotFoundError(
                f"learned descriptor pattern not found: {LEARNED_PATTERN_PATH}")
        return np.load(LEARNED_PATTERN_PATH).astype(np.int32)
    raise ValueError(f"unknown descriptor pattern {name!r}")


def binned_offsets(pattern: np.ndarray) -> np.ndarray:
    """(30, 256, 2, 2) int64 [bin, pair, (A, B), (dy, dx)]: the pattern
    rotated by each bin's angle, rounded and clipped to the 31x31 window."""
    out = np.zeros((N_ANGLE_BINS, DESC_BITS, 2, 2), np.int64)
    for b in range(N_ANGLE_BINS):
        th = 2.0 * np.pi * b / N_ANGLE_BINS
        c, s = np.cos(th), np.sin(th)
        for j, which in enumerate((0, 2)):                 # A, B
            px = pattern[:, which].astype(np.float64)
            py = pattern[:, which + 1].astype(np.float64)
            out[b, :, j, 1] = np.clip(np.round(px * c - py * s),
                                      -HALF_PATCH, HALF_PATCH)
            out[b, :, j, 0] = np.clip(np.round(px * s + py * c),
                                      -HALF_PATCH, HALF_PATCH)
    return out


def _pad_to_tiles(img):
    """Zero-pad (H, W) to multiples of TILE."""
    h, w = img.shape
    return F.pad(img, (0, -(-w // TILE) * TILE - w, 0, -(-h // TILE) * TILE - h))


def _window_origin(uv, hp: int, wp: int):
    """Top-left (y0, x0) of each keypoint's 31x31 window in the padded image:
    the JAX tile arithmetic (8-aligned 40x40 block, clamped to the image,
    window offset clamped to [0, 9]). For keypoints inside the detection
    margin this is (y - 15, x - 15)."""
    x = uv[:, 0].to(torch.int32)
    y = uv[:, 1].to(torch.int32)
    yq = torch.clamp((y - HALF_PATCH) & ~(TILE - 1), 0, hp - PATCH40)
    xq = torch.clamp((x - HALF_PATCH) & ~(TILE - 1), 0, wp - PATCH40)
    oy = torch.clamp(y - HALF_PATCH - yq, 0, PATCH40 - 31)
    ox = torch.clamp(x - HALF_PATCH - xq, 0, PATCH40 - 31)
    return (yq + oy).long(), (xq + ox).long()


def _windows(img, uv):
    """(K, 31, 31) windows of the zero-padded image around keypoints."""
    p = _pad_to_tiles(img)
    hp, wp = p.shape
    y0, x0 = _window_origin(uv, hp, wp)
    r = torch.arange(31, device=img.device)
    flat = ((y0[:, None, None] + r[None, :, None]) * wp
            + x0[:, None, None] + r[None, None, :])
    return p.reshape(-1)[flat]


def ic_angle(img, uv):
    """Intensity-centroid orientation for keypoints. Returns (K,) radians."""
    win = _windows(img, uv)
    d = torch.arange(-HALF_PATCH, HALF_PATCH + 1, device=img.device,
                     dtype=img.dtype)
    disc = (d[:, None] ** 2 + d[None, :] ** 2 <= HALF_PATCH ** 2).to(img.dtype)
    wd = win * disc
    m10 = torch.sum(wd * d[None, None, :], dim=(1, 2))
    m01 = torch.sum(wd * d[None, :, None], dim=(1, 2))
    return torch.atan2(m01, m10)


def angle_bins(angle):
    """(K,) radians -> (K,) int64 bin in [0, 30): nearest multiple of 12
    degrees of the angle taken modulo 2 pi."""
    step = 2.0 * math.pi / N_ANGLE_BINS     # both constants round to float32
    b = torch.floor(torch.remainder(angle, 2.0 * math.pi) / step + 0.5)
    return b.to(torch.int64) % N_ANGLE_BINS


def steered_descriptor(img_blur, uv, angle, offsets):
    """256-bit steered binary descriptor. Returns (K, 256) uint8 bits.

    offsets: (30, 256, 2, 2) int64 tensor from `binned_offsets`."""
    p = torch.round(_pad_to_tiles(img_blur))
    hp, wp = p.shape
    y0, x0 = _window_origin(uv, hp, wp)
    off = offsets[angle_bins(angle)]                      # (K, 256, 2, 2)
    yy = y0[:, None, None] + HALF_PATCH + off[..., 0]
    xx = x0[:, None, None] + HALF_PATCH + off[..., 1]
    v = p.reshape(-1)[yy * wp + xx]                       # (K, 256, 2)
    return (v[..., 1] - v[..., 0] > 0).to(torch.uint8)


def pack_bits(bits):
    """(..., 256) {0,1} -> (..., 32) uint8 packed descriptor (bit j of byte
    i is bit 8 i + j)."""
    b = bits.reshape(bits.shape[:-1] + (32, 8)).to(torch.int32)
    weights = 1 << torch.arange(8, dtype=torch.int32, device=bits.device)
    return (b * weights).sum(-1).to(torch.uint8)


def unpack_bits(packed):
    """(..., 32) uint8 -> (..., 256) {0,1} uint8."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., None] >> shifts) & 1
    return bits.reshape(packed.shape[:-1] + (256,)).to(torch.uint8)

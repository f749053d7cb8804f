"""Multi-scale point feature extraction as an `nn.Module`.

Frozen copy of the port's `ops/extract.py`: pyramid -> dense dual-threshold FAST ->
NMS -> grid top-k per level -> IC angle -> blur -> steered 256-bit
descriptor, all with static shapes. `PointExtractor` holds what depends only
on the configuration and the image size as buffers: the per-level resize
weight matrices, the Gaussian taps and the rotated test pattern.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from . import fast, orb, pyramid, select


class PointFeatures(NamedTuple):
    """Fixed-capacity per-frame point features."""

    uv: torch.Tensor        # (N, 2) float32 level-0 (distorted-image) coords
    uv_un: torch.Tensor     # (N, 2) float32 undistorted pixel coords
    response: torch.Tensor  # (N,) float32
    octave: torch.Tensor    # (N,) int32
    angle: torch.Tensor     # (N,) float32 radians
    desc: torch.Tensor      # (N, 256) uint8 bits
    valid: torch.Tensor     # (N,) bool


class ExtractorConfig(NamedTuple):
    n_features: int = 1024
    n_levels: int = 8
    scale: float = 1.2
    th_fast_high: float = 20.0
    th_fast_low: float = 7.0
    margin: int = 20          # reference EDGE_THRESHOLD=19 (+1 for rotation)
    cell: int = 32            # selection grid cell in pixels
    subpixel: bool = False    # quadratic peak refinement of keypoint
                              # locations on the pre-NMS score map
                              # (descriptors still sample the integer
                              # location); off, as in the JAX package,
                              # which measured it worse (refine_subpixel)
    level_map: int = 1        # level -> base coords: 0 = uv * scale**l,
                              # 1 = uv * (dim0/dim_l) per axis,
                              # 2 = (uv + 0.5) * (dim0/dim_l) - 0.5
    sel_order: str = "uniform"   # "uniform" | "response" (ops/select.py)
    desc_pattern: str = "learned"  # "gauss" | "learned" (ops/orb.py)
    sel_cap: int = 8          # max keypoints drawn from one selection cell


def level_budgets(cfg: ExtractorConfig):
    """Per-level feature counts, geometric in 1/scale."""
    inv = 1.0 / cfg.scale
    raw = np.array([inv ** l for l in range(cfg.n_levels)])
    raw = raw / raw.sum() * cfg.n_features
    budgets = np.floor(raw).astype(int)
    budgets[0] += cfg.n_features - budgets.sum()
    return [int(b) for b in budgets]


def scale_factors(cfg: ExtractorConfig, device=None):
    """(n_levels,) scale factor per octave (scale^l) and sigma2 = scale^2l,
    as float32 tensors."""
    s = np.array([cfg.scale ** l for l in range(cfg.n_levels)], np.float32)
    return (torch.as_tensor(s, device=device),
            torch.as_tensor(s * s, device=device))


class PointExtractor(nn.Module):
    """ORB-style point extractor for (height, width) images.

    ``forward(img)`` takes (H, W) float32 grayscale in [0, 255] and returns
    `PointFeatures` with ``cfg.n_features`` slots (``uv_un`` = ``uv`` until
    the caller undistorts). It runs on the device of its buffers."""

    def __init__(self, cfg: ExtractorConfig, height: int, width: int):
        super().__init__()
        if cfg.level_map not in (0, 1, 2):
            raise ValueError(f"level_map must be 0, 1 or 2, got {cfg.level_map}")
        self.cfg = cfg
        self.shapes = pyramid.level_shapes(height, width, cfg.n_levels,
                                           cfg.scale)
        self.budgets = level_budgets(cfg)
        for l, (wy, wx) in enumerate(pyramid.pyramid_weights(
                height, width, cfg.n_levels, cfg.scale), start=1):
            self.register_buffer(f"resize_wy{l}", torch.from_numpy(wy))
            self.register_buffer(f"resize_wx{l}", torch.from_numpy(wx))
        (h0, w0), f32 = self.shapes[0], np.float32
        self.register_buffer("level_scale", torch.from_numpy(np.array(
            [[w0 / w, h0 / h] for h, w in self.shapes], f32)))
        self.register_buffer("blur_taps",
                             torch.from_numpy(pyramid.gaussian_kernel1d(7, 2.0)))
        self.register_buffer("pattern_offsets", torch.from_numpy(
            orb.binned_offsets(orb.load_pattern(cfg.desc_pattern))))

    def _resize_weights(self):
        return [(getattr(self, f"resize_wy{l}"), getattr(self, f"resize_wx{l}"))
                for l in range(1, self.cfg.n_levels)]

    def forward(self, img) -> PointFeatures:
        cfg = self.cfg
        if tuple(img.shape) != self.shapes[0]:
            raise ValueError(f"image shape {tuple(img.shape)}, extractor "
                             f"built for {self.shapes[0]}")
        levels = pyramid.build_pyramid(img, self._resize_weights())
        uv_all, resp_all, oct_all, ang_all, desc_all, valid_all = (
            [], [], [], [], [], [])
        for l, (im_l, n_l) in enumerate(zip(levels, self.budgets)):
            if n_l == 0:
                continue
            score = fast.fast_dual_threshold(im_l, cfg.th_fast_high,
                                             cfg.th_fast_low, cfg.margin,
                                             return_raw=cfg.subpixel)
            if cfg.subpixel:
                score, raw = score
            uv, resp, valid = select.select_grid_topk(
                score, n_l, cell=cfg.cell, k_per_cell=cfg.sel_cap,
                order=cfg.sel_order)
            ang = orb.ic_angle(im_l, uv)
            bits = orb.steered_descriptor(pyramid.blur(im_l, self.blur_taps),
                                          uv, ang, self.pattern_offsets)
            if cfg.subpixel:
                # geometry gets the refined location; the angle and the
                # descriptor above sampled the integer one
                uv = refine_subpixel(raw, uv)
            if cfg.level_map == 0:
                uv0 = uv * (cfg.scale ** l)
            else:
                sxy = self.level_scale[l]          # (w0 / w_l, h0 / h_l)
                uv0 = uv * sxy if cfg.level_map == 1 else (uv + 0.5) * sxy - 0.5
            uv_all.append(uv0)
            resp_all.append(resp)
            oct_all.append(torch.full((n_l,), l, dtype=torch.int32,
                                      device=img.device))
            ang_all.append(ang)
            desc_all.append(bits)
            valid_all.append(valid)
        uv = torch.cat(uv_all)
        return PointFeatures(uv=uv, uv_un=uv, response=torch.cat(resp_all),
                             octave=torch.cat(oct_all),
                             angle=torch.cat(ang_all),
                             desc=torch.cat(desc_all),
                             valid=torch.cat(valid_all))


def refine_subpixel(score, uv):
    """Quadratic sub-pixel refinement of integer keypoints (N, 2) on an
    (H, W) score map: per axis the offset -d1 / d2 of the parabola through
    the keypoint and its two neighbours, clipped to +-0.5 and applied only
    where the parabola is concave. Off by default: the JAX package measured
    it worse (the FAST ring score is not a quadratic around the corner)."""
    h, w = score.shape
    x = uv[:, 0].to(torch.int32).clamp(1, w - 2).long()
    y = uv[:, 1].to(torch.int32).clamp(1, h - 2).long()

    def at(dy, dx):
        return score[y + dy, x + dx]

    s0 = at(0, 0)
    dxs = 0.5 * (at(0, 1) - at(0, -1))
    dys = 0.5 * (at(1, 0) - at(-1, 0))
    dxx = at(0, 1) - 2 * s0 + at(0, -1)
    dyy = at(1, 0) - 2 * s0 + at(-1, 0)
    ox = (-dxs / torch.where(dxx.abs() < 1e-6, 1e-6, dxx)).clamp(-0.5, 0.5)
    oy = (-dys / torch.where(dyy.abs() < 1e-6, 1e-6, dyy)).clamp(-0.5, 0.5)
    ox = torch.where(dxx < 0, ox, 0.0)
    oy = torch.where(dyy < 0, oy, 0.0)
    return uv + torch.stack([ox, oy], -1)



"""Stereo keypoint depth: rectified left-right matching, and the keypoint
depth lookup of the RGB-D path.

Port of `plslam_tpu/ops/stereo.py`. The row constraint of
`Frame::ComputeStereoMatches` is a mask on the full left x right Hamming
matrix (`hamming.distance_matrix` + `masked_best2`), followed by a batched
SAD refinement on gathered 11 x 11 patches: an integer-grid parabola, then a
half-pixel pass on horizontally bilinear right patches. The row band and the
disparity range are not K1's gate set, so the search stays plain PyTorch, as
the JAX package keeps it in XLA. Nothing here waits for the device.
"""
from __future__ import annotations

import torch

from . import hamming

TH_HIGH = 100


def stereo_match(feats_l, feats_r, img_l, img_r, fx: float, baseline: float,
                 scale_factors, row_tol: float = 2.0, max_disp: float = 128.0,
                 sad_half: int = 5, refine_range: int = 5):
    """(depth (N,), u_right (N,), ok (N,)) for the left keypoints.

    Gates: the same row within `row_tol` x the left octave's scale,
    disparity in (0.1, max_disp], both keypoints valid, Hamming <= TH_HIGH;
    then u_r is refined by SAD over +-refine_range columns on the integer
    pixel grid (parabola) and by a half-pixel bilinear second pass, the
    disparity gate is applied again, and only octaves <= 1 are kept.
    Rounding follows the JAX package: half to even, truncating casts, patch
    origins clipped into the image, and the first index among equal
    minima."""
    D = hamming.distance_matrix(feats_l.desc, feats_r.desc)
    dv = (feats_l.uv[:, 1:2] - feats_r.uv[None, :, 1]).abs()
    tol = row_tol * scale_factors[feats_l.octave.long()][:, None]
    disp = feats_l.uv[:, 0:1] - feats_r.uv[None, :, 0]
    mask = ((dv <= tol) & (disp > 0.1) & (disp <= max_disp)
            & feats_l.valid[:, None] & feats_r.valid[None, :])
    idx, best, _ = hamming.masked_best2(D, mask)
    ok = best <= TH_HIGH

    # SAD refinement around the matched right column, on the integer grid:
    # both coordinates rounded, the refined column relative to that grid
    ul_i = torch.round(feats_l.uv[:, 0])
    patch_l = _gather_patches(img_l, torch.stack(
        [ul_i, torch.round(feats_l.uv[:, 1])], -1), sad_half)       # (N,w,w)
    ur_i = torch.round(feats_r.uv[idx, 0])
    v_r = torch.round(feats_r.uv[idx, 1])

    def patches_at(u):
        """(N, k, w, w) right patches at the columns u (N, k), row v_r."""
        k = u.shape[1]
        p = _gather_patches(img_r, torch.stack(
            [u.reshape(-1), v_r.repeat_interleave(k)], -1), sad_half)
        return p.view(-1, k, *p.shape[1:])

    def sad(p):
        """(N, k) mean |p - left patch| of right patches p (N, k, w, w)."""
        return (p - patch_l[:, None]).abs().mean(dim=(-1, -2))

    offs = torch.arange(-refine_range, refine_range + 1, dtype=torch.float32,
                        device=ul_i.device)
    sads = sad(patches_at(ur_i[:, None] + offs[None]))              # (N, 2r+1)
    b = torch.argmin(sads, dim=-1)
    bc = b.clamp(1, sads.shape[-1] - 2)[:, None]
    s_m = sads.gather(-1, bc - 1)[:, 0]
    s_0 = sads.gather(-1, bc)[:, 0]
    s_p = sads.gather(-1, bc + 1)[:, 0]
    denom = (s_m - 2 * s_0 + s_p).clamp_min(1e-6)
    frac = (0.5 * (s_m - s_p) / denom).clamp(-1.0, 1.0)
    u_r = ur_i + offs[bc[:, 0]] + frac

    # second pass at a half-pixel step, right patches bilinear in u: the
    # integer parabola leaves ~0.2 px of disparity noise, which z^2/(fx b)
    # amplifies into the far-field depth-error tail
    h = 0.5
    u3 = torch.stack([u_r - h, u_r, u_r + h], -1)                    # (N, 3)
    f = torch.floor(u3)
    w = (u3 - f)[..., None, None]
    s2m, s20, s2p = sad((1.0 - w) * patches_at(f)
                        + w * patches_at(f + 1.0)).unbind(-1)
    den2 = (s2m - 2 * s20 + s2p).clamp_min(1e-6)
    frac2 = (h * 0.5 * (s2m - s2p) / den2).clamp(-h, h)
    u_r = u_r + frac2

    disparity = ul_i - u_r
    ok = ok & (disparity > 0.1) & (disparity <= max_disp)
    # fine octaves only: disparity noise scales with the octave's
    # localization error, and depth error amplifies it by z^2/(fx b)
    ok = ok & (feats_l.octave <= 1)
    depth = fx * baseline / disparity.clamp_min(1e-6)
    return depth, u_r, ok


def _gather_patches(img, uv, r: int):
    """(N, 2r+1, 2r+1) patches of img (H, W) with top-left corners at the
    truncated uv (N, 2) - r, clipped into the image; one gather."""
    h, w = img.shape
    size = 2 * r + 1
    x0 = (uv[:, 0].to(torch.int32) - r).clamp(0, w - size)
    y0 = (uv[:, 1].to(torch.int32) - r).clamp(0, h - size)
    ar = torch.arange(size, dtype=torch.int32, device=img.device)
    flat = ((y0[:, None, None] + ar[None, :, None]) * w
            + x0[:, None, None] + ar[None, None, :])
    return img.reshape(-1)[flat.long()]


def right_columns(feats, kp_depth, bf: float):
    """Each keypoint's right-image column u_un - bf / depth (the stereo
    edges' third observation; bf = fx x baseline), -1 where it has no
    depth."""
    return torch.where(feats.valid & (kp_depth > 0),
                       feats.uv_un[:, 0] - bf / kp_depth.clamp_min(1e-6),
                       -1.0)


def depth_at(depth_img, uv):
    """Nearest-pixel depth for keypoints (`Frame::ComputeStereoFromRGBD`):
    depth_img (H, W), uv (N, 2) -> (N,). Rounds half to even, like
    `jnp.round`, and clamps to the image."""
    h, w = depth_img.shape
    u = torch.round(uv[:, 0]).long().clamp(0, w - 1)
    v = torch.round(uv[:, 1]).long().clamp(0, h - 1)
    return depth_img[v, u]

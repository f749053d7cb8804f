"""Per-frame tracking against the local map.

Port of `plslam_tpu/models/tracking.py` for points (`lfeats=None`; lines and
stereo edges are not ported yet). The step is branch-free and never waits
for the device: every decision is a `torch.where`, every scatter writes
through clamped indices or a dump slot, and the three Hamming searches go
through `ops/gated_match.gated_hamming_best2` (the CUDA kernel on CUDA
tensors), so the N x P distance matrix is never formed on the card.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..mapstate.state import MapState
from ..ops import gated_match, hamming
from ..ops.extract import PointFeatures
from ..optim import pose_opt

TH_HIGH = 100
TH_LOW = 50
_INT32_MAX = 2 ** 31 - 1


class TrackResult(NamedTuple):
    T: torch.Tensor             # (4,4) optimized pose
    matched_pt: torch.Tensor    # (N,) i32 map-point id per keypoint (-1)
    inlier: torch.Tensor        # (N,) bool
    n_inliers: torch.Tensor     # () i32
    n_visible: torch.Tensor     # () i32
    visible_pts: torch.Tensor   # (P,) bool
    matched_ln: torch.Tensor    # (M,) i32 map-line id per line feature (-1)
    ln_inlier: torch.Tensor     # (M,) bool
    n_ln_inliers: torch.Tensor  # () i32
    visible_lns: torch.Tensor   # (L,) bool
    scalars: torch.Tensor       # (6,) i32 [n_inliers, n_ln_inliers,
                                # n_matched, ref_kf_tracked3, n_pt, n_ln]
    velocity: torch.Tensor      # (4,4) damped constant-velocity estimate
    T_rel: torch.Tensor         # (4,4) pose relative to the latest keyframe


def _row(t, k):
    """t[k] for a 0-d integer tensor k, without a host read of k."""
    return t.index_select(0, k.reshape(1).long())[0]


def _bitmap(n: int, idx, on):
    """(n,) bool: True at idx[i] wherever on[i] (idx may be out of range
    where on is False)."""
    hits = torch.zeros(n, dtype=torch.int32, device=idx.device)
    hits.index_add_(0, idx.reshape(-1).clamp(0, n - 1).long(),
                    on.reshape(-1).to(torch.int32))
    return hits > 0


def predict_scale(dist, max_dist, scale: float, n_levels: int):
    """Expected octave from the ratio of the max scale-invariance distance to
    the current distance (`MapPoint::PredictScale`)."""
    ratio = (max_dist / dist.clamp_min(1e-6)).clamp_min(1e-6)
    log_s = torch.full((), scale, device=dist.device).log()  # float32 log
    level = torch.ceil(torch.log(ratio) / log_s)
    return level.clamp(0, n_levels - 1).to(torch.int32)


def local_map_mask(ms: MapState, window: int = 12, anchor_kf=None):
    """(P,) bool: points observed by the `window` keyframes most covisible
    with the anchor keyframe (default: the latest), recency breaking ties;
    everything when the map has no keyframe."""
    K, _ = ms.kf_pt_idx.shape
    P = ms.pt_xyz.shape[0]
    ids = torch.arange(K, device=ms.kf_pt_idx.device)
    latest = (ms.n_kf - 1).clamp_min(0)
    anchor = latest if anchor_kf is None else torch.where(
        anchor_kf >= 0, anchor_kf, latest)
    valid = ms.kf_valid & (ids < ms.n_kf)
    arow = _row(ms.kf_pt_idx, anchor)
    abit = _bitmap(P, arow, arow >= 0)
    shared = abit[ms.kf_pt_idx.clamp(0, P - 1).long()] & (ms.kf_pt_idx >= 0)
    w = shared.sum(dim=1)
    score = torch.where(valid & (w > 0), w * K + ids, 0)
    score = torch.where(ids == anchor, _INT32_MAX, score)
    top_s, top_i = torch.sort(score, descending=True, stable=True)
    top_s, top_i = top_s[:window], top_i[:window]
    sel = _bitmap(K, top_i, top_s > 0)
    rows = torch.where((sel & valid)[:, None], ms.kf_pt_idx, -1)
    return _bitmap(P, rows, rows >= 0) | (ms.n_kf <= 0)


def _match_against_map(cam, ms: MapState, feats: PointFeatures, T,
                       scale_factors, radius_scale, wide: bool,
                       n_levels: int, scale: float, pt_mask=None):
    """Projection-window search of the frame's keypoints against the map at
    pose T. `wide` = motion-model radius (15 px x octave scale); otherwise
    the local-map radii (2.5 / 4.0 px by viewing angle).

    Returns (best_idx (N,), matched (N,) bool, visible (P,) bool)."""
    Xc = se3.transform(T, ms.pt_xyz)
    z = Xc[:, 2]
    iz = 1.0 / z.clamp_min(1e-6)
    u = cam.fx * Xc[:, 0] * iz + cam.cx
    v = cam.fy * Xc[:, 1] * iz + cam.cy
    in_img = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)

    cam_center = se3.se3_inv(T)[:3, 3]
    po = ms.pt_xyz - cam_center
    dist = torch.linalg.vector_norm(po, dim=-1)
    in_range = (dist >= 0.8 * ms.pt_min_dist) & (dist <= 1.2 * ms.pt_max_dist)
    view_cos = torch.sum(po * ms.pt_normal, dim=-1) / dist.clamp_min(1e-6)
    visible = ms.pt_valid & (z > 0) & in_img & in_range & (view_cos > 0.5)
    if pt_mask is not None:
        visible = visible & pt_mask

    pred_level = predict_scale(dist, ms.pt_max_dist, scale, n_levels)
    if wide:
        r_base = torch.full_like(dist, 15.0)
    else:
        r_base = torch.where(view_cos > 0.998, 2.5, 4.0)
    radius = radius_scale * r_base * scale_factors[pred_level.long()]

    best_idx, best, _ = gated_match.gated_hamming_best2(
        feats.desc, feats.uv_un, feats.octave, feats.valid,
        ms.pt_desc, torch.stack([u, v], dim=-1), radius, pred_level, visible)
    matched = hamming.dedup_by_target(best_idx, best <= TH_HIGH, best,
                                      ms.pt_xyz.shape[0])
    return best_idx, matched, visible


def track_local_map(cam, ms: MapState, feats: PointFeatures, T_last,
                    scale_factors, sigma2_levels, th: float = 1.0,
                    n_levels: int = 8, scale: float = 1.2, velocity=None,
                    vel_gamma: float = 0.8, update_stats: bool = False,
                    anchor_kf=None, max_step_t: float = 0.15,
                    max_step_r: float = 0.35):
    """Two-stage tracking against the local map (`TrackWithMotionModel` ->
    `TrackLocalMap`): stage 1 optimizes the windowed motion-model matches and
    the windowless strict-ratio matches as separate hypotheses from the
    constant-velocity prediction and keeps the one with more inliers; stage
    2 runs the tight local-map search from that pose and the 4 x 10 pose
    optimization; a jump guard rejects implausible single-frame motion.

    With `update_stats`, returns (result, ms) after updating the map's
    found/visible counters in place (`update_point_stats`)."""
    device = T_last.device
    P = ms.pt_xyz.shape[0]
    if velocity is None:
        velocity = torch.eye(4, device=device)
    T_pred = velocity @ T_last
    sigma2_kp = sigma2_levels[feats.octave.clamp(0, n_levels - 1).long()]
    local = local_map_mask(ms, anchor_kf=anchor_kf)
    no_lines = pose_opt.PoseObs.empty_lines(1, device)

    # stage 1: windowed motion-model matches vs windowless ratio matches
    idx_w, m_w, _ = _match_against_map(cam, ms, feats, T_pred, scale_factors,
                                       th, True, n_levels, scale,
                                       pt_mask=local)
    g_idx, g_best, g_second = gated_match.gated_hamming_best2(
        feats.desc, feats.uv_un, feats.octave, feats.valid, ms.pt_desc,
        torch.zeros((P, 2), device=device), torch.zeros(P, device=device),
        torch.zeros(P, dtype=torch.int32, device=device),
        ms.pt_valid & local, gated=False)
    g_ok = (g_best <= TH_LOW) & (g_best.to(torch.float32)
                                 < 0.7 * g_second.to(torch.float32))
    g_ok = hamming.dedup_by_target(g_idx, g_ok, g_best, P)
    res_a = pose_opt.pose_optimize(
        cam, T_pred, pose_opt.PoseObs(ms.pt_xyz[idx_w], feats.uv_un,
                                      sigma2_kp, m_w, *no_lines),
        rounds=2, iters_per_round=5)
    res_b = pose_opt.pose_optimize(
        cam, T_pred, pose_opt.PoseObs(ms.pt_xyz[g_idx], feats.uv_un,
                                      sigma2_kp, g_ok, *no_lines),
        rounds=2, iters_per_round=5)
    take_a = res_a.n_inliers >= res_b.n_inliers.clamp_min(10)
    take_b = ~take_a & (res_b.n_inliers >= 10)
    T_mid = torch.where(take_a, res_a.T, torch.where(take_b, res_b.T, T_pred))

    # stage 2: tight local-map search from the refined pose
    idx2, m2, visible = _match_against_map(cam, ms, feats, T_mid,
                                           scale_factors, th, False,
                                           n_levels, scale, pt_mask=local)
    xyz2 = ms.pt_xyz[idx2]
    res2 = pose_opt.pose_optimize(
        cam, T_mid, pose_opt.PoseObs(xyz2, feats.uv_un, sigma2_kp, m2,
                                     *no_lines),
        rounds=4, iters_per_round=10)

    # catastrophic-jump guard, relative to the mean depth of the matches
    z2 = se3.transform(T_mid, xyz2)[:, 2]
    n_m2 = m2.to(torch.float32).sum()
    scene_scale = torch.where(
        n_m2 >= 10.0, torch.where(m2, z2, 0.0).sum() / n_m2.clamp_min(1.0),
        1.0)
    xi_jump = se3.se3_log(res2.T @ se3.se3_inv(T_last))
    jump_ok = ((torch.linalg.vector_norm(xi_jump[:3]) <= max_step_r)
               & (torch.linalg.vector_norm(xi_jump[3:])
                  <= max_step_t * scene_scale.clamp_min(1e-3))
               & torch.isfinite(res2.T).all())
    T_final = torch.where(jump_ok, res2.T, T_pred)

    inlier = res2.pt_inlier & m2 & jump_ok
    matched_pt = torch.where(inlier, idx2.to(torch.int32), -1)
    n_inl = inlier.sum(dtype=torch.int32)
    n_ln_inl = torch.zeros((), dtype=torch.int32, device=device)
    n_matched = (matched_pt >= 0).sum(dtype=torch.int32)
    # reference-keyframe points with >= 3 observations
    k_last = (ms.n_kf - 1).clamp_min(0)
    row = _row(ms.kf_pt_idx, k_last)
    nref3 = ((row >= 0) & (ms.pt_n_obs[row.clamp(0, P - 1).long()] >= 3)
             ).sum(dtype=torch.int32)
    # damped constant-velocity update
    new_velocity = torch.where(
        jump_ok, se3.se3_exp(vel_gamma * xi_jump),
        se3.se3_exp(vel_gamma * se3.se3_log(velocity)))
    result = TrackResult(
        T=T_final,
        matched_pt=matched_pt,
        inlier=inlier,
        n_inliers=n_inl,
        n_visible=visible.sum(dtype=torch.int32),
        visible_pts=visible,
        matched_ln=torch.full((1,), -1, dtype=torch.int32, device=device),
        ln_inlier=torch.zeros((1,), dtype=torch.bool, device=device),
        n_ln_inliers=n_ln_inl,
        visible_lns=torch.zeros(ms.ln_valid.shape, dtype=torch.bool,
                                device=device),
        scalars=torch.stack([n_inl, n_ln_inl, n_matched, nref3,
                             ms.n_pt, ms.n_ln]),
        velocity=new_velocity,
        T_rel=T_final @ se3.se3_inv(_row(ms.kf_T, k_last)),
    )
    if update_stats:
        return result, update_point_stats(ms, result)
    return result


def match_frames(feats1: PointFeatures, feats2: PointFeatures,
                 max_dist: int = TH_LOW, nn_ratio: float = 0.9,
                 window: float = 100.0, check_rotation: bool = True):
    """Frame-to-frame windowed NN matching (`SearchForInitialization`):
    feats1's keypoints against feats2's inside a `window` px box around the
    raw (distorted) location, octaves within 1, NN ratio and the rotation
    histogram. The window, octave and validity gates are K1's gate set, so
    the search is one `gated_hamming_best2` call.

    Returns (idx2 (N,), ok (N,)) mapping feats1 slots to feats2 slots."""
    n2 = feats2.uv.shape[0]
    idx, best, second = gated_match.gated_hamming_best2(
        feats1.desc, feats1.uv, feats1.octave, feats1.valid, feats2.desc,
        feats2.uv, torch.full((n2,), window, device=feats2.uv.device),
        feats2.octave, feats2.valid)
    ok = (best <= max_dist) & (best.to(torch.float32)
                               < nn_ratio * second.to(torch.float32))
    if check_rotation:
        ok = hamming.rotation_histogram_mask(feats1.angle - feats2.angle[idx],
                                             ok)
    return idx, ok


def update_point_stats(ms: MapState, result: TrackResult) -> MapState:
    """Add the tracking found/visible counts of points and lines to the map,
    in place; returns `ms`."""
    P = ms.pt_xyz.shape[0]
    L = ms.ln_valid.shape[0]
    ms.pt_visible += result.visible_pts.to(torch.int32)
    ms.pt_found.index_add_(0, result.matched_pt.clamp(0, P - 1).long(),
                           (result.matched_pt >= 0).to(torch.int32))
    ms.ln_visible += result.visible_lns.to(torch.int32)
    ms.ln_found.index_add_(0, result.matched_ln.clamp(0, L - 1).long(),
                           (result.matched_ln >= 0).to(torch.int32))
    return ms

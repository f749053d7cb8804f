"""Per-frame tracking against the local map, frozen as the benchmark's
reference: `track_local_map` and `update_point_stats`.

A copy of the port's `models/tracking.py` as it stood when the benchmark
was written, with relocalization and frame-to-frame matching left out. Its
three point searches go through `ops/gated_match`, which here is the plain
PyTorch search (the (N, P) distance matrix, formed in full), never the
port's CUDA kernel. It imports nothing of the port.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..ops import gated_match, hamming
from ..ops.extract import PointFeatures
from ..ops.lines import LineFeatures, _angle_diff
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
    hits = hits.index_add(0, idx.reshape(-1).clamp(0, n - 1).long(),
                          on.reshape(-1).to(torch.int32))
    return hits > 0


def _pixels(cam, Xc):
    """Pinhole pixels of camera-frame points (..., 3) as the JAX line code
    computes them: f * x * (1 / max(z, 1e-6)) + c."""
    iz = 1.0 / Xc[..., 2].clamp_min(1e-6)
    return torch.stack([cam.fx * Xc[..., 0] * iz + cam.cx,
                        cam.fy * Xc[..., 1] * iz + cam.cy], -1)


def predict_scale(dist, max_dist, scale: float, n_levels: int):
    """Expected octave from the ratio of the max scale-invariance distance to
    the current distance (`MapPoint::PredictScale`)."""
    ratio = (max_dist / dist.clamp_min(1e-6)).clamp_min(1e-6)
    log_s = torch.full((), scale, device=dist.device).log()  # float32 log
    level = torch.ceil(torch.log(ratio) / log_s)
    return level.clamp(0, n_levels - 1).to(torch.int32)


def local_map_mask(ms, window: int = 12, anchor_kf=None):
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


def _match_against_map(cam, ms, feats: PointFeatures, T,
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


def _match_lines_against_map(cam, ms, lfeats: LineFeatures, T,
                             radius: float = 10.0, angle_tol: float = 0.29,
                             max_dist: int = 80):
    """Projection search of the frame's line features against the map lines
    at pose T (`LSDmatcher::SearchByProjection`): both endpoints in front,
    the projected midpoint in the image, the viewing direction within 60
    degrees of the mean direction from the observing keyframes (derived from
    the current bindings; unobserved lines pass), then per pair direction
    within `angle_tol`, the feature midpoint within `radius` px of the
    projected infinite line, along-line overlap and a length ratio >= 0.5;
    Hamming <= `max_dist`, one feature per map line. The search is plain
    PyTorch: its gates are not K1's.

    Returns (best_idx (M,), matched (M,) bool, visible (L,) bool)."""
    A, B = ms.ln_xyz[:, 0], ms.ln_xyz[:, 1]
    Ac, Bc = se3.transform(T, A), se3.transform(T, B)
    ua, ub = _pixels(cam, Ac), _pixels(cam, Bc)
    mid = 0.5 * (ua + ub)
    in_img = ((mid[:, 0] >= 0) & (mid[:, 0] < cam.width)
              & (mid[:, 1] >= 0) & (mid[:, 1] < cam.height))
    visible = ms.ln_valid & (Ac[:, 2] > 0) & (Bc[:, 2] > 0) & in_img

    # viewing-direction gate (`MapLine::UpdateAverageDir`): the mean centre
    # of the keyframes bound to each line, from one (K, M) scatter
    L = ms.ln_valid.shape[0]
    kf_centers = -torch.einsum("kji,kj->ki", ms.kf_T[:, :3, :3],
                               ms.kf_T[:, :3, 3])                    # (K, 3)
    lid = ms.kf_ln_idx.clamp(0, L - 1).reshape(-1).long()
    has = (ms.kf_ln_idx >= 0) & ms.kf_valid[:, None]                 # (K, M)
    cnt = torch.zeros(L, device=A.device).index_add(
        0, lid, has.reshape(-1).to(torch.float32))
    csum = torch.zeros((L, 3), device=A.device).index_add(
        0, lid, torch.where(has[..., None], kf_centers[:, None, :],
                            0.0).reshape(-1, 3))
    mid3 = 0.5 * (A + B)
    unit = lambda v: v / torch.linalg.vector_norm(
        v, dim=-1, keepdim=True).clamp_min(1e-9)
    avg_dir = unit(mid3 - csum / cnt.clamp_min(1.0)[:, None])
    now_dir = unit(mid3 - se3.se3_inv(T)[:3, 3])
    view_cos = torch.sum(avg_dir * now_dir, dim=-1)
    visible = visible & ((cnt < 1.0) | (view_cos > 0.5))

    d = ub - ua
    proj_angle = torch.remainder(torch.atan2(d[:, 1], d[:, 0]), torch.pi)
    proj_len = torch.linalg.vector_norm(d, dim=-1)
    d_ang = _angle_diff(lfeats.angle[:, None], proj_angle[None, :])
    # perpendicular distance of the feature midpoint to the projected
    # infinite line, and along-line overlap (`mutualOverlap`)
    dirs = d / proj_len.clamp_min(1e-6)[:, None]                    # (L, 2)
    rel = (0.5 * (lfeats.uv_a + lfeats.uv_b))[:, None, :] - mid[None, :, :]
    d_perp = (rel[..., 0] * (-dirs[None, :, 1])
              + rel[..., 1] * dirs[None, :, 0]).abs()
    d_along = (rel[..., 0] * dirs[None, :, 0]
               + rel[..., 1] * dirs[None, :, 1]).abs()
    len_f, len_p = lfeats.length[:, None], proj_len[None, :]
    overlap = d_along < 0.6 * (len_f + len_p)
    lr = torch.minimum(len_f, len_p) / torch.maximum(len_f,
                                                     len_p).clamp_min(1e-6)
    mask = (visible[None, :] & lfeats.valid[:, None] & (d_ang < angle_tol)
            & (d_perp < radius) & overlap & (lr >= 0.5))
    D = hamming.distance_matrix(lfeats.desc, ms.ln_desc)
    best_idx, best, _ = hamming.masked_best2(D, mask)
    matched = hamming.dedup_by_target(best_idx, best <= max_dist, best, L)
    return best_idx, matched, visible


def track_local_map(cam, ms, feats: PointFeatures, T_last,
                    scale_factors, sigma2_levels, lfeats=None,
                    th: float = 1.0, n_levels: int = 8, scale: float = 1.2,
                    line_info: float = 1.0, velocity=None,
                    vel_gamma: float = 0.8, update_stats: bool = False,
                    anchor_kf=None, kp_ur=None, bf: float = 0.0,
                    max_step_t: float = 0.15, max_step_r: float = 0.35):
    """Two-stage tracking against the local map (`TrackWithMotionModel` ->
    `TrackLocalMap`): stage 1 optimizes the windowed motion-model matches and
    the windowless strict-ratio matches as separate hypotheses from the
    constant-velocity prediction and keeps the one with more inliers; stage
    2 runs the tight local-map search from that pose (plus, with line
    features `lfeats`, the map-line search) and the 4 x 10 pose optimization
    with the line endpoint edges weighted `line_info` x the line's
    triangulation conditioning; a jump guard rejects implausible
    single-frame motion, its translation cap relative to the mean depth of
    the matches (so it holds on metric maps too). A line is an inlier when
    both its endpoint edges are. With a depth sensor, `kp_ur` (N,) gives
    each keypoint's right-image column (<= 0: none) and `bf` = fx x
    baseline, and all three pose optimizations use 3-dof stereo point
    edges.

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
    stereo = {} if kp_ur is None else dict(pt_ur=kp_ur, bf=bf)

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
                                      sigma2_kp, m_w, *no_lines, **stereo),
        rounds=2, iters_per_round=5)
    res_b = pose_opt.pose_optimize(
        cam, T_pred, pose_opt.PoseObs(ms.pt_xyz[g_idx], feats.uv_un,
                                      sigma2_kp, g_ok, *no_lines, **stereo),
        rounds=2, iters_per_round=5)
    take_a = res_a.n_inliers >= res_b.n_inliers.clamp_min(10)
    take_b = ~take_a & (res_b.n_inliers >= 10)
    T_mid = torch.where(take_a, res_a.T, torch.where(take_b, res_b.T, T_pred))

    # stage 2: tight local-map search from the refined pose
    idx2, m2, visible = _match_against_map(cam, ms, feats, T_mid,
                                           scale_factors, th, False,
                                           n_levels, scale, pt_mask=local)
    xyz2 = ms.pt_xyz[idx2]
    if lfeats is not None:
        lidx, lm, ln_visible = _match_lines_against_map(cam, ms, lfeats,
                                                        T_mid)
        ends = ms.ln_xyz[lidx]                                     # (M, 2, 3)
        cond = ms.ln_cond[lidx]
        lines = (torch.cat([ends[:, 0], ends[:, 1]]),
                 torch.cat([lfeats.l2d, lfeats.l2d]), torch.cat([lm, lm]),
                 line_info * torch.cat([cond, cond]))
    else:
        lidx = torch.zeros(1, dtype=torch.int64, device=device)
        lm = torch.zeros(1, dtype=torch.bool, device=device)
        ln_visible = torch.zeros(ms.ln_valid.shape, dtype=torch.bool,
                                 device=device)
        lines = no_lines
    res2 = pose_opt.pose_optimize(
        cam, T_mid, pose_opt.PoseObs(xyz2, feats.uv_un, sigma2_kp, m2,
                                     *lines, **stereo),
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
    M = lm.shape[0]
    ln_in = lm & res2.ln_inlier[:M] & res2.ln_inlier[M:] & jump_ok \
        if lfeats is not None else torch.zeros_like(lm)
    matched_ln = torch.where(ln_in, lidx.to(torch.int32), -1)
    n_ln_inl = ln_in.sum(dtype=torch.int32)
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
        matched_ln=matched_ln,
        ln_inlier=ln_in,
        n_ln_inliers=n_ln_inl,
        visible_lns=ln_visible,
        scalars=torch.stack([n_inl, n_ln_inl, n_matched, nref3,
                             ms.n_pt, ms.n_ln]),
        velocity=new_velocity,
        T_rel=T_final @ se3.se3_inv(_row(ms.kf_T, k_last)),
    )
    if update_stats:
        return result, update_point_stats(ms, result)
    return result


def update_point_stats(ms, result: TrackResult) :
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

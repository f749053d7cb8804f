"""Keyframe middle end: insertion, triangulation of new landmarks, local BA
and culling (the LocalMapping stage) as in-place updates of `MapState`.

Port of `plslam_tpu/models/mapping.py`: points and lines, depth-sensor
keyframes, loop fusion and the global BA's merge. Whole keyframes
are matched at once (Hamming matrix + epipolar, projection or direction
gates), every candidate triangulates at once (points by DLT, lines by
ray-plane intersection), and new landmarks take slots by prefix sum. Nothing here waits for the device: where the JAX package
branches on a device value (`lax.cond`), the port ANDs the condition into
the creation or cull mask, which leaves the map exactly as the skipped branch
would. Writes that the JAX package routes to a dropped out-of-bounds slot,
or scatters as `where(selected, new, old)`, go through `_scatter_rows`, which
writes the selected lanes only, so unselected lanes can never race a real
write (see ROADMAP Queue 3 for where the two differ).

The searches here (epipolar-gated triangulation matching, per-keypoint
projection windows, direction-gated mutual-best line matching, 3-D duplicate
fusion) do not fit K1's gate set and stay plain PyTorch, as the JAX package
keeps them in XLA.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..geometry import camera, se3, triangulation as tri
from ..mapstate import state as mstate
from ..mapstate.state import MapState
from ..ops import hamming, stereo
from ..ops.extract import PointFeatures
from ..ops.lines import LineFeatures, _angle_diff
from ..optim import local_ba
from ..vocab import bow
from .tracking import _bitmap, _pixels, _row, _top

TH_LOW = 50
CHI2_2D = 5.991
GBA_MERGE_MAX_LAG = 16   # keyframes born during a global BA walked by parent


def _scatter_rows(dst, slot, ok, src):
    """dst[slot[i]] = src[i] for every lane i with ok[i], in place. `slot`
    must be distinct over those lanes; other lanes write nothing, whatever
    their slot."""
    dst.copy_(_with_rows(dst, slot, ok, src))


def _with_rows(dst, slot, ok, src):
    """`_scatter_rows` out of place: a new tensor (which `torch.func.vmap`
    batches when `dst` is not batched)."""
    n_rows = dst.shape[0]
    lane = torch.full((n_rows + 1,), -1, dtype=torch.long,
                      device=dst.device).scatter(
        0, torch.where(ok, slot, n_rows).long(),
        torch.arange(slot.shape[0], device=dst.device))
    lane = lane[:n_rows]
    hit = (lane >= 0).view((n_rows,) + (1,) * (dst.dim() - 1))
    return torch.where(hit, src[lane.clamp_min(0)], dst)


def _set_row(dst, k, value):
    """dst[k] = value for a 0-d index k, dropped when k is out of range."""
    k = k.reshape(1)
    _scatter_rows(dst, k, k < dst.shape[0], value[None])


def _index(k, device, dtype=torch.long):
    """A Python scalar or 0-d tensor as a 0-d tensor on `device`, made by a
    fill kernel (no host-to-device copy)."""
    if torch.is_tensor(k):
        return k.to(dtype)
    return torch.full((), k, dtype=dtype, device=device)


def _write_slots(ms: MapState, slots, a, values: dict):
    """ms.<name>[slots[i]] = values[name][i] for the accepted lanes a."""
    for name, value in values.items():
        _scatter_rows(getattr(ms, name), slots, a, value)


def insert_keyframe(cam, ms: MapState, feats: PointFeatures, T, matched_pt,
                    frame_id, scale_factors, lfeats: LineFeatures = None,
                    matched_ln=None, desc_majority: bool = False,
                    kp_depth=None, bf: float = 0.0) -> MapState:
    """Promote the current frame to keyframe `ms.n_kf` (`CreateNewKeyFrame`
    + `ProcessNewKeyFrame`), in place: write its keypoints and BoW
    signature (and its line segments, with `lfeats`), bind the tracked
    landmarks `matched_pt` and map lines `matched_ln` (-1 = none), and
    refresh their observation counts; points also their mean viewing
    directions and descriptors (latest observation; with `desc_majority`,
    the bitwise strict majority of the observed descriptors once a point
    has 3), lines their descriptors (latest observation). `matched_pt` and
    `matched_ln` must bind each landmark at most once, as tracking's
    deduplicated matches do. With a depth sensor (`kp_depth` (N,) and `bf`
    = fx x baseline > 0), each keypoint's right-image column u - bf / depth
    (-1 without a depth) goes into `kf_ur` for BA's stereo edges. A full
    keyframe array drops the write, as the JAX package's scatter does."""
    del cam, scale_factors  # kept for the JAX signature
    device = T.device
    k = ms.n_kf
    P = ms.pt_xyz.shape[0]
    rows = [("kf_T", T), ("kf_valid", torch.ones((), dtype=torch.bool,
                                                  device=device)),
            ("kf_frame_id", _index(frame_id, device, torch.int32)),
            ("kf_uv", feats.uv_un), ("kf_octave", feats.octave),
            ("kf_angle", feats.angle), ("kf_desc", feats.desc),
            ("kf_kp_valid", feats.valid), ("kf_pt_idx", matched_pt),
            ("kf_bow", bow.bow_vector(feats.desc, feats.valid))]
    if kp_depth is not None and bf > 0:
        rows.append(("kf_ur", stereo.right_columns(feats, kp_depth, bf)))
    if lfeats is not None:
        if matched_ln is None:
            matched_ln = torch.full(lfeats.valid.shape, -1, dtype=torch.int32,
                                    device=device)
        rows += [("kf_ln_uv", torch.stack([lfeats.uv_a, lfeats.uv_b], -2)),
                 ("kf_ln_l2d", lfeats.l2d), ("kf_ln_desc", lfeats.desc),
                 ("kf_ln_valid", lfeats.valid), ("kf_ln_idx", matched_ln)]
    for name, value in rows:
        _set_row(getattr(ms, name), k, value)
    ms.n_kf += 1
    if lfeats is not None:
        # accepted lanes only: the JAX package's unmatched lanes rewrite line
        # 0's old descriptor over its update (ROADMAP Queue 3)
        has_l = matched_ln >= 0
        lid = matched_ln.clamp(0, ms.ln_valid.shape[0] - 1).long()
        ms.ln_n_obs.index_add_(0, lid, has_l.to(torch.int32))
        _scatter_rows(ms.ln_desc, lid, has_l, lfeats.desc)

    has = matched_pt >= 0
    pid = matched_pt.clamp(0, P - 1).long()
    ms.pt_n_obs.index_add_(0, pid, has.to(torch.int32))
    c_w = se3.se3_inv(T)[:3, 3]
    dirs = ms.pt_xyz[pid] - c_w
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1,
                                           keepdim=True).clamp_min(1e-6)
    n_obs = ms.pt_n_obs[pid].to(torch.float32).clamp_min(1.0)[:, None]
    ms.pt_normal.index_add_(0, pid, torch.where(
        has[:, None], (dirs - ms.pt_normal[pid]) / n_obs, 0.0))
    room = has & (ms.pt_desc_cnt[pid] < 255)
    ms.pt_desc_acc.index_add_(0, pid, torch.where(
        room[:, None], feats.desc, 0).to(torch.uint8))
    ms.pt_desc_cnt.index_add_(0, pid, room.to(torch.int32))
    rep = feats.desc
    if desc_majority:
        cnt = ms.pt_desc_cnt[pid]
        maj = (2 * ms.pt_desc_acc[pid].to(torch.int32)
               > cnt.clamp_min(1)[:, None]).to(torch.uint8)
        rep = torch.where((cnt >= 3)[:, None], maj, rep)
    _scatter_rows(ms.pt_desc, pid, has, rep)
    return ms


def create_points_from_depth(cam, ms: MapState, k, kp_depth, scale_factors,
                             max_depth: float = 40.0) -> MapState:
    """Create map points from per-keypoint depth (`StereoInitialization` and
    the close-point creation of `CreateNewKeyFrame`), in place: every
    unbound keypoint of keyframe `k` with depth in (0.05, max_depth) becomes
    a landmark with one observation, bound in `kf_pt_idx[k]`. Points past the
    capacity are dropped."""
    P = ms.pt_xyz.shape[0]
    k = _index(k, kp_depth.device)
    T_wc = se3.se3_inv(_row(ms.kf_T, k))
    uv = _row(ms.kf_uv, k)
    rays = torch.stack([(uv[:, 0] - cam.cx) / cam.fx,
                        (uv[:, 1] - cam.cy) / cam.fy,
                        torch.ones_like(uv[:, 0])], dim=-1)
    Xw = se3.transform(T_wc, rays * kp_depth[:, None])
    pt_idx = _row(ms.kf_pt_idx, k)
    create = (_row(ms.kf_kp_valid, k) & (pt_idx < 0) & (kp_depth > 0.05)
              & (kp_depth < max_depth) & torch.isfinite(Xw).all(-1))
    slots, a, n_pt_new = mstate.append_slots(ms.n_pt, create, P)

    c_w = T_wc[:3, 3]
    d = torch.linalg.vector_norm(Xw - c_w, dim=-1)
    max_dist = d * scale_factors[_row(ms.kf_octave, k).long()]
    desc = _row(ms.kf_desc, k)
    ones = torch.ones_like(slots, dtype=torch.int32)
    _write_slots(ms, slots, a, {
        "pt_xyz": Xw, "pt_desc": desc,
        "pt_normal": (Xw - c_w) / d[:, None].clamp_min(1e-6),
        "pt_min_dist": max_dist / scale_factors[-1], "pt_max_dist": max_dist,
        "pt_valid": a, "pt_first_kf": k.to(torch.int32).expand_as(slots),
        "pt_n_obs": ones, "pt_desc_acc": desc, "pt_desc_cnt": ones,
        "pt_visible": ones, "pt_found": ones})
    ms.n_pt.copy_(n_pt_new)
    _set_row(ms.kf_pt_idx, k, torch.where(a, slots.to(torch.int32), pt_idx))
    return ms


def _fundamental_between(cam, T1, T2):
    """F12 with x2^T F x1 = 0 in pixels (`LocalMapping::ComputeF12`)."""
    T21 = T2 @ se3.se3_inv(T1)
    E = se3.hat(T21[:3, 3]) @ T21[:3, :3]
    Kinv = torch.linalg.inv_ex(camera.intrinsics(cam, T1.device)).inverse
    return Kinv.T @ E @ Kinv


def _project(cam, Xc):
    """Pixels of camera-frame points, depth clamped at 1e-6."""
    z = Xc[..., 2].clamp_min(1e-6)
    return torch.stack([cam.fx * Xc[..., 0] / z + cam.cx,
                        cam.fy * Xc[..., 1] / z + cam.cy], dim=-1)


def create_new_points(cam, ms: MapState, k_new, k_ref, sigma2_levels,
                      scale_factors, nn_ratio: float = 0.6,
                      min_baseline_depth: float = 0.01,
                      enabled=True) -> MapState:
    """Triangulate new map points between keyframes k_new and k_ref
    (`CreateNewMapPoints`), in place: epipolar-gated Hamming matching of
    unbound keypoints (ratio test, mutual best), batched DLT, then the
    cheirality, parallax, reprojection and scale-consistency gates, and the
    pair-level gate baseline / median depth >= `min_baseline_depth`. New
    points take slots by prefix sum and bind in both keyframes. `enabled`
    (bool or 0-d bool tensor) ANDs into the creation mask: False leaves the
    map as it was."""
    device = ms.pt_xyz.device
    P, N = ms.pt_xyz.shape[0], ms.kf_uv.shape[1]
    k_new, k_ref = _index(k_new, device), _index(k_ref, device)
    T1, T2 = _row(ms.kf_T, k_new), _row(ms.kf_T, k_ref)
    uv1, uv2 = _row(ms.kf_uv, k_new), _row(ms.kf_uv, k_ref)
    rows1 = _row(ms.kf_pt_idx, k_new)
    free1 = _row(ms.kf_kp_valid, k_new) & (rows1 < 0)
    free2 = _row(ms.kf_kp_valid, k_ref) & (_row(ms.kf_pt_idx, k_ref) < 0)
    oct1 = _row(ms.kf_octave, k_new).long()
    oct2 = _row(ms.kf_octave, k_ref).long()
    desc1 = _row(ms.kf_desc, k_new)
    D = hamming.distance_matrix(desc1, _row(ms.kf_desc, k_ref))

    # epipolar gate: distance of kp2 to the epipolar line of kp1
    ones = torch.ones((N, 1), device=device)
    l2 = torch.cat([uv1, ones], -1) @ _fundamental_between(cam, T1, T2).T
    num = (l2 @ torch.cat([uv2, ones], -1).T).abs()               # (N1, N2)
    den = torch.sqrt((l2[:, 0:1] ** 2 + l2[:, 1:2] ** 2).clamp_min(1e-12))
    epi_ok = (num / den) ** 2 < 3.84 * sigma2_levels[oct2][None, :]
    mask = free1[:, None] & free2[None, :] & epi_ok
    idx2, best, second = hamming.masked_best2(D, mask)
    ok = (best <= TH_LOW) & (best.to(torch.float32)
                             < nn_ratio * second.to(torch.float32))
    rev = torch.argmin(torch.where(mask, D, hamming.INVALID), dim=0)
    ok = ok & (rev[idx2] == torch.arange(N, device=device))

    # batched triangulation + the reference's acceptance gates
    K = camera.intrinsics(cam, device)
    uv2m = uv2[idx2]
    X = tri.triangulate_dlt(tri.projection_matrix(K, T1),
                            tri.projection_matrix(K, T2), uv1, uv2m)
    Xc1, Xc2 = se3.transform(T1, X), se3.transform(T2, X)
    e1 = torch.sum((_project(cam, Xc1) - uv1) ** 2, -1) / sigma2_levels[oct1]
    e2 = torch.sum((_project(cam, Xc2) - uv2m) ** 2, -1) \
        / sigma2_levels[oct2][idx2]
    c1 = se3.se3_inv(T1)[:3, 3]
    c2 = se3.se3_inv(T2)[:3, 3]
    cosp = tri.parallax_cos(c1, c2, X)
    # scale consistency: distance ratio vs octave ratio
    d1 = torch.linalg.vector_norm(X - c1, dim=-1)
    d2 = torch.linalg.vector_norm(X - c2, dim=-1)
    ratio_dist = d2 / d1.clamp_min(1e-6)
    ratio_oct = scale_factors[oct1] / scale_factors[oct2][idx2]
    ratio_factor = 1.5 * 1.2
    scale_ok = (ratio_dist * ratio_factor > ratio_oct) & (
        ratio_dist < ratio_oct * ratio_factor)

    # pair-level conditioning: baseline vs median depth of the landmarks
    # k_new already observes (permissive while it observes fewer than 10)
    baseline = torch.linalg.vector_norm(c1 - c2)
    safe = rows1.clamp(0, P - 1).long()
    obs_ok = (rows1 >= 0) & ms.pt_valid[safe]
    z_obs = se3.transform(T1, ms.pt_xyz[safe])[:, 2]
    z_sorted = torch.sort(torch.where(obs_ok, z_obs, torch.inf))[0]
    n_obs_med = obs_ok.sum(dtype=torch.int32)
    med_depth = _row(z_sorted, (n_obs_med // 2).clamp(0, N - 1))
    pair_ok = torch.where((n_obs_med >= 10) & torch.isfinite(med_depth),
                          baseline >= min_baseline_depth * med_depth, True)

    create = (ok & torch.isfinite(X).all(-1) & (Xc1[:, 2] > 0)
              & (Xc2[:, 2] > 0) & (cosp < 0.9998) & (e1 < CHI2_2D)
              & (e2 < CHI2_2D) & scale_ok & pair_ok & enabled)
    slots, a, n_pt_new = mstate.append_slots(ms.n_pt, create, P)

    # scale-invariance range from the octave (MapPoint::UpdateNormalAndDepth)
    max_dist = d1 * scale_factors[oct1]
    ones_i = torch.ones_like(slots, dtype=torch.int32)
    _write_slots(ms, slots, a, {
        "pt_xyz": X, "pt_desc": desc1,
        "pt_normal": (X - c1) / d1[:, None].clamp_min(1e-6),
        "pt_min_dist": max_dist / scale_factors[-1],
        "pt_max_dist": max_dist, "pt_valid": a,
        "pt_first_kf": k_new.to(torch.int32).expand_as(slots),
        "pt_n_obs": 2 * ones_i, "pt_desc_acc": desc1,
        "pt_desc_cnt": ones_i, "pt_visible": ones_i, "pt_found": ones_i})
    ms.n_pt.copy_(n_pt_new)
    # bind in both keyframes; k_ref's row is read after k_new's is written
    pid = torch.where(a, slots.to(torch.int32), -1)
    _set_row(ms.kf_pt_idx, k_new, torch.where(a, pid, rows1))
    row_ref = _row(ms.kf_pt_idx, k_ref)
    _scatter_rows(row_ref, idx2, a, pid)
    _set_row(ms.kf_pt_idx, k_ref, row_ref)
    return ms


def _segment_angle(uv):
    """Direction angle in [0, pi) of segments (..., 2, 2) [A, B]."""
    return torch.remainder(torch.atan2(uv[..., 1, 1] - uv[..., 0, 1],
                                       uv[..., 1, 0] - uv[..., 0, 0]),
                           torch.pi)


def _line_dist(l, q):
    """|l . (q, 1)| of lines l (..., 3) and pixels q (..., 2)."""
    return (l[..., 0] * q[..., 0] + l[..., 1] * q[..., 1] + l[..., 2]).abs()


def third_view_support(cam, ms: MapState, k3, Xa, Xb,
                       angle_tol: float = 0.3, dist_tol: float = 4.0):
    """3-view consistency of candidate 3-D lines (Xa, Xb) (Mc, 3)
    (`CreateNewMapLinesConstraint`): (Mc,) bool, True where both endpoints
    lie in front of keyframe k3 and some valid segment of k3 agrees with the
    projection in direction (< `angle_tol`) and passes within `dist_tol` px
    of both projected endpoints."""
    k3 = _index(k3, Xa.device)
    T3 = _row(ms.kf_T, k3)
    Pa, Pb = se3.transform(T3, Xa), se3.transform(T3, Xb)
    qa, qb = _pixels(cam, Pa), _pixels(cam, Pb)
    l3 = _row(ms.kf_ln_l2d, k3)[None, :, :]                       # (1, M3, 3)
    d_ang = _angle_diff(_segment_angle(torch.stack([qa, qb], 1))[:, None],
                        _segment_angle(_row(ms.kf_ln_uv, k3))[None, :])
    near = ((_line_dist(l3, qa[:, None, :]) < dist_tol)
            & (_line_dist(l3, qb[:, None, :]) < dist_tol))
    ok = near & (d_ang < angle_tol) & _row(ms.kf_ln_valid, k3)[None, :]
    return (Pa[:, 2] > 0) & (Pb[:, 2] > 0) & ok.any(dim=1)


def create_new_lines(cam, ms: MapState, k_new, k_ref, nn_ratio: float = 0.75,
                     max_dist: int = 50, angle_tol: float = 0.29,
                     k_third=None, min_cond: float = 2e-4,
                     enabled=True) -> MapState:
    """Triangulate new map lines between keyframes k_new and k_ref (the
    2-view core of `CreateNewMapLines`), in place: mutual-best Hamming
    matching of unbound segments with direction agreement, ratio test and
    the gap gate second - best > 0.5 x the MAD of the match distances;
    plane-intersection triangulation; finite, non-degenerate planes (cos <
    0.9998), cheirality in both views, endpoint reprojection onto the
    observed lines < 4 px, an extent sane against the median depth of the
    map's points; with `k_third`, support in that keyframe
    (`third_view_support`; a negative 0-d index means none); the
    conditioning gate (b / z) sin(theta) >= `min_cond`, whose ratio to the
    gate (clipped to 1) is the line's `ln_cond`. New lines take slots by
    prefix sum and bind in both keyframes. `enabled` (bool or 0-d bool
    tensor) ANDs into the creation mask: False leaves the map as it was."""
    device = ms.ln_xyz.device
    Lc, M = ms.ln_valid.shape[0], ms.kf_ln_valid.shape[1]
    k_new, k_ref = _index(k_new, device), _index(k_ref, device)
    T1, T2 = _row(ms.kf_T, k_new), _row(ms.kf_T, k_ref)
    rows1 = _row(ms.kf_ln_idx, k_new)
    free1 = _row(ms.kf_ln_valid, k_new) & (rows1 < 0)
    free2 = _row(ms.kf_ln_valid, k_ref) & (_row(ms.kf_ln_idx, k_ref) < 0)
    uv1, uv2 = _row(ms.kf_ln_uv, k_new), _row(ms.kf_ln_uv, k_ref)  # (M, 2, 2)
    d_ang = _angle_diff(_segment_angle(uv1)[:, None],
                        _segment_angle(uv2)[None, :])
    desc1 = _row(ms.kf_ln_desc, k_new)
    D = hamming.distance_matrix(desc1, _row(ms.kf_ln_desc, k_ref))
    mask = free1[:, None] & free2[None, :] & (d_ang < angle_tol)
    idx2, best, second, mutual = hamming.mutual_best(D, mask)
    ok = (best <= max_dist) & (best.to(torch.float32)
                               < nn_ratio * second.to(torch.float32))
    # adaptive 1st-vs-2nd gap gate scaled by the MAD of the match distances
    mad = hamming.vector_mad(best, ok & (best < hamming.INVALID))
    ok = ok & ((second - best).to(torch.float32) > 0.5 * mad) & mutual

    uv2m = uv2[idx2]
    Xa, Xb, da, db = tri.triangulate_line_two_view(
        cam, T1, T2, uv1[:, 0], uv1[:, 1], uv2m[:, 0], uv2m[:, 1])
    finite = torch.isfinite(Xa).all(-1) & torch.isfinite(Xb).all(-1)
    # plane-normal angle > ~1 deg (parallax degeneracy)
    K = camera.intrinsics(cam, device)
    l1 = tri.line_from_endpoints_2d(uv1[:, 0], uv1[:, 1])
    l2 = tri.line_from_endpoints_2d(uv2m[:, 0], uv2m[:, 1])
    n1 = tri.backproject_plane(K, T1, l1)[:, :3]
    n2 = tri.backproject_plane(K, T2, l2)[:, :3]
    cosn = torch.sum(n1 * n2, -1).abs() / (
        torch.linalg.vector_norm(n1, dim=-1)
        * torch.linalg.vector_norm(n2, dim=-1)).clamp_min(1e-9)

    def reproj_line_err(T, l):
        Pa, Pb = se3.transform(T, Xa), se3.transform(T, Xb)
        err = torch.maximum(_line_dist(l, _pixels(cam, Pa)),
                            _line_dist(l, _pixels(cam, Pb)))
        return err, (Pa[:, 2] > 0) & (Pb[:, 2] > 0)

    e1, chei1 = reproj_line_err(T1, l1)
    e2, chei2 = reproj_line_err(T2, l2)
    # extent against the median depth of the map's points; the median of
    # the NaN-filled slots is NaN (so 1.0) until every slot is valid, as in
    # the JAX package (ROADMAP Queue 3)
    c1 = se3.se3_inv(T1)[:3, 3]
    c2 = se3.se3_inv(T2)[:3, 3]
    pt_d = torch.linalg.vector_norm(ms.pt_xyz - c1, dim=-1)
    pt_d = torch.where(ms.pt_valid, pt_d, torch.nan)
    scene_d = torch.where(torch.isnan(pt_d).any(), 1.0,
                          hamming.nanmedian(pt_d))
    sane = ((torch.linalg.vector_norm(Xb - Xa, dim=-1) < 3.0 * scene_d)
            & (torch.linalg.vector_norm(0.5 * (Xa + Xb) - c1, dim=-1)
               < 10.0 * scene_d))
    create = (ok & finite & (cosn < 0.9998) & chei1 & chei2 & (e1 < 4.0)
              & (e2 < 4.0) & (da > 0) & (db > 0) & sane & enabled)
    if k_third is not None:
        k3 = _index(k_third, device)
        create = create & ((k3 < 0) | third_view_support(
            cam, ms, k3.clamp_min(0), Xa, Xb))
    # baseline-aware conditioning gate: (b / z) sin(theta)
    z_mid = (0.5 * (da + db)).clamp_min(1e-6)
    sin_th = torch.sqrt((1.0 - cosn * cosn).clamp_min(0.0))
    metric = (torch.linalg.vector_norm(c1 - c2) / z_mid) * sin_th
    create = create & (metric >= min_cond)
    cond = (metric / max(min_cond, 1e-9)).clamp(0.0, 1.0)

    slots, a, n_ln_new = mstate.append_slots(ms.n_ln, create, Lc)
    ones_i = torch.ones_like(slots, dtype=torch.int32)
    _write_slots(ms, slots, a, {
        "ln_xyz": torch.stack([Xa, Xb], dim=1), "ln_desc": desc1,
        "ln_valid": a, "ln_first_kf": k_new.to(torch.int32).expand_as(slots),
        "ln_n_obs": 2 * ones_i, "ln_visible": ones_i, "ln_found": ones_i,
        "ln_cond": cond})
    ms.n_ln.copy_(n_ln_new)
    # bind in both keyframes; k_ref's row is read after k_new's is written
    lid = torch.where(a, slots.to(torch.int32), -1)
    _set_row(ms.kf_ln_idx, k_new, torch.where(a, lid, rows1))
    row_ref = _row(ms.kf_ln_idx, k_ref)
    _scatter_rows(row_ref, idx2, a, lid)
    _set_row(ms.kf_ln_idx, k_ref, row_ref)
    return ms


def project_and_bind(cam, ms: MapState, kf, cand_mask, radius: float = 3.0,
                     max_hamming: int = 50) -> MapState:
    """Project the candidate points `cand_mask` (P,) into keyframe `kf` and
    bind matching free keypoints as new observations, in place (the
    observation-densification role of `ORBmatcher::Fuse`): scale-invariance
    range, viewing angle cos > 0.5, points not yet in the keyframe, a
    radius of `radius` x 1.2^octave around each keypoint, Hamming <=
    `max_hamming` with ratio 0.9, one keypoint per point."""
    P = ms.pt_xyz.shape[0]
    kf = _index(kf, ms.pt_xyz.device)
    T = _row(ms.kf_T, kf)
    Xc = se3.transform(T, ms.pt_xyz)
    z = Xc[:, 2]
    iz = 1.0 / z.clamp_min(1e-6)
    u = cam.fx * Xc[:, 0] * iz + cam.cx
    v = cam.fy * Xc[:, 1] * iz + cam.cy
    in_img = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    po = ms.pt_xyz - se3.se3_inv(T)[:3, 3]
    dist = torch.linalg.vector_norm(po, dim=-1)
    in_range = (dist >= 0.8 * ms.pt_min_dist) & (dist <= 1.2 * ms.pt_max_dist)
    view_cos = torch.sum(po * ms.pt_normal, dim=-1) / dist.clamp_min(1e-6)
    row = _row(ms.kf_pt_idx, kf)
    vis = (cand_mask & ms.pt_valid & (z > 0) & in_img & in_range
           & (view_cos > 0.5) & ~_bitmap(P, row, row >= 0))

    octave = _row(ms.kf_octave, kf).to(torch.float32)
    r = radius * torch.full_like(octave, 1.2).pow(octave)[:, None]   # (N, 1)
    uv = _row(ms.kf_uv, kf)
    du = (uv[:, 0:1] - u[None, :]).abs()
    dv = (uv[:, 1:2] - v[None, :]).abs()
    D = hamming.distance_matrix(_row(ms.kf_desc, kf), ms.pt_desc)
    free = _row(ms.kf_kp_valid, kf) & (row < 0) & _row(ms.kf_valid, kf)
    mask = (du < r) & (dv < r) & vis[None, :] & free[:, None]
    idx, best, second = hamming.masked_best2(D, mask)
    bind = (best <= max_hamming) & (best.to(torch.float32)
                                     < 0.9 * second.to(torch.float32))
    bind = hamming.dedup_by_target(idx, bind, best, P)
    row = torch.where(bind, idx.to(torch.int32), row)
    _set_row(ms.kf_pt_idx, kf, row)
    ms.pt_n_obs.index_add_(0, row.clamp(0, P - 1).long(),
                           bind.to(torch.int32))
    return ms


def loop_fuse(cam, ms: MapState, kf, cand_mask, radius: float = 4.0,
              max_hamming: int = 50) -> MapState:
    """Loop fusion with replace semantics (`SearchAndFuse`,
    `MapPoint::Replace`), in place: project the loop-side points
    `cand_mask` (P,) into keyframe `kf`, the same visibility tests as
    `project_and_bind`, a radius of `radius` x 1.2^octave around each
    keypoint, Hamming <= `max_hamming` and mutual best over the keyframe's
    keypoints. A free keypoint binds its match; a keypoint bound to a
    non-loop point has that point replaced by its match everywhere in the
    map, its observation count moved over and the duplicate invalidated.
    When two keypoints replace the same point, the later one wins. The
    search is plain PyTorch: its radius is per keypoint, not K1's per map
    point."""
    P, N = ms.pt_xyz.shape[0], ms.kf_uv.shape[1]
    dev = ms.pt_xyz.device
    kf = _index(kf, dev)
    T = _row(ms.kf_T, kf)
    Xc = se3.transform(T, ms.pt_xyz)
    z = Xc[:, 2]
    iz = 1.0 / z.clamp_min(1e-6)
    u = cam.fx * Xc[:, 0] * iz + cam.cx
    v = cam.fy * Xc[:, 1] * iz + cam.cy
    in_img = (u >= 0) & (u < cam.width) & (v >= 0) & (v < cam.height)
    po = ms.pt_xyz - se3.se3_inv(T)[:3, 3]
    dist = torch.linalg.vector_norm(po, dim=-1)
    in_range = (dist >= 0.8 * ms.pt_min_dist) & (dist <= 1.2 * ms.pt_max_dist)
    view_cos = torch.sum(po * ms.pt_normal, dim=-1) / dist.clamp_min(1e-6)
    vis = (cand_mask & ms.pt_valid & (z > 0) & in_img & in_range
           & (view_cos > 0.5))

    octave = _row(ms.kf_octave, kf).to(torch.float32)
    r = radius * torch.full_like(octave, 1.2).pow(octave)[:, None]   # (N, 1)
    uv = _row(ms.kf_uv, kf)
    mask = (((uv[:, 0:1] - u[None, :]).abs() < r)
            & ((uv[:, 1:2] - v[None, :]).abs() < r) & vis[None, :]
            & (_row(ms.kf_kp_valid, kf) & _row(ms.kf_valid, kf))[:, None])
    idx, best, _, mutual = hamming.mutual_best(
        hamming.distance_matrix(_row(ms.kf_desc, kf), ms.pt_desc), mask)
    bind = (best <= max_hamming) & mutual
    old = _row(ms.kf_pt_idx, kf)
    oldc = old.clamp(0, P - 1).long()
    is_dup = bind & (old >= 0) & ~cand_mask[oldc] & (oldc != idx)
    is_new = bind & (old < 0)
    # duplicate id -> loop point id (identity elsewhere), map-wide
    lane = torch.full((P + 1,), -1, dtype=torch.long, device=dev)
    lane = lane.scatter_reduce(0, torch.where(is_dup, oldc, P),
                               torch.arange(N, device=dev), reduce="amax")
    lane = lane[:P]
    lut = torch.where(lane >= 0, idx[lane.clamp_min(0)],
                      torch.arange(P, device=dev))
    pid = ms.kf_pt_idx.clamp(0, P - 1).long()
    ms.kf_pt_idx.copy_(torch.where(ms.kf_pt_idx >= 0, lut[pid].to(torch.int32),
                                   ms.kf_pt_idx))
    _set_row(ms.kf_pt_idx, kf, torch.where(is_new, idx.to(torch.int32),
                                            _row(ms.kf_pt_idx, kf)))
    # move observation counts to the kept points; kill the duplicates
    n_obs = torch.cat([ms.pt_n_obs, ms.pt_n_obs.new_zeros(1)])
    n_obs.index_add_(0, torch.where(is_dup, idx, P),
                     torch.where(is_dup, ms.pt_n_obs[oldc], 0))
    n_obs.index_add_(0, torch.where(is_new, idx, P), is_new.to(torch.int32))
    ms.pt_n_obs.copy_(n_obs[:P])
    ms.pt_valid.copy_(ms.pt_valid & ~_bitmap(P, oldc, is_dup))
    return ms


def search_in_neighbors(cam, ms: MapState, k_new,
                        covis_targets: bool = False,
                        whole_map: bool = False,
                        n_targets: int = 10, n_hop2: int = 5,
                        n_reverse: int = 2) -> MapState:
    """`SearchInNeighbors`, both directions, in place: bind the points of
    the new keyframe's neighbourhood (its `n_targets` best covisible
    keyframes and each one's `n_hop2` best, or the whole map with
    `whole_map`) into its free keypoints, then its points into `n_reverse`
    keyframes: the best covisible ones with `covis_targets` (the
    predecessor when covisibility is below 10), else the predecessors."""
    K, P = ms.kf_T.shape[0], ms.pt_xyz.shape[0]
    k_new = _index(k_new, ms.pt_xyz.device)
    ids = torch.arange(K, device=k_new.device)

    def covis_weights():
        row = mstate.covis_rows(ms, k_new.reshape(1))[0]            # (K,)
        return torch.where(ms.kf_valid & (ids != k_new), row, -1)

    if whole_map:
        fuse_pts = torch.ones(P, dtype=torch.bool, device=ids.device)
    else:
        top_w, top_i = _top(covis_weights(), min(n_targets, K))
        t1_ok = top_w > 0
        rows2 = mstate.covis_rows(ms, top_i)                         # (n1, K)
        rows2 = torch.where(t1_ok[:, None] & (ids[None, :] != k_new)
                            & ms.kf_valid[None, :], rows2, -1)
        nb_w, nb_i = _top(rows2, min(n_hop2, K))                     # (n1, n2)
        tmask = _bitmap(K, top_i, t1_ok) | _bitmap(K, nb_i, nb_w > 0)
        trows = torch.where(tmask[:, None], ms.kf_pt_idx, -1)
        fuse_pts = _bitmap(P, trows, trows >= 0)
    project_and_bind(cam, ms, k_new, fuse_pts)
    row = _row(ms.kf_pt_idx, k_new)
    new_pts = _bitmap(P, row, row >= 0)
    n_rev = min(n_reverse, K)
    if covis_targets:
        w_top, top = _top(covis_weights(), n_rev)
        for i in range(n_rev):
            kt = torch.where(w_top[i] >= 10, top[i],
                             (k_new - (i + 1)).clamp(0, K - 1))
            project_and_bind(cam, ms, kt, new_pts)
    else:
        for back in range(1, n_reverse + 1):
            project_and_bind(cam, ms, (k_new - back).clamp(0, K - 1),
                             new_pts)
    return ms


def _refresh_n_obs(ms: MapState):
    """pt_n_obs = number of keyframes observing each point."""
    return mstate.observers_of_points(ms).sum(0, dtype=torch.int32)


def fuse_duplicate_points(ms: MapState, n_recent: int = 1024,
                          max_dist3d: float = 0.05, max_hamming: int = 40
                          ) -> MapState:
    """Duplicate-landmark fusion (`MapPoint::Replace` semantics), in place:
    each of the last `n_recent` allocated points that lies within
    `max_dist3d` of an older valid point with Hamming <= `max_hamming` is
    merged into the first such point; bindings are rewired map-wide."""
    P = ms.pt_xyz.shape[0]
    device = ms.pt_xyz.device
    start = (ms.n_pt - n_recent).clamp_min(0)
    r_ids = (start + torch.arange(n_recent, device=device)).clamp(0, P - 1)
    r_valid = ms.pt_valid[r_ids]
    d3 = torch.linalg.vector_norm(ms.pt_xyz[r_ids][:, None, :]
                                  - ms.pt_xyz[None, :, :], dim=-1)   # (R, P)
    D = hamming.distance_matrix(ms.pt_desc[r_ids], ms.pt_desc)
    older = torch.arange(P, device=device)[None, :] < r_ids[:, None]
    cand = (r_valid[:, None] & ms.pt_valid[None, :] & older
            & (d3 < max_dist3d) & (D <= max_hamming))
    target = torch.argmax(cand.to(torch.uint8), dim=1)   # first older match
    has_dup = cand.any(dim=1)
    repl = torch.arange(P, device=device).index_put(
        (r_ids,), torch.where(has_dup, target, r_ids))
    pid = ms.kf_pt_idx.clamp(0, P - 1).long()
    ms.kf_pt_idx.copy_(torch.where(ms.kf_pt_idx >= 0, repl[pid],
                                   ms.kf_pt_idx))
    ms.pt_valid[r_ids] = r_valid & ~has_dup
    ms.pt_n_obs.copy_(_refresh_n_obs(ms))
    return ms


def fuse_duplicate_lines(ms: MapState, n_recent: int = 256,
                         max_mid_dist: float = 0.1, angle_tol: float = 0.15,
                         max_hamming: int = 50) -> MapState:
    """Duplicate map-line fusion (`MapLine::Replace` semantics), in place:
    each of the last `n_recent` allocated lines whose midpoint lies within
    `max_mid_dist` of an older valid line's, within `angle_tol` of its
    direction and Hamming <= `max_hamming`, is merged into the first such
    line, which takes the larger conditioning of the two; bindings are
    rewired map-wide and observation counts recounted. With fewer than
    `n_recent` slots the recent ids repeat the last slot; the repeats
    write what the first write of that slot wrote."""
    Lc = ms.ln_valid.shape[0]
    device = ms.ln_xyz.device
    start = (ms.n_ln - n_recent).clamp_min(0)
    r_ids = (start + torch.arange(n_recent, device=device)).clamp(0, Lc - 1)
    r_valid = ms.ln_valid[r_ids]
    mid = 0.5 * (ms.ln_xyz[:, 0] + ms.ln_xyz[:, 1])                    # (L, 3)
    dirs = ms.ln_xyz[:, 1] - ms.ln_xyz[:, 0]
    dirs = dirs / torch.linalg.vector_norm(dirs, dim=-1,
                                           keepdim=True).clamp_min(1e-9)
    d_mid = torch.linalg.vector_norm(mid[r_ids][:, None, :]
                                     - mid[None, :, :], dim=-1)      # (R, L)
    cos_d = torch.sum(dirs[r_ids][:, None, :] * dirs[None, :, :], -1).abs()
    D = hamming.distance_matrix(ms.ln_desc[r_ids], ms.ln_desc)
    older = torch.arange(Lc, device=device)[None, :] < r_ids[:, None]
    cand = (r_valid[:, None] & ms.ln_valid[None, :] & older
            & (d_mid < max_mid_dist) & (cos_d > math.cos(angle_tol))
            & (D <= max_hamming))
    target = torch.argmax(cand.to(torch.uint8), dim=1)   # first older match
    has_dup = cand.any(dim=1)
    repl = torch.arange(Lc, device=device).index_put(
        (r_ids,), torch.where(has_dup, target, r_ids))
    lid = ms.kf_ln_idx.clamp(0, Lc - 1).long()
    ms.kf_ln_idx.copy_(torch.where(ms.kf_ln_idx >= 0, repl[lid],
                                   ms.kf_ln_idx))
    ms.ln_valid[r_ids] = r_valid & ~has_dup
    ms.ln_n_obs.zero_().index_add_(
        0, ms.kf_ln_idx.clamp(0, Lc - 1).reshape(-1).long(),
        (ms.kf_ln_idx >= 0).reshape(-1).to(torch.int32))
    ms.ln_cond.scatter_reduce_(0, target, torch.where(
        has_dup, ms.ln_cond[r_ids], 0.0), reduce="amax")
    return ms


def dedup_kf_point_rows(cam, ms: MapState) -> MapState:
    """Free duplicate same-point bindings within each keyframe, in place:
    per (keyframe, point) keep the keypoint whose pixel best reprojects the
    point (`MapPoint::Replace` erases the match when the keyframe already
    observes the replacement)."""
    P = ms.pt_xyz.shape[0]
    rows = ms.kf_pt_idx
    pid = rows.clamp(0, P - 1).long()
    q = _project(cam, se3.transform(ms.kf_T, ms.pt_xyz[pid]))
    err = torch.sum((q - ms.kf_uv) ** 2, dim=-1)
    tgt = torch.where(rows >= 0, pid, P)             # unbound rows -> dump id
    # lexsort by (point, error, lane): two stable sorts
    o1 = torch.sort(err, dim=1, stable=True)[1]
    order = o1.gather(1, torch.sort(tgt.gather(1, o1), dim=1,
                                    stable=True)[1])
    tgt_s = tgt.gather(1, order)
    keep_s = torch.cat([torch.ones_like(tgt_s[:, :1], dtype=torch.bool),
                        tgt_s[:, 1:] != tgt_s[:, :-1]], dim=1) | (tgt_s == P)
    keep = torch.empty_like(keep_s).scatter(1, order, keep_s)
    ms.kf_pt_idx.copy_(torch.where(keep, rows, -1))
    return ms


def cull_points(ms: MapState, k_now) -> MapState:
    """`MapPointCulling` (and `MapLineCulling`), in place: during a
    3-keyframe probation, drop points with found/visible < 0.25 (lines:
    0.1), or with <= 2 observations from their third keyframe on; erase
    their keyframe bindings."""
    age = k_now - ms.pt_first_kf
    found_ratio = ms.pt_found.to(torch.float32) / ms.pt_visible.to(
        torch.float32).clamp_min(1.0)
    bad = ms.pt_valid & (age < 3) & (
        (found_ratio < 0.25) | ((age >= 2) & (ms.pt_n_obs <= 2)))
    ms.pt_valid &= ~bad
    P = ms.pt_xyz.shape[0]
    ms.kf_pt_idx.copy_(torch.where(
        (ms.kf_pt_idx >= 0) & bad[ms.kf_pt_idx.clamp(0, P - 1).long()], -1,
        ms.kf_pt_idx))
    l_age = k_now - ms.ln_first_kf
    l_ratio = ms.ln_found.to(torch.float32) / ms.ln_visible.to(
        torch.float32).clamp_min(1.0)
    l_bad = ms.ln_valid & (l_age < 3) & (
        (l_ratio < 0.1) | ((l_age >= 2) & (ms.ln_n_obs <= 2)))
    ms.ln_valid &= ~l_bad
    L = ms.ln_valid.shape[0]
    ms.kf_ln_idx.copy_(torch.where(
        (ms.kf_ln_idx >= 0) & l_bad[ms.kf_ln_idx.clamp(0, L - 1).long()], -1,
        ms.kf_ln_idx))
    return ms


def cull_keyframes(ms: MapState, k_current, keep_recent: int = 3,
                   enabled=True) -> MapState:
    """`KeyFrameCulling`, in place: a keyframe is redundant when > 90% of
    its bound points are seen by >= 3 other keyframes at the same or a finer
    scale (octave <= own + 1). Keyframe 0 and the `keep_recent` latest are
    kept; a culled keyframe releases its observations and its slot stays
    allocated. `enabled` (bool or 0-d bool tensor) ANDs into the cull:
    False leaves the map as it was."""
    K, P = ms.kf_T.shape[0], ms.pt_xyz.shape[0]
    enabled = _index(enabled, ms.pt_xyz.device, torch.bool)
    n_levels = 16  # octave values are < 16 for every config
    bound = (ms.kf_pt_idx >= 0) & ms.kf_kp_valid                  # (K, N)
    pid = ms.kf_pt_idx.clamp(0, P - 1).long()
    oct_b = ms.kf_octave.clamp(0, n_levels - 1).long()
    # observers of each point at octave <= t, for every threshold t
    buckets = torch.zeros(n_levels * P, dtype=torch.int32,
                          device=pid.device)
    buckets = buckets.index_add(0, (oct_b * P + pid).reshape(-1),
                                (bound & ms.kf_valid[:, None]).reshape(-1)
                                .to(torch.int32))
    cnt_le = torch.cumsum(buckets.reshape(n_levels, P), 0, dtype=torch.int32)
    cnt = cnt_le[(oct_b + 1).clamp(0, n_levels - 1), pid] - 1   # others
    n_bound = bound.sum(1)
    frac = ((cnt >= 3) & bound).sum(1) / n_bound.clamp_min(1)
    ids = torch.arange(K, device=pid.device)
    protected = (ids == 0) | (ids > k_current - keep_recent)
    bad = (ms.kf_valid & ~protected & (frac > 0.9) & (n_bound > 0)
           & enabled)
    ms.kf_valid &= ~bad
    ms.kf_pt_idx.copy_(torch.where(bad[:, None], -1, ms.kf_pt_idx))
    ms.kf_ln_idx.copy_(torch.where(bad[:, None], -1, ms.kf_ln_idx))
    ms.pt_n_obs.copy_(torch.where(enabled, _refresh_n_obs(ms), ms.pt_n_obs))
    return ms


class BASelection(NamedTuple):
    """What `ba_writeback` needs to map a solved fixed-shape BA window back
    onto the map."""
    prob: local_ba.BAProblem
    ids_c: torch.Tensor        # (W,) global keyframe ids (clamped)
    kf_mask: torch.Tensor      # (W,)
    sel: torch.Tensor          # (p_ba,) global point ids
    sel_ok: torch.Tensor       # (p_ba,)
    lsel: torch.Tensor         # (l_ba,) global line ids
    lsel_ok: torch.Tensor      # (l_ba,)
    slot_safe: torch.Tensor    # (W, N) BA slot per keypoint
    has: torch.Tensor          # (W, N)
    l_slot_safe: torch.Tensor  # (W, Mf)
    l_has: torch.Tensor        # (W, Mf)
    win_pt_idx: torch.Tensor   # (W, N) bindings at selection time
    win_ln_idx: torch.Tensor   # (W, Mf)


def _select(win_idx, win_obs, valid, budget: int, rank=None):
    """Landmarks observed by the window, highest `rank` first (default:
    newest ids first), into `budget` slots: (sel, sel_ok, slot (W, M) or
    -1)."""
    n = valid.shape[0]
    observed = _bitmap(n, win_idx, win_obs) & valid
    if rank is None:
        rank = torch.arange(n, dtype=torch.int32, device=valid.device)
    scores = torch.where(observed, rank, -1)
    _, sel = _top(scores, budget)
    sel_ok = observed[sel]
    lookup = torch.full((n,), -1, dtype=torch.int32,
                        device=valid.device).index_put(
        (sel,), torch.where(sel_ok, torch.arange(
            budget, dtype=torch.int32, device=valid.device), -1))
    slot = torch.where(win_obs, lookup[win_idx.clamp(0, n - 1).long()], -1)
    return sel, sel_ok, slot


def _grid(base, slot, has, values):
    """base (W, S, ...) with base[w, slot[w, m]] = values[w, m] for the
    lanes `has` (the accepted lanes only), as a new tensor."""
    W, S = base.shape[:2]
    flat = slot + S * torch.arange(W, device=slot.device)[:, None]
    return _with_rows(base.reshape((W * S,) + base.shape[2:]),
                      flat.reshape(-1), has.reshape(-1),
                      values.reshape((-1,) + base.shape[2:])).reshape(
                          base.shape)


def ba_select(ms: MapState, sigma2_levels, window: int = 8,
              p_ba: int = 4096, l_ba: int = 512, rank_by_obs: bool = False,
              use_stereo: bool = False, bf: float = 0.0) -> BASelection:
    """The last `window` keyframes and the landmarks they observe as a
    fixed-shape `BAProblem` (the window half of
    `LocalBundleAdjustmentWithLine`). The two oldest valid window slots
    are fixed, which pins the monocular scale gauge. When the point budget
    binds, the newest points win (local BA: they need the refinement most),
    or with `rank_by_obs` the most observed ones, newer ids breaking ties
    in groups of 8 (global BA after a loop: the fused cross-loop landmarks
    are old ids and carry the coupling). With `use_stereo`, the window's
    `kf_ur` columns go into the problem's `obs_ur` grid (-1 where a cell
    has no stereo observation), for 3-dof stereo edges with `bf`."""
    p_ba = min(p_ba, ms.pt_xyz.shape[0])
    l_ba = min(l_ba, ms.ln_valid.shape[0])
    K_all = ms.kf_T.shape[0]
    W = min(window, K_all)
    dev = ms.pt_xyz.device
    ar = torch.arange(W, device=dev)
    ids = ms.n_kf - W + ar                     # k_new - W + 1 + ar
    ids_c = ids.clamp(0, K_all - 1).long()
    kf_mask = (ids >= 0) & (ids < K_all) & ms.kf_valid[ids_c]
    first = torch.argmax(kf_mask.to(torch.uint8))
    second = torch.argmax((kf_mask & (ar != first)).to(torch.uint8))
    kf_fixed = (ar == first) | (ar == second)

    win_pt_idx = ms.kf_pt_idx[ids_c]                                 # (W, N)
    rank = None
    if rank_by_obs:
        rank = (ms.pt_n_obs.clamp(0, 32767) * 32768
                + (torch.arange(ms.pt_xyz.shape[0], dtype=torch.int32,
                                device=dev) >> 3))
    sel, sel_ok, slot = _select(win_pt_idx, (win_pt_idx >= 0)
                                & kf_mask[:, None], ms.pt_valid, p_ba, rank)
    has = slot >= 0
    slot_safe = slot.clamp(0, p_ba - 1)
    obs_uv = _grid(torch.zeros((W, p_ba, 2), device=dev), slot_safe, has,
                   ms.kf_uv[ids_c])
    obs_s2 = _grid(torch.ones((W, p_ba), device=dev), slot_safe, has,
                   sigma2_levels[ms.kf_octave[ids_c].long()])
    obs_mask = mstate.row_bitmap(torch.where(has, slot_safe, -1), p_ba)
    # accepted lanes only: the JAX package's lanes without a slot write -1
    # over BA slot 0's column (ROADMAP Queue 3)
    obs_ur = _grid(torch.full((W, p_ba), -1.0, device=dev), slot_safe, has,
                   ms.kf_ur[ids_c]) if use_stereo else None

    win_ln_idx = ms.kf_ln_idx[ids_c]                                 # (W, Mf)
    lsel, lsel_ok, l_slot = _select(win_ln_idx, (win_ln_idx >= 0)
                                    & kf_mask[:, None], ms.ln_valid, l_ba)
    l_has = l_slot >= 0
    l_slot_safe = l_slot.clamp(0, l_ba - 1)
    ln_obs_l2d = _grid(_no_line(dev).expand(W, l_ba, 3).clone(),
                       l_slot_safe, l_has, ms.kf_ln_l2d[ids_c])
    ln_obs_mask = mstate.row_bitmap(torch.where(l_has, l_slot_safe, -1),
                                    l_ba)
    prob = local_ba.BAProblem(
        kf_T=ms.kf_T[ids_c], kf_fixed=kf_fixed | ~kf_mask, kf_mask=kf_mask,
        pt_xyz=ms.pt_xyz[sel], pt_mask=sel_ok, obs_uv=obs_uv,
        obs_mask=obs_mask, obs_sigma2=obs_s2, ln_xyz=ms.ln_xyz[lsel],
        ln_mask=lsel_ok, ln_obs_l2d=ln_obs_l2d, ln_obs_mask=ln_obs_mask,
        # base 0.5 (`src/Optimizer.cc:1909`) x triangulation conditioning
        ln_info=0.5 * ms.ln_cond[lsel], obs_ur=obs_ur, bf=bf)
    return BASelection(prob, ids_c, kf_mask, sel, sel_ok, lsel, lsel_ok,
                       slot_safe, has, l_slot_safe, l_has, win_pt_idx,
                       win_ln_idx)


def _no_line(device):
    """The (3,) placeholder line [1, 0, -1e9] that no endpoint lies on."""
    f = lambda v: torch.full((), v, device=device)
    return torch.stack([f(1.0), f(0.0), f(-1e9)])


def _repin(old_ln, new_ln):
    """(l, 2, 3) endpoints on the optimized infinite lines `new_ln`, at the
    points closest to the old endpoints (the endpoint residual leaves the
    along-line direction free)."""
    new_a = new_ln[:, 0]
    d = new_ln[:, 1] - new_a
    d = d / torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-9)
    ta = torch.sum((old_ln[:, 0] - new_a) * d, dim=-1)
    tb = torch.sum((old_ln[:, 1] - new_a) * d, dim=-1)
    return torch.stack([new_a + ta[:, None] * d, new_a + tb[:, None] * d],
                       dim=1)


def ba_writeback(ms: MapState, s: BASelection, res) -> MapState:
    """Write a solved BA window back into the map, in place: poses, points,
    lines re-pinned at the points of the optimized infinite line closest to
    their old endpoints, and erase the outlier observations."""
    _scatter_rows(ms.kf_T, s.ids_c, s.kf_mask, res.kf_T)
    _scatter_rows(ms.pt_xyz, s.sel, s.sel_ok, res.pt_xyz)
    _scatter_rows(ms.ln_xyz, s.lsel, s.lsel_ok,
                  _repin(ms.ln_xyz[s.lsel], res.ln_xyz))

    obs_bad = s.prob.obs_mask & ~res.obs_inlier                 # (W, p_ba)
    bad_here = s.has & obs_bad.gather(1, s.slot_safe.long())    # (W, N)
    _scatter_rows(ms.kf_pt_idx, s.ids_c, s.kf_mask,
                  torch.where(bad_here, -1, s.win_pt_idx))
    l_bad = s.prob.ln_obs_mask & ~res.ln_obs_inlier
    l_bad_here = s.l_has & l_bad.gather(1, s.l_slot_safe.long())
    _scatter_rows(ms.kf_ln_idx, s.ids_c, s.kf_mask,
                  torch.where(l_bad_here, -1, s.win_ln_idx))
    ms.pt_n_obs.copy_(_refresh_n_obs(ms))
    return ms


def run_local_ba(cam, ms: MapState, sigma2_levels, window: int = 8,
                 p_ba: int = 4096, l_ba: int = 512, iters_a: int = 5,
                 iters_b: int = 10, rank_by_obs: bool = False,
                 use_stereo: bool = False, bf: float = 0.0) -> MapState:
    """Local BA over the last `window` keyframes
    (`LocalBundleAdjustmentWithLine`), in place: select, solve, write back,
    erase the outlier observations. With a window spanning the map and
    `rank_by_obs`, this is the global BA (`GlobalBundleAdjustemnt`); with
    `use_stereo`, the stored right-image columns add stereo edges."""
    selection = ba_select(ms, sigma2_levels, window=window, p_ba=p_ba,
                          l_ba=l_ba, rank_by_obs=rank_by_obs,
                          use_stereo=use_stereo, bf=bf)
    res = local_ba.bundle_adjust(selection.prob, cam, iters_a=iters_a,
                                 iters_b=iters_b)
    return ba_writeback(ms, selection, res)

def gba_merge(ms: MapState, s: BASelection, res, kf_T_old,
              start_kf: int) -> MapState:
    """Merge a global BA solved over several frames into the current map,
    in place (`RunGlobalBundleAdjustment`): the window's keyframes and
    selected landmarks take the optimized values; keyframes created since
    the BA started (`start_kf` on) keep their pose relative to their
    spanning-tree parent (the earlier keyframe sharing the most points, >=
    15, else the previous one), resolved in index order for the first
    GBA_MERGE_MAX_LAG of them and through the tip keyframe's correction
    beyond; the other landmarks move with their reference keyframe's
    correction. `kf_T_old` holds the poses when the BA started. No
    observation is erased. Accepted lanes only are written."""
    K, K_old, P = ms.kf_T.shape[0], kf_T_old.shape[0], ms.pt_xyz.shape[0]
    dev = ms.pt_xyz.device
    ids = torch.arange(K, device=dev)
    # 1) optimized window poses
    kf_T = ms.kf_T.clone()
    _scatter_rows(kf_T, s.ids_c, s.kf_mask, res.kf_T)
    # poses before: the BA-start snapshot, creation poses for newer ones
    old_all = ms.kf_T.clone()
    old_all[:K_old] = kf_T_old
    old_all = torch.where((ids < start_kf)[:, None, None], old_all, ms.kf_T)
    # 2) tip-anchor delta for keyframes past the parent walk
    anchor = min(max(start_kf - 1, 0), K - 1)
    delta = se3.se3_inv(kf_T_old[min(anchor, K_old - 1)]) @ kf_T[anchor]
    kf_T = torch.where(((ids >= start_kf) & ms.kf_valid)[:, None, None],
                       ms.kf_T @ delta, kf_T)
    # 2b) spanning-tree parent walk
    lag = GBA_MERGE_MAX_LAG
    ks = (start_kf + torch.arange(lag, device=dev)).clamp(0, K - 1)
    Wm = torch.where(ids[None, :] < ks[:, None],
                     mstate.covis_rows(ms, ks), -1)               # (lag, K)
    w_par, par = Wm.max(dim=1)           # first maximum (`jnp.argmax`)
    par = torch.where(w_par >= 15, par, (ks - 1).clamp_min(0))
    upd = (ks >= start_kf) & (ks < ms.n_kf) & ms.kf_valid[ks]
    for i in range(lag):
        k, p = ks[i:i + 1], par[i:i + 1]
        T_new = ms.kf_T[k] @ se3.se3_inv(old_all[p]) @ kf_T[p]
        _scatter_rows(kf_T, k, upd[i:i + 1], T_new)
    # 3) landmarks: BA values for the selected, the rest re-mapped
    sel_mask = _bitmap(P, s.sel, s.sel_ok)
    ref = ms.pt_first_kf.clamp(0, K - 1).long()
    Xw = se3.transform(se3.se3_inv(kf_T[ref]),
                       se3.transform(old_all[ref], ms.pt_xyz))
    keep = (ms.pt_valid & ~sel_mask)[:, None]
    pt_xyz = torch.where(keep, Xw, ms.pt_xyz)
    _scatter_rows(pt_xyz, s.sel, s.sel_ok, res.pt_xyz)
    Lc = ms.ln_valid.shape[0]
    lsel_mask = _bitmap(Lc, s.lsel, s.lsel_ok)
    lref = ms.ln_first_kf.clamp(0, K - 1).long()
    Tl_old, Tl_new_inv = old_all[lref], se3.se3_inv(kf_T[lref])
    remap = lambda e: se3.transform(Tl_new_inv, se3.transform(Tl_old, e))
    ln_xyz = torch.where((ms.ln_valid & ~lsel_mask)[:, None, None],
                         torch.stack([remap(ms.ln_xyz[:, 0]),
                                      remap(ms.ln_xyz[:, 1])], 1), ms.ln_xyz)
    _scatter_rows(ln_xyz, s.lsel, s.lsel_ok,
                  _repin(ms.ln_xyz[s.lsel], res.ln_xyz))
    ms.kf_T.copy_(kf_T)
    ms.pt_xyz.copy_(pt_xyz)
    ms.ln_xyz.copy_(ln_xyz)
    return ms


def process_keyframe(cam, ms: MapState, feats, lfeats, T, matched_pt,
                     matched_ln, frame_id, kp_depth, sigma2_levels,
                     scale_factors, window: int, p_ba: int, l_ba: int,
                     max_depth: float, do_kf_cull, use_depth,
                     desc_majority: bool = False, bf: float = 0.0,
                     tri_covis: bool = False, tri_covis_k: int = 3,
                     sin_covis: bool = False, sin_whole_map: bool = False,
                     sin_reverse_n: int = 2) -> MapState:
    """The keyframe chain, in place: insert -> triangulate new points
    against up to `tri_covis_k` + 1 partners -> (triangulate new lines
    against 3 partners -> fuse duplicate lines) -> (with `use_depth`, points
    from the keypoint depths `kp_depth` below `max_depth`) -> fuse duplicate
    points -> search in neighbours -> dedup rows -> local BA (4 + 8
    iterations; with `use_depth` and `bf` > 0 the keyframes' right-image
    columns add stereo edges) -> cull points and lines -> cull keyframes
    when `do_kf_cull`.

    Partners: with `tri_covis`, the top covisible keyframes, deepest
    baseline first, each falling back to its rung of the 2^i-back ladder
    when it shares < 10 points; else the fixed {8, 4, 2}-back ladder; then
    always the previous keyframe. With line features `lfeats` (bound to the
    map lines `matched_ln`), new lines then triangulate against the 1, 2
    and 3 keyframes back, each with 3-view support in the keyframe behind
    it where that exists, and duplicate lines fuse. A partner that does not
    exist masks its creation instead of branching, so nothing waits for the
    device; `use_depth` is a Python bool."""
    k_new = ms.n_kf.to(torch.long)         # a copy: insert bumps n_kf
    insert_keyframe(cam, ms, feats, T, matched_pt, frame_id, scale_factors,
                    lfeats=lfeats, matched_ln=matched_ln,
                    desc_majority=desc_majority,
                    kp_depth=kp_depth if use_depth else None, bf=bf)
    triangulate = lambda kr, enabled: create_new_points(
        cam, ms, k_new, kr, sigma2_levels, scale_factors, enabled=enabled)
    if tri_covis:
        K_all = ms.kf_T.shape[0]
        row = mstate.covis_rows(ms, k_new.reshape(1))[0]            # (K,)
        w = torch.where(ms.kf_valid & (torch.arange(
            K_all, device=row.device) != k_new), row, -1)
        _, top = _top(w, tri_covis_k)
        c_new = se3.se3_inv(_row(ms.kf_T, k_new))[:3, 3]
        base = torch.linalg.vector_norm(
            se3.se3_inv(ms.kf_T[top])[:, :3, 3] - c_new, dim=-1)
        base = torch.where(w[top] >= 10, base, -1.0)
        order = torch.sort(-base, stable=True)[1]
        top, base = top[order], base[order]
        for i in range(tri_covis_k):
            kr = torch.where(base[i] > 0, top[i],
                             (k_new - 2 ** (tri_covis_k - i)).clamp_min(0))
            triangulate(kr, (kr < k_new) & (kr >= 0))
    else:
        for back in (8, 4, 2):
            triangulate((k_new - back).clamp_min(0), k_new >= back)
    triangulate((k_new - 1).clamp_min(0), True)
    if lfeats is not None:
        for back in (1, 2, 3):
            create_new_lines(cam, ms, k_new, (k_new - back).clamp_min(0),
                             k_third=torch.where(k_new >= back + 1,
                                                 k_new - back - 1, -1),
                             enabled=k_new >= back)
        fuse_duplicate_lines(ms)
    if use_depth:
        create_points_from_depth(cam, ms, k_new, kp_depth, scale_factors,
                                 max_depth)
    fuse_duplicate_points(ms)
    search_in_neighbors(cam, ms, k_new, covis_targets=sin_covis,
                        whole_map=sin_whole_map, n_reverse=sin_reverse_n)
    # rewiring can leave a keyframe with two rows bound to one landmark;
    # erase the worse row before BA reads the observations
    dedup_kf_point_rows(cam, ms)
    ms.pt_n_obs.copy_(_refresh_n_obs(ms))
    run_local_ba(cam, ms, sigma2_levels, window=window, p_ba=p_ba,
                 l_ba=l_ba, iters_a=4, iters_b=8,
                 use_stereo=bool(use_depth) and bf > 0, bf=bf)
    cull_points(ms, k_new)
    return cull_keyframes(ms, k_new, enabled=do_kf_cull)

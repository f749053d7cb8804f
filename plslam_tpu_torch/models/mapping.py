"""Keyframe insertion and depth-seeded landmark creation.

Port of two functions of `plslam_tpu/models/mapping.py`: `insert_keyframe`
(the points part) and `create_points_from_depth`. Both update the map in
place and return it. Writes that the JAX package routes to a dropped
out-of-bounds slot go through `_scatter_rows`, which writes the selected lanes
only, so unselected lanes can never race a real write.
"""
from __future__ import annotations

import torch

from ..geometry import se3
from ..mapstate import state as mstate
from ..mapstate.state import MapState
from ..ops.extract import PointFeatures
from ..vocab import bow


def _scatter_rows(dst, slot, ok, src):
    """dst[slot[i]] = src[i] for every lane i with ok[i], in place. `slot`
    must be distinct over those lanes; other lanes write nothing, whatever
    their slot."""
    n_rows = dst.shape[0]
    lane = torch.full((n_rows + 1,), -1, dtype=torch.long, device=dst.device)
    lane.scatter_(0, torch.where(ok, slot, n_rows).long(),
                  torch.arange(slot.shape[0], device=dst.device))
    lane = lane[:n_rows]
    hit = (lane >= 0).view((n_rows,) + (1,) * (dst.dim() - 1))
    dst.copy_(torch.where(hit, src[lane.clamp_min(0)], dst))


def _set_row(dst, k, value):
    """dst[k] = value for a 0-d index k, dropped when k is out of range."""
    k = k.reshape(1)
    _scatter_rows(dst, k, k < dst.shape[0], value[None])


def insert_keyframe(cam, ms: MapState, feats: PointFeatures, T, matched_pt,
                    frame_id, scale_factors) -> MapState:
    """Promote the current frame to keyframe `ms.n_kf` (`CreateNewKeyFrame`
    + `ProcessNewKeyFrame`), in place: write its keypoints and BoW
    signature, bind the tracked landmarks `matched_pt` (-1 = none), and
    refresh their observation counts, mean viewing directions and
    descriptors (latest observation). `matched_pt` must bind each landmark
    at most once, as tracking's deduplicated matches do. A full keyframe
    array drops the write, as the JAX package's scatter does."""
    del cam, scale_factors  # kept for the JAX signature
    device = T.device
    k = ms.n_kf
    P = ms.pt_xyz.shape[0]
    for name, value in (
            ("kf_T", T), ("kf_valid", torch.ones((), dtype=torch.bool,
                                                 device=device)),
            ("kf_frame_id", torch.full((), frame_id, dtype=torch.int32,
                                       device=device)),
            ("kf_uv", feats.uv_un), ("kf_octave", feats.octave),
            ("kf_angle", feats.angle), ("kf_desc", feats.desc),
            ("kf_kp_valid", feats.valid), ("kf_pt_idx", matched_pt),
            ("kf_bow", bow.bow_vector(feats.desc, feats.valid))):
        _set_row(getattr(ms, name), k, value)
    ms.n_kf += 1

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
    _scatter_rows(ms.pt_desc, pid, has, feats.desc)
    return ms


def create_points_from_depth(cam, ms: MapState, k, kp_depth, scale_factors,
                             max_depth: float = 40.0) -> MapState:
    """Create map points from per-keypoint depth (`StereoInitialization` and
    the close-point creation of `CreateNewKeyFrame`), in place: every
    unbound keypoint of keyframe `k` with depth in (0.05, max_depth) becomes
    a landmark with one observation, bound in `kf_pt_idx[k]`. Points past the
    capacity are dropped."""
    P = ms.pt_xyz.shape[0]
    k = torch.full((1,), k, dtype=torch.long, device=kp_depth.device) \
        if isinstance(k, int) else k.reshape(1).long()
    row = lambda t: t.index_select(0, k)[0]
    T_wc = se3.se3_inv(row(ms.kf_T))
    uv = row(ms.kf_uv)
    rays = torch.stack([(uv[:, 0] - cam.cx) / cam.fx,
                        (uv[:, 1] - cam.cy) / cam.fy,
                        torch.ones_like(uv[:, 0])], dim=-1)
    Xw = se3.transform(T_wc, rays * kp_depth[:, None])
    pt_idx = row(ms.kf_pt_idx)
    create = (row(ms.kf_kp_valid) & (pt_idx < 0) & (kp_depth > 0.05)
              & (kp_depth < max_depth) & torch.isfinite(Xw).all(-1))
    slots, a, n_pt_new = mstate.append_slots(ms.n_pt, create, P)

    c_w = T_wc[:3, 3]
    d = torch.linalg.vector_norm(Xw - c_w, dim=-1)
    max_dist = d * scale_factors[row(ms.kf_octave).long()]
    min_dist = max_dist / scale_factors[-1]
    normal = (Xw - c_w) / d[:, None].clamp_min(1e-6)
    desc = row(ms.kf_desc)
    ones = torch.ones_like(slots, dtype=torch.int32)
    for name, value in (
            ("pt_xyz", Xw), ("pt_desc", desc), ("pt_normal", normal),
            ("pt_min_dist", min_dist), ("pt_max_dist", max_dist),
            ("pt_valid", a), ("pt_first_kf", k.to(torch.int32).expand_as(
                slots)),
            ("pt_n_obs", ones), ("pt_desc_acc", desc),
            ("pt_desc_cnt", ones), ("pt_visible", ones), ("pt_found", ones)):
        _scatter_rows(getattr(ms, name), slots, a, value)
    ms.n_pt.copy_(n_pt_new)
    _set_row(ms.kf_pt_idx, k[0], torch.where(a, slots.to(torch.int32),
                                             pt_idx))
    return ms

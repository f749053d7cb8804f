"""The SLAM map as one dataclass of fixed-shape tensors.

Port of `plslam_tpu/mapstate/state.py`: structure-of-arrays with capacities
and validity masks. The field names, shapes and dtypes are those of the JAX
`MapState`, so a map crosses between the packages field by field
(`mapstate/checkpoint.from_numpy`). `dataclasses.replace` stands in for
`_replace`; functions documented as in-place update the tensors directly.
`grow` returns a new map of larger capacities.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import torch

from ..vocab import bow


class MapConfig(NamedTuple):
    max_kf: int = 48          # keyframe capacity
    max_pt: int = 12288       # map point capacity
    max_ln: int = 1024        # map line capacity
    n_kp: int = 1024          # keypoint slots per frame
    n_lf: int = 256           # line-feature slots per frame
    n_levels: int = 8
    scale: float = 1.2


@dataclasses.dataclass
class MapState:
    # --- map points ---
    pt_xyz: torch.Tensor       # (P, 3) f32
    pt_desc: torch.Tensor      # (P, 256) u8 representative descriptor
    pt_normal: torch.Tensor    # (P, 3) mean viewing direction
    pt_min_dist: torch.Tensor  # (P,) scale-invariance range
    pt_max_dist: torch.Tensor  # (P,)
    pt_valid: torch.Tensor     # (P,) bool
    pt_visible: torch.Tensor   # (P,) i32 frustum-visible count
    pt_found: torch.Tensor     # (P,) i32 actually-matched count
    pt_first_kf: torch.Tensor  # (P,) i32
    pt_n_obs: torch.Tensor     # (P,) i32
    pt_desc_acc: torch.Tensor  # (P, 256) u8 bit-vote counts
    pt_desc_cnt: torch.Tensor  # (P,) i32 samples accumulated
    # --- map lines (two endpoints) ---
    ln_xyz: torch.Tensor       # (L, 2, 3)
    ln_desc: torch.Tensor      # (L, 256) u8
    ln_valid: torch.Tensor     # (L,) bool
    ln_visible: torch.Tensor   # (L,) i32
    ln_found: torch.Tensor     # (L,) i32
    ln_first_kf: torch.Tensor  # (L,) i32
    ln_n_obs: torch.Tensor     # (L,) i32
    ln_cond: torch.Tensor      # (L,) f32 triangulation-conditioning weight
    # --- keyframes ---
    kf_T: torch.Tensor         # (K, 4, 4) world -> cam
    kf_valid: torch.Tensor     # (K,) bool
    kf_frame_id: torch.Tensor  # (K,) i32
    kf_uv: torch.Tensor        # (K, N, 2) undistorted keypoints
    kf_octave: torch.Tensor    # (K, N) i32
    kf_angle: torch.Tensor     # (K, N) f32
    kf_desc: torch.Tensor      # (K, N, 256) u8
    kf_kp_valid: torch.Tensor  # (K, N) bool
    kf_pt_idx: torch.Tensor    # (K, N) i32 map point per keypoint (-1)
    kf_ur: torch.Tensor        # (K, N) f32 right-image column (<= 0 mono)
    # --- keyframe line features ---
    kf_ln_uv: torch.Tensor     # (K, M, 2, 2)
    kf_ln_l2d: torch.Tensor    # (K, M, 3)
    kf_ln_desc: torch.Tensor   # (K, M, 256) u8
    kf_ln_valid: torch.Tensor  # (K, M) bool
    kf_ln_idx: torch.Tensor    # (K, M) i32 map line per slot (-1)
    kf_bow: torch.Tensor       # (K, N_WORDS) f32 place-recognition signature
    # --- counters ---
    n_kf: torch.Tensor         # () i32
    n_pt: torch.Tensor         # () i32
    n_ln: torch.Tensor         # () i32


FIELDS = tuple(f.name for f in dataclasses.fields(MapState))

_F32, _U8, _B, _I32 = torch.float32, torch.uint8, torch.bool, torch.int32


def field_specs(cfg: MapConfig):
    """{field: (shape, dtype)} of a map with capacities `cfg`."""
    P, L, K, N, M = cfg.max_pt, cfg.max_ln, cfg.max_kf, cfg.n_kp, cfg.n_lf
    return {
        "pt_xyz": ((P, 3), _F32), "pt_desc": ((P, 256), _U8),
        "pt_normal": ((P, 3), _F32), "pt_min_dist": ((P,), _F32),
        "pt_max_dist": ((P,), _F32), "pt_valid": ((P,), _B),
        "pt_visible": ((P,), _I32), "pt_found": ((P,), _I32),
        "pt_first_kf": ((P,), _I32), "pt_n_obs": ((P,), _I32),
        "pt_desc_acc": ((P, 256), _U8), "pt_desc_cnt": ((P,), _I32),
        "ln_xyz": ((L, 2, 3), _F32), "ln_desc": ((L, 256), _U8),
        "ln_valid": ((L,), _B), "ln_visible": ((L,), _I32),
        "ln_found": ((L,), _I32), "ln_first_kf": ((L,), _I32),
        "ln_n_obs": ((L,), _I32), "ln_cond": ((L,), _F32),
        "kf_T": ((K, 4, 4), _F32), "kf_valid": ((K,), _B),
        "kf_frame_id": ((K,), _I32), "kf_uv": ((K, N, 2), _F32),
        "kf_octave": ((K, N), _I32), "kf_angle": ((K, N), _F32),
        "kf_desc": ((K, N, 256), _U8), "kf_kp_valid": ((K, N), _B),
        "kf_pt_idx": ((K, N), _I32), "kf_ur": ((K, N), _F32),
        "kf_ln_uv": ((K, M, 2, 2), _F32), "kf_ln_l2d": ((K, M, 3), _F32),
        "kf_ln_desc": ((K, M, 256), _U8), "kf_ln_valid": ((K, M), _B),
        "kf_ln_idx": ((K, M), _I32), "kf_bow": ((K, bow.N_WORDS), _F32),
        "n_kf": ((), _I32), "n_pt": ((), _I32), "n_ln": ((), _I32),
    }


def allocate(cfg: MapConfig, device) -> MapState:
    """An empty map with capacities `cfg` on `device`."""
    t = {name: torch.zeros(shape, dtype=dtype, device=device)
         for name, (shape, dtype) in field_specs(cfg).items()}
    t["ln_cond"].fill_(1.0)
    t["kf_T"].copy_(torch.eye(4, device=device).expand_as(t["kf_T"]))
    t["kf_pt_idx"].fill_(-1)
    t["kf_ur"].fill_(-1.0)
    t["kf_ln_l2d"].copy_(torch.tensor([1.0, 0.0, -1e9], device=device)
                         .expand_as(t["kf_ln_l2d"]))
    t["kf_ln_idx"].fill_(-1)
    return MapState(**t)


def _primary_obs(ms: MapState):
    """(K, N) bool: keypoint n is a valid binding and the first occurrence
    of its point id in its row, so each shared point counts once."""
    K = ms.kf_pt_idx.shape[0]
    obs = (ms.kf_pt_idx >= 0) & ms.kf_valid[:, None]
    srt, order = torch.sort(ms.kf_pt_idx, dim=1, stable=True)
    dup = torch.cat([torch.zeros((K, 1), dtype=torch.bool,
                                 device=srt.device),
                     (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)], dim=1)
    return obs & torch.empty_like(dup).scatter_(1, order, ~dup)


def row_bitmap(rows, n: int):
    """(C, n) bool: row c is True at every id rows[c, j] >= 0."""
    C = rows.shape[0]
    bit = torch.zeros((C, n + 1), dtype=torch.bool, device=rows.device)
    bit.scatter_(1, torch.where(rows >= 0, rows, n).long(),
                 torch.ones_like(rows, dtype=torch.bool))
    return bit[:, :n]


def covis_rows(ms: MapState, ks):
    """(C, K) covisibility rows: shared-map-point counts between the
    keyframes `ks` (C,) and every keyframe (`KeyFrame::GetCovisibles`).
    Self-pairs and invalid keyframes read as 0."""
    P = ms.pt_xyz.shape[0]
    K = ms.kf_pt_idx.shape[0]
    ks = ks.long()
    bit = row_bitmap(ms.kf_pt_idx[ks], P)                  # (C, P)
    hit = (bit[:, ms.kf_pt_idx.clamp(0, P - 1).long()]
           & _primary_obs(ms)[None])                       # (C, K, N)
    w = hit.sum(-1, dtype=torch.int32)                     # (C, K)
    w = torch.where(torch.arange(K, device=w.device)[None]
                    == ks.clamp(0, K - 1)[:, None], 0, w)
    return torch.where(ms.kf_valid[ks][:, None], w, 0)


def covisibility(ms: MapState, min_weight: int = 0):
    """(K, K) covisibility weights, shared map points per keyframe pair
    (`KeyFrame::UpdateConnections`; map lines do not count), as `covis_rows`
    over chunks of keyframes so that the (C, K, N) gather stays under 2^24
    elements."""
    K, N = ms.kf_pt_idx.shape
    chunk = max(1, min(K, (1 << 24) // max(K * N, 1)))
    ks = torch.arange(K, device=ms.kf_pt_idx.device)
    W = torch.cat([covis_rows(ms, c) for c in ks.split(chunk)])
    return torch.where(W >= min_weight, W, 0) if min_weight > 0 else W


def observers_of_points(ms: MapState):
    """(K, P) bool incidence: keyframe k observes point p."""
    obs = (ms.kf_pt_idx >= 0) & ms.kf_valid[:, None] & ms.kf_kp_valid
    return row_bitmap(torch.where(obs, ms.kf_pt_idx, -1),
                      ms.pt_xyz.shape[0])


def grow(ms: MapState, cfg_new: MapConfig) -> MapState:
    """A copy of `ms` in freshly allocated arrays of the larger capacities
    `cfg_new` (double-and-pad growth; the reference's map grows on the
    heap). The new slots hold `allocate`'s empty values."""
    new = allocate(cfg_new, ms.pt_xyz.device)
    for name in FIELDS:
        src, dst = getattr(ms, name), getattr(new, name)
        dst[tuple(slice(0, n) for n in src.shape)] = src
    return new


def append_slots(counter, create_mask, capacity: int):
    """Allocate consecutive slots for masked new items.

    Returns (slot_idx (N,), ok (N,) bool, new_counter). Items beyond capacity
    are dropped (ok=False) and point at slot capacity-1."""
    offs = torch.cumsum(create_mask.to(torch.int32), 0, dtype=torch.int32) - 1
    slots = counter + offs
    ok = create_mask & (slots < capacity)
    new_counter = torch.clamp(
        counter + create_mask.sum(dtype=torch.int32), max=capacity)
    return torch.where(ok, slots, capacity - 1), ok, new_counter

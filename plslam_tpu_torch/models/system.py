"""System facade: `System(cfg).track_monocular(img, t)`.

Port of the monocular path of `plslam_tpu/models/system.py`, points and
lines. The host loop owns the `MapState` and calls the ported stages in the
JAX package's order: extraction (points, and with `use_lines` line segments)
-> two-view initialization (`match_frames`, H/F RANSAC, initial map with its
lines + local BA) -> per-frame `track_local_map` -> keyframe decision -> the
keyframe chain (`mapping.process_keyframe`), synchronously at keyframe
creation.

Host reads: a tracked frame reads back one 6-scalar row (`_resolve_pending`);
an initialization attempt reads its feature and match counts, its success
flag and, once it succeeds, the triangulated points. A frame given as a host
array is copied from pageable memory, which also waits for the device's
queue; tracking and the keyframe chain never wait. Options that need
modules not ported yet raise `NotImplementedError` naming their ROADMAP item.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from typing import Optional

import numpy as np
import torch

from ..geometry import camera, se3, triangulation
from ..mapstate import state as mstate
from ..models import mapping, tracking
from ..ops import extract, lines
from ..solvers import twoview


@dataclass
class SLAMConfig:
    """The JAX package's `SLAMConfig`, field for field, with its defaults
    (`plslam_tpu/models/system.py` documents each choice)."""
    # camera (TUM1-like defaults)
    fx: float = 517.306408
    fy: float = 516.469215
    cx: float = 318.643040
    cy: float = 255.313989
    k1: float = 0.0
    k2: float = 0.0
    p1: float = 0.0
    p2: float = 0.0
    k3: float = 0.0
    width: int = 640
    height: int = 480
    fps: float = 30.0
    # extraction
    n_features: int = 1024
    n_levels: int = 8
    scale_factor: float = 1.2
    th_fast_high: float = 20.0
    th_fast_low: float = 7.0
    subpixel: bool = False
    sel_order: str = "uniform"
    sel_cap: int = 8
    desc_pattern: str = "learned"
    level_map: int = 1
    # map capacities
    max_kf: int = 48
    max_pt: int = 12288
    max_ln: int = 1024
    n_lf: int = 256
    grow_map: bool = True
    hard_max_kf: int = 4096
    hard_max_pt: int = 65536
    hard_max_ln: int = 8192
    # policy
    min_init_matches: int = 100
    min_track_inliers: int = 10
    max_step_t: float = 0.15        # jump guard (models/tracking.py)
    max_step_r: float = 0.35
    matcher_backend: str = "xla"    # accepted; the port's searches use K1
    reloc_min_inliers: int = 50
    loop_max_drift_rot: float = 0.8
    kf_min_interval: int = 6
    kf_max_interval: int = 12
    kf_ref_ratio: float = 0.9
    ba_window: int = 8
    ba_points: int = 3072
    ba_lines: int = 256
    use_lines: bool = True
    desc_majority: bool = False
    track_line_info: float = 1.0
    use_loop_closing: bool = True
    tri_covis: bool = True
    sin_covis: bool = True
    sin_reverse_n: int = 2
    sin_whole_map: bool = False
    tri_covis_k: int = 3
    young_gba_until_kf: int = 0
    periodic_gba_every_kf: int = 0
    localization_only: bool = False
    async_pipeline: bool = False
    async_depth: int = 1
    # depth sensors
    baseline: float = 0.08
    th_depth: float = 40.0
    depth_map_factor: float = 1.0
    rgb_order: bool = True
    # line detection
    ln_detect_min_length: float = 24.0
    ln_detect_block: int = 8
    min_line_length: float = 0.0
    line_n_levels: int = 1
    line_scale: float = 1.2
    mask_path: str = ""
    sensor: str = "mono"
    seed: int = 0

    @staticmethod
    def from_yaml(path: str) -> "SLAMConfig":
        """Load the reference's YAML schema (`Examples/Monocular/TUM1.yaml`
        keys). Needs PyYAML."""
        import yaml
        with open(path) as f:
            text = f.read()
        # OpenCV FileStorage yaml has a %YAML directive line; strip it
        lines = [l for l in text.splitlines() if not l.startswith("%YAML")]
        d = yaml.safe_load("\n".join(lines)) or {}
        g = lambda k, default: d.get(k, default)
        fx = g("Camera.fx", 517.3)
        bf = float(g("Camera.bf", 0.0))
        th_depth_units = float(g("ThDepth", 40.0))
        dmf = float(g("DepthMapFactor", 1.0))
        return SLAMConfig(
            fx=fx, fy=g("Camera.fy", 516.5),
            cx=g("Camera.cx", 318.6), cy=g("Camera.cy", 255.3),
            k1=g("Camera.k1", 0.0), k2=g("Camera.k2", 0.0),
            p1=g("Camera.p1", 0.0), p2=g("Camera.p2", 0.0),
            k3=g("Camera.k3", 0.0),
            width=int(g("Camera.width", 640)),
            height=int(g("Camera.height", 480)),
            fps=g("Camera.fps", 30.0),
            rgb_order=bool(int(g("Camera.RGB", 1))),
            baseline=(bf / fx) if bf > 0 else 0.08,
            th_depth=bf * th_depth_units / fx if bf > 0 else 40.0,
            depth_map_factor=dmf if dmf > 0 else 1.0,
            # feature budgets rounded up to static-shape multiples
            n_features=-(-int(g("ORBextractor.nFeatures", 1000)) // 256) * 256,
            n_levels=int(g("ORBextractor.nLevels", 8)),
            scale_factor=g("ORBextractor.scaleFactor", 1.2),
            th_fast_high=g("ORBextractor.iniThFAST", 20.0),
            th_fast_low=g("ORBextractor.minThFAST", 7.0),
            subpixel=bool(int(g("ORBextractor.subpixel", 0))),
            n_lf=-(-int(g("LINEextractor.nFeatures", 200)) // 64) * 64,
            line_n_levels=int(g("LINEextractor.nLevels", 1)),
            line_scale=g("LINEextractor.scaleFactor", 1.2),
            min_line_length=float(g("LINEextractor.min_line_length", 0.0)),
        )


NOT_INITIALIZED = "NOT_INITIALIZED"
OK = "OK"
LOST = "LOST"

# options whose modules are not ported yet: (test, what, ROADMAP item)
_UNPORTED = (
    (lambda c: c.use_loop_closing, "use_loop_closing", 13),
    (lambda c: c.young_gba_until_kf > 0, "young_gba_until_kf (global BA)", 13),
    (lambda c: c.periodic_gba_every_kf > 0,
     "periodic_gba_every_kf (global BA)", 13),
    (lambda c: c.sensor != "mono", "sensor != 'mono'", 14),
    (lambda c: c.async_pipeline, "async_pipeline", 15),
    (lambda c: c.grow_map, "grow_map (capacity growth)", 16),
    (lambda c: c.subpixel, "subpixel (keypoint refinement)", 16),
)


def _not_ported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported to plslam_tpu_torch "
                               f"yet: ROADMAP Queue 1 item {item}")


class System:
    """Monocular point-and-line SLAM on one device. Public surface as the JAX
    package's: `track_monocular`, `trajectory`, `poses`, the TUM/KITTI
    trajectory writers, `n_map_points`, `n_keyframes`, `reset`, `flush`,
    `shutdown` and the localization-mode toggles."""

    def __init__(self, config: Optional[SLAMConfig] = None, device=None):
        config = SLAMConfig() if config is None else config
        for test, what, item in _UNPORTED:
            if test(config):
                raise _not_ported(what, item)
        self.cfg = config
        self.device = torch.device(device if device is not None else
                                   "cuda" if torch.cuda.is_available()
                                   else "cpu")
        c = config
        self.cam = camera.Camera.create(c.fx, c.fy, c.cx, c.cy, c.k1, c.k2,
                                        c.p1, c.p2, c.k3, c.width, c.height)
        self.ext_cfg = extract.ExtractorConfig(
            n_features=c.n_features, n_levels=c.n_levels,
            scale=c.scale_factor, th_fast_high=c.th_fast_high,
            th_fast_low=c.th_fast_low, level_map=c.level_map,
            sel_order=c.sel_order, desc_pattern=c.desc_pattern,
            sel_cap=c.sel_cap)
        self.map_cfg = mstate.MapConfig(
            max_kf=c.max_kf, max_pt=c.max_pt, max_ln=c.max_ln,
            n_kp=c.n_features, n_lf=c.n_lf, n_levels=c.n_levels,
            scale=c.scale_factor)
        self.scale_factors, self.sigma2 = extract.scale_factors(
            self.ext_cfg, self.device)
        self.extractor = extract.PointExtractor(
            self.ext_cfg, c.height, c.width).to(self.device)
        self.line_detector = None
        if c.use_lines:
            # the reference scales min_line_length by min(W, H); 0 keeps the
            # detector's floor
            self.line_detector = lines.LineDetector(
                c.height, c.width, n_out=c.n_lf, block=c.ln_detect_block,
                min_length=max(c.ln_detect_min_length,
                               c.min_line_length * min(c.width, c.height)),
            ).to(self.device)
        self._line_mask = None
        if c.mask_path:
            import cv2   # only this option needs OpenCV
            m = cv2.imread(c.mask_path, 0)
            if m is not None:
                self._line_mask = torch.from_numpy(
                    (m > 127).astype(np.float32)).to(self.device)

        # the stages as attributes, so that a caller can wrap one (to time
        # it, for example)
        cam = self.cam
        self._track_update = partial(
            tracking.track_local_map, cam, scale_factors=self.scale_factors,
            sigma2_levels=self.sigma2, n_levels=c.n_levels,
            scale=c.scale_factor, line_info=c.track_line_info,
            max_step_t=c.max_step_t, max_step_r=c.max_step_r,
            update_stats=True)
        self._match_frames = tracking.match_frames
        self._init_two_view = partial(twoview.initialize_two_view,
                                      K=camera.intrinsics(cam, self.device))
        self._insert_kf = partial(mapping.insert_keyframe, cam,
                                  scale_factors=self.scale_factors)
        self._create_lines = partial(mapping.create_new_lines, cam)
        self._local_ba = partial(mapping.run_local_ba, cam,
                                 sigma2_levels=self.sigma2,
                                 window=c.ba_window, p_ba=c.ba_points,
                                 l_ba=c.ba_lines)
        self._process_kf = partial(
            mapping.process_keyframe, cam, sigma2_levels=self.sigma2,
            scale_factors=self.scale_factors, window=c.ba_window,
            p_ba=c.ba_points, l_ba=c.ba_lines, max_depth=c.th_depth,
            use_depth=False, desc_majority=c.desc_majority,
            tri_covis=c.tri_covis, tri_covis_k=c.tri_covis_k,
            sin_covis=c.sin_covis, sin_whole_map=c.sin_whole_map,
            sin_reverse_n=c.sin_reverse_n)
        self.reset()

    # ------------------------------------------------------------------
    def reset(self):
        """`System::Reset`: an empty map, not initialized."""
        eye = torch.eye(4, device=self.device)
        self.ms = mstate.allocate(self.map_cfg, self.device)
        self.state = NOT_INITIALIZED
        self.velocity, self.T_last = eye, eye
        self.frame_id = -1
        self.n_kf_host = 0
        self.last_kf_frame = -1
        self.ref_kf_matches = 0
        self._init_feats = self._init_lfeats = None
        self._init_frame_id = -1
        self._init_ts = None
        # per-frame poses relative to their reference keyframe, re-anchored
        # on the current keyframe poses when read:
        # (timestamp, T_rel (4,4) tensor or array | None, ref kf, lost)
        self._traj: list[tuple] = []
        self.kf_timestamps: list[float] = []
        self.timings: list[float] = []
        self.stats: list[dict] = []

    def _extract(self, img):
        """(point features with undistorted keypoints, line features with
        undistorted endpoints or None) of one grayscale frame (uint8 on the
        wire, float32 compute)."""
        if not torch.is_tensor(img):
            img = torch.from_numpy(np.asarray(img).astype(np.uint8))
        img = img.to(self.device).to(torch.float32)
        f = self.extractor(img)
        f = f._replace(uv_un=camera.undistort_pixels(self.cam, f.uv))
        return f, self._detect_lines(img) if self.cfg.use_lines else None

    def _detect_lines(self, img):
        """Line features of a float32 frame, endpoints undistorted and the
        infinite lines recomputed from them."""
        lf = self.line_detector(img, self._line_mask)
        ua = camera.undistort_pixels(self.cam, lf.uv_a)
        ub = camera.undistort_pixels(self.cam, lf.uv_b)
        return lf._replace(uv_a=ua, uv_b=ub,
                           l2d=triangulation.line_from_endpoints_2d(ua, ub))

    # ------------------------------------------------------------------
    def track_monocular(self, img, timestamp: float):
        """Process one grayscale frame (H, W) (numpy or tensor); returns
        the (4,4) camera pose Tcw on the System's device, or None while
        not initialized (and on an auto-reset)."""
        t0 = time.perf_counter()
        self.frame_id += 1
        feats, lfeats = self._extract(img)
        if self.state == NOT_INITIALIZED:
            T = self._try_initialize(feats, lfeats, timestamp)
        else:
            T = self._track_frame(feats, lfeats, timestamp)
        self.timings.append(time.perf_counter() - t0)
        return T

    def track_chunked(self, imgs, timestamps):
        raise _not_ported("track_chunked", 15)

    def track_synced(self, img, timestamp: float):
        raise _not_ported("track_synced", 15)

    def track_stereo(self, img_left, img_right, timestamp: float):
        raise _not_ported("track_stereo", 14)

    def track_rgbd(self, img, depth, timestamp: float):
        raise _not_ported("track_rgbd", 14)

    # ------------------------------------------------------------------
    def _set_anchor(self, feats, lfeats, timestamp):
        self._init_feats, self._init_lfeats = feats, lfeats
        self._init_frame_id = self.frame_id
        self._init_ts = timestamp

    def _try_initialize(self, feats, lfeats, timestamp):
        n_valid = int(feats.valid.sum())
        if self._init_feats is None or n_valid < self.cfg.min_init_matches:
            if n_valid >= self.cfg.min_init_matches:
                self._set_anchor(feats, lfeats, timestamp)
            return None
        idx2, ok = self._match_frames(self._init_feats, feats)
        if int(ok.sum()) < self.cfg.min_init_matches:
            # too few matches: the current frame becomes the new anchor
            self._set_anchor(feats, lfeats, timestamp)
            return None
        # a fresh generator per attempt, as the JAX package reuses its key
        gen = torch.Generator().manual_seed(self.cfg.seed)
        res = self._init_two_view(gen, self._init_feats.uv_un,
                                  feats.uv_un[idx2], ok)
        if not bool(res.success):
            return None
        self._create_initial_map(feats, lfeats, idx2, res, timestamp)
        self.state = OK
        self._log_frame(timestamp, np.eye(4, dtype=np.float32), 1)
        return self.ms.kf_T[1].clone()

    def _create_initial_map(self, feats, lfeats, idx2,
                            res: twoview.TwoViewResult, timestamp):
        """`CreateInitialMapMonoWithLine`: two keyframes with their line
        segments, the triangulated points scaled to unit median depth, the
        lines triangulated between the two keyframes, then local BA."""
        good = res.good.cpu().numpy()
        X = res.X.cpu().numpy()
        med_depth = float(np.median(X[good][:, 2])) if good.any() else 1.0
        X = X / med_depth
        T2 = np.eye(4, dtype=np.float32)
        T2[:3, :3] = res.R.cpu().numpy()
        T2[:3, 3] = res.t.cpu().numpy() / med_depth

        n_new = int(good.sum())
        N = self.map_cfg.n_kp
        # map point ids 0..n_new-1 for the good matches, in slot order
        pid = np.full(N, -1, np.int32)
        pid[good] = np.arange(n_new, dtype=np.int32)
        pid2 = np.full(N, -1, np.int32)
        pid2[idx2.cpu().numpy()[good]] = pid[good]
        dev = lambda a: torch.from_numpy(a).to(self.device)
        f1, ms = self._init_feats, self.ms
        self._insert_kf(ms, f1, torch.eye(4, device=self.device), dev(pid),
                        self._init_frame_id, lfeats=self._init_lfeats)
        self._insert_kf(ms, feats, dev(T2), dev(pid2), self.frame_id,
                        lfeats=lfeats)

        # landmark geometry: insert_keyframe only binds observations
        sel = np.nonzero(good)[0]
        d = np.linalg.norm(X[sel], axis=-1)
        sf = self.scale_factors.cpu().numpy()
        max_dist = d * sf[f1.octave.cpu().numpy()[sel]]
        ids = dev(pid[sel]).long()
        ms.pt_xyz[ids] = dev(X[sel])
        ms.n_pt.fill_(n_new)
        ms.pt_min_dist[ids] = dev(max_dist / sf[-1])
        ms.pt_max_dist[ids] = dev(max_dist)
        ms.pt_normal[ids] = dev(X[sel] / np.maximum(d[:, None], 1e-6))
        ms.pt_valid[ids] = True
        ms.pt_first_kf[ids] = 0
        for name in ("pt_n_obs", "pt_visible", "pt_found"):
            getattr(ms, name)[ids] = 2
        if self.cfg.use_lines:
            self._create_lines(ms, 1, 0)
        self._local_ba(ms)

        self.T_last = ms.kf_T[1].clone()
        self.velocity = torch.eye(4, device=self.device)
        self.n_kf_host = 2
        self.last_kf_frame = self.frame_id
        self.ref_kf_matches = n_new
        self.kf_timestamps = [self._init_ts, timestamp]
        self._log_frame(self._init_ts, np.eye(4, dtype=np.float32), 0)

    # ------------------------------------------------------------------
    def _track_frame(self, feats, lfeats, timestamp):
        if self.state == LOST:
            return self._relocalize_frame(feats, timestamp)
        res, self.ms = self._track_update(self.ms, feats, self.T_last,
                                          lfeats=lfeats,
                                          velocity=self.velocity)
        self.velocity = res.velocity
        self.T_last = res.T
        self._log_frame(timestamp, res.T_rel, self.n_kf_host - 1)
        self._resolve_pending(res, feats, lfeats, timestamp)
        return res.T

    def _resolve_pending(self, res, feats, lfeats, timestamp):
        """The frame's LOST / keyframe decisions, from its one readback."""
        n_inl, n_ln_inl, n_matched, nref3, _, _ = res.scalars.tolist()
        if n_inl < self.cfg.min_track_inliers:
            self.state = LOST
            self.stats.append({"inliers": n_inl, "kf": False, "lost": True})
            return
        self.state = OK
        made_kf = False if self.cfg.localization_only else \
            self._maybe_keyframe(feats, lfeats, res, timestamp, n_inl,
                                 n_matched, nref3)
        self.stats.append({"inliers": n_inl, "kf": made_kf, "lost": False,
                           "line_inliers": n_ln_inl})

    def _relocalize_frame(self, feats, timestamp):
        # a young map is likely junk: reset instead of relocalizing
        if self.n_kf_host <= 5 and not self.cfg.localization_only:
            self.reset()
            self.stats.append({"inliers": 0, "kf": False, "lost": True,
                               "auto_reset": True})
            return None
        raise _not_ported("relocalization (LOST with more than 5 "
                          "keyframes)", 12)

    def _maybe_keyframe(self, feats, lfeats, res: tracking.TrackResult,
                        timestamp, n_inl: int, n_matched: int,
                        nref3: int) -> bool:
        """`NeedNewKeyFrame` policy: the minimum interval elapsed and the
        tracking weakened against the reference keyframe (inliers below
        kf_ref_ratio of its >= 3-observation points, or of the matches
        stored at the last keyframe while it has fewer than 30)."""
        since = self.frame_id - self.last_kf_frame
        n_kf = self.n_kf_host
        if n_kf >= self.map_cfg.max_kf - 1:
            return False
        ref_base = nref3 if nref3 >= 30 else max(self.ref_kf_matches, 15)
        weak = n_inl < self.cfg.kf_ref_ratio * ref_base
        if not (weak and n_inl > 15 and since >= self.cfg.kf_min_interval):
            return False
        self._process_kf(self.ms, feats, lfeats, res.T, res.matched_pt,
                         res.matched_ln, self.frame_id, None,
                         do_kf_cull=n_kf % 4 == 3)
        self.n_kf_host = n_kf + 1
        self.last_kf_frame = self.frame_id
        self.ref_kf_matches = n_matched
        self.kf_timestamps.append(timestamp)
        return True

    # ------------------------------------------------------------------
    def shutdown(self):
        """`System::Shutdown`: no threads to join."""

    def flush(self):
        """Nothing is deferred: every decision resolves within its frame,
        and no loop closer or global BA is ported yet."""

    def activate_localization_mode(self):
        self.cfg.localization_only = True

    def deactivate_localization_mode(self):
        self.cfg.localization_only = False

    def n_map_points(self) -> int:
        return int(self.ms.pt_valid.sum())

    def n_keyframes(self) -> int:
        return int(self.ms.n_kf)

    @property
    def trajectory(self) -> list:
        """Per-frame (timestamp, Tcw) with the poses re-anchored on the
        current keyframe poses; lost frames repeat the last recovered
        pose."""
        if not self._traj:
            return []
        kf_T = self.ms.kf_T.cpu().numpy()
        on_dev = [i for i, e in enumerate(self._traj) if torch.is_tensor(e[1])]
        rels = {i: e[1] for i, e in enumerate(self._traj)
                if isinstance(e[1], np.ndarray)}
        if on_dev:   # one batched fetch of the relative poses
            stacked = torch.stack([self._traj[i][1] for i in on_dev]).cpu()
            rels.update(zip(on_dev, stacked.numpy()))
        out, last = [], np.eye(4, dtype=np.float32)
        for i, (ts, _, ref, lost) in enumerate(self._traj):
            if i in rels and not lost:
                last = (rels[i] @ kf_T[min(ref, kf_T.shape[0] - 1)]
                        ).astype(np.float32)
            out.append((ts, last))
        return out

    def _log_frame(self, timestamp, T_rel, ref_kf: int, lost: bool = False):
        self._traj.append((timestamp, T_rel, max(ref_kf, 0), lost))

    def poses(self) -> np.ndarray:
        return np.stack([T for _, T in self.trajectory])

    def save_trajectory_tum(self, path: str):
        _write_tum(path, self.trajectory)

    def save_keyframe_trajectory_tum(self, path: str):
        kf_T = self.ms.kf_T.cpu().numpy()
        n = min(int(self.ms.n_kf), len(self.kf_timestamps))
        _write_tum(path, [(self.kf_timestamps[k], kf_T[k]) for k in range(n)])

    def save_trajectory_kitti(self, path: str):
        with open(path, "w") as f:
            for _, T in self.trajectory:
                Twc = np.linalg.inv(T)
                f.write(" ".join(f"{v:.6e}" for v in Twc[:3, :4].reshape(-1))
                        + "\n")


def _write_tum(path, items):
    """TUM lines: timestamp tx ty tz qx qy qz qw of the camera-to-world
    pose."""
    with open(path, "w") as f:
        for ts, T in items:
            Twc = np.linalg.inv(np.asarray(T))
            q = se3.rot_to_quat(torch.from_numpy(
                Twc[:3, :3].astype(np.float32))).numpy()
            t = Twc[:3, 3]
            f.write(f"{ts:.6f} {t[0]:.7f} {t[1]:.7f} {t[2]:.7f} "
                    f"{q[1]:.7f} {q[2]:.7f} {q[3]:.7f} {q[0]:.7f}\n")

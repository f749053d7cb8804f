"""System facade: `System(cfg).track_monocular(img, t)`,
`track_rgbd(img, depth, t)` and `track_stereo(img_l, img_r, t)`.

Port of `plslam_tpu/models/system.py`, points and lines, for the three
sensors. The host loop owns the `MapState` and calls the ported stages in
the JAX package's order: extraction (points, and with `use_lines` line
segments) -> initialization (monocular: `match_frames`, H/F RANSAC, initial
map with its lines + local BA; depth sensors: one keyframe at the origin
with landmarks from the keypoint depths) -> per-frame `track_local_map`
(with a depth sensor on 3-dof stereo edges; and one round of an in-flight
global BA) -> keyframe decision (with `grow_map`, capacity growth first) ->
the keyframe chain (`mapping.process_keyframe`, with a depth sensor also
creating landmarks from depth and adding stereo edges to local BA),
synchronously at keyframe creation -> loop closing (`models/loop_closing`;
Sim3s of fixed scale with a depth sensor), which schedules the asynchronous
global BA on a closure. A LOST frame relocalizes (`tracking.relocalize`)
once the map has more than 5 keyframes, and resets the map below that.

Keypoint depth comes from the depth image (`stereo.depth_at`, RGB-D) or
from matching the rectified right image (`stereo.stereo_match`, stereo). A
depth frame given to a System configured for another sensor switches it to
that sensor, as the JAX package's `_ensure_depth_sensor` does. Unlike the
JAX package, whose global BA is monocular unless the sensor was switched
this way and stays monocular after map growth, the port's global BA has
stereo edges whenever the System has a depth sensor (ROADMAP Queue 3).

Dispatch, as the JAX package's (`use_jit` there, `use_graphs` here): on
CUDA the per-frame step runs as CUDA graphs (`models/step_graph.py`), one
per program the JAX package dispatches: `track_monocular` replays the
extraction graph (points and line segments) and the tracking graph
(`track_local_map` with `update_point_stats`; it also serves the depth
sensors); `track_synced` and `track_chunked` replay one graph of extraction
and tracking per frame, `track_chunked` B of them back to back into the
chunk's stacked outputs, its decisions resolved one chunk late.
`async_pipeline` defers the per-frame decisions the same way, `async_depth`
frames per readback. The keyframe chain, initialization, relocalization,
loop closing and the global BA run eagerly.

Host reads: a tracked frame's 6 decision scalars are copied to pinned memory
without waiting and read when its decisions resolve (at once, one frame or
chunk late, or `async_depth` frames late); an initialization attempt reads
its feature and match counts, its success flag and, once it succeeds, the
triangulated points; a relocalization attempt reads its verdict; a
depth-sensor initialization reads its valid keypoint and landmark counts;
loop detection reads its candidates one keyframe late from pinned memory,
and a consistent candidate's Sim3 stage and correction read their counts
and the covisibility. A frame given as a host array goes to the device
through pinned memory without waiting; tracking, global-BA rounds and the
keyframe chain never wait. Options that need modules not ported yet raise
`NotImplementedError` naming their ROADMAP item.
"""
from __future__ import annotations

import time
from dataclasses import dataclass
from functools import partial
from types import SimpleNamespace
from typing import Optional

import numpy as np
import torch
import torch.utils._pytree as pytree

from ..geometry import camera, se3, triangulation
from ..mapstate import checkpoint, state as mstate
from ..models import mapping, step_graph, tracking
from ..models.loop_closing import LoopClosing, _to_host_async
from ..ops import extract, lines, stereo
from ..optim import local_ba
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
    (lambda c: c.subpixel, "subpixel (keypoint refinement)", 16),
)


def _not_ported(what: str, item: int):
    return NotImplementedError(f"{what} is not ported to plslam_tpu_torch "
                               f"yet: ROADMAP Queue 1 item {item}")


class System:
    """Point-and-line SLAM on one device, `cuda` unless `device` names
    another (the CPU runs the kernels' plain versions). Public surface as
    the JAX package's: `track_monocular`, `track_synced`, `track_chunked`,
    `track_rgbd`, `track_stereo`, `trajectory`, `poses`, the TUM/KITTI
    trajectory writers, `n_map_points`, `n_keyframes`, `reset`, `flush`,
    `finish_gba`, `run_global_ba`, `shutdown`, the localization-mode
    toggles and the map I/O (`save_map`, `load_map`, `save_point_cloud`).
    On CUDA the per-frame steps replay as CUDA graphs unless
    `use_graphs` is False (the JAX package's `use_jit`); `graphs` holds
    their counts."""

    def __init__(self, config: Optional[SLAMConfig] = None, device=None,
                 use_graphs: bool = True):
        config = SLAMConfig() if config is None else config
        for test, what, item in _UNPORTED:
            if test(config):
                raise _not_ported(what, item)
        self.cfg = config
        self.device = torch.device("cuda" if device is None else device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("System needs a CUDA device; pass "
                               "device='cpu' for the kernels' plain versions")
        c = config
        # fx * baseline (the reference's mbf): the stereo edges' scale
        self._bf = float(c.fx) * float(c.baseline)
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
        # it, for example); the per-frame steps are graphed, and a wrapper
        # that synchronizes goes around them, never inside
        cam = self.cam
        self._track_impl = partial(
            _track_and_update, cam, scale_factors=self.scale_factors,
            sigma2_levels=self.sigma2, n_levels=c.n_levels,
            scale=c.scale_factor, line_info=c.track_line_info,
            max_step_t=c.max_step_t, max_step_r=c.max_step_r)
        self.graphs = step_graph.StepGraphs(self.device, enabled=use_graphs)
        self._extract_step = self.graphs.step(self._extract_impl)
        self._track_update = self.graphs.step(self._track_impl, bound=0)
        self._frame_step = self.graphs.step(self._frame_impl, bound=0)
        self._match_frames = tracking.match_frames
        self._init_two_view = partial(twoview.initialize_two_view,
                                      K=camera.intrinsics(cam, self.device))
        self._insert_kf = partial(mapping.insert_keyframe, cam,
                                  scale_factors=self.scale_factors,
                                  bf=self._bf)
        self._create_lines = partial(mapping.create_new_lines, cam)
        self._local_ba = partial(mapping.run_local_ba, cam,
                                 sigma2_levels=self.sigma2,
                                 window=c.ba_window, p_ba=c.ba_points,
                                 l_ba=c.ba_lines)
        self._process_kf = partial(
            mapping.process_keyframe, cam, sigma2_levels=self.sigma2,
            scale_factors=self.scale_factors, window=c.ba_window,
            p_ba=c.ba_points, l_ba=c.ba_lines, max_depth=c.th_depth,
            bf=self._bf, desc_majority=c.desc_majority,
            tri_covis=c.tri_covis, tri_covis_k=c.tri_covis_k,
            sin_covis=c.sin_covis, sin_whole_map=c.sin_whole_map,
            sin_reverse_n=c.sin_reverse_n)
        self._relocalize = partial(
            tracking.relocalize, cam, sigma2_levels=self.sigma2,
            scale_factors=self.scale_factors, n_levels=c.n_levels,
            scale=c.scale_factor, min_inliers=c.reloc_min_inliers)
        self._depth_at = stereo.depth_at
        self._stereo_match = partial(stereo.stereo_match, fx=float(c.fx),
                                     baseline=c.baseline,
                                     scale_factors=self.scale_factors)
        self._create_depth_points = partial(
            mapping.create_points_from_depth, cam,
            scale_factors=self.scale_factors, max_depth=c.th_depth)
        # a depth sensor observes scale: Sim3s keep s = 1 (`bFixScale`)
        self.loop_closer = LoopClosing(
            cam, self.map_cfg, self.sigma2, fix_scale=c.sensor != "mono",
            max_drift_rot=c.loop_max_drift_rot) if c.use_loop_closing \
            else None
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
        self.last_reloc_frame = -10**9
        self.ref_kf_matches = 0
        # the local-map anchor after a relocalization (its keyframe), until
        # the next keyframe; None = the latest keyframe
        self._anchor_kf = None
        self._anchor_t = None      # (keyframe, its 0-d tensor)
        # tracked frames and chunks whose decisions are not resolved yet
        self._pending: list[tuple] = []
        self._chunk_pending: list[tuple] = []
        self._occupancy = (0, 0)   # (n_pt, n_ln) of the last readback
        self.n_growths = 0
        self._gba = None           # the in-flight global BA
        self.n_gba_done = 0
        self._init_feats = self._init_lfeats = None
        # the current frame's keypoint depths and right-image columns (a
        # depth sensor's frame), else None
        self._kp_depth = self._kp_ur = None
        self._init_frame_id = -1
        self._init_ts = None
        # per-frame poses relative to their reference keyframe, re-anchored
        # on the current keyframe poses when read:
        # (timestamp, T_rel (4,4) tensor or array | None, ref kf, lost)
        self._traj: list[tuple] = []
        self.kf_timestamps: list[float] = []
        self.timings: list[float] = []
        self.stats: list[dict] = []

    def _image(self, img):
        """Grayscale frames (numpy or tensor; numpy as uint8, as they
        travel) on the device. A host frame goes through pinned memory, so
        its copy does not wait for the device."""
        if not torch.is_tensor(img):
            img = torch.from_numpy(np.asarray(img).astype(np.uint8))
        if img.device == self.device or self.device.type != "cuda":
            return img.to(self.device)
        host = torch.empty(img.shape, dtype=img.dtype, pin_memory=True)
        host.copy_(img)
        return host.to(self.device, non_blocking=True)

    def _extract(self, img, with_lines: bool = True):
        """(point features with undistorted keypoints, line features with
        undistorted endpoints or None) of one grayscale frame; lines only
        with `use_lines` and `with_lines`. One graph on CUDA."""
        return self._extract_step(self._image(img), with_lines=with_lines)

    def _extract_impl(self, img, with_lines: bool = True):
        img = img.to(torch.float32)
        f = self.extractor(img)
        f = f._replace(uv_un=camera.undistort_pixels(self.cam, f.uv))
        return f, self._detect_lines(img) if self.cfg.use_lines \
            and with_lines else None

    def _frame_impl(self, ms, img, T_last, velocity, anchor_kf):
        """Extraction and tracking of one frame: (TrackResult, point
        features, line features or None)."""
        feats, lfeats = self._extract_impl(img)
        res = self._track_impl(ms, feats, T_last, lfeats=lfeats,
                               velocity=velocity, anchor_kf=anchor_kf)
        return res, feats, lfeats

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

    def track_synced(self, img, timestamp: float):
        """The live-camera path: one frame in, its pose out, its keyframe
        and LOST decisions resolved before returning. Extraction and
        tracking run as one graph (the B = 1 case of `track_chunked`) and
        the decision scalars are read back at once; while not OK it is
        `track_monocular`."""
        if self.state != OK:
            return self.track_monocular(img, timestamp)
        t0 = time.perf_counter()
        out = self.track_chunked(self._image(img)[None], [timestamp])
        self._resolve_chunks(keep=0)
        if self.timings:
            self.timings[-1] = time.perf_counter() - t0
        return out[0]

    def track_chunked(self, imgs, timestamps):
        """A block of consecutive frames (B, H, W) (numpy uint8 or tensor)
        with their B timestamps: B replays of the extraction and tracking
        graph back to back, each frame tracked from the previous one's pose
        and velocity on the map as the previous one left it, its outputs
        stacked into the chunk's buffers; one global-BA round per chunk.
        The keyframe and LOST decisions are read back one chunk late (the
        bounded lag of `async_pipeline`, over a block). Falls back to
        `track_monocular` per frame while not initialized or lost.

        Returns the (B, 4, 4) poses as a tensor on the fast path, a list of
        per-frame results on the fallback path."""
        B = int(imgs.shape[0])
        if self.state != OK:
            return [self.track_monocular(imgs[j], timestamps[j])
                    for j in range(B)]
        imgs = self._image(imgs)
        t0 = time.perf_counter()
        ids = [self.frame_id + 1 + j for j in range(B)]
        self.frame_id += B
        Ts, T_rels, scalars, m_pt, m_ln, feats_s, lfeats_s = \
            self._track_chunk(imgs)
        self._step_gba()
        ref = self.n_kf_host - 1
        traj_start = len(self._traj)
        for j, ts in enumerate(timestamps):
            self._log_frame(ts, T_rels[j], ref)
        self._chunk_pending.append(
            (_to_host_async(scalars), Ts, m_pt, m_ln, feats_s, lfeats_s,
             list(timestamps), ids, traj_start))
        if len(self._chunk_pending) > 1:
            self._resolve_chunks(keep=1)
        dt = (time.perf_counter() - t0) / B
        self.timings.extend([dt] * B)
        return Ts

    def _track_chunk(self, imgs):
        """The chunk's frames through `_frame_step`, each replay's outputs
        copied into the chunk's stacks before the next: (Ts, T_rels,
        scalars, matched_pt, matched_ln, point features, line features),
        each stacked over the B frames. Sets T_last and the velocity to
        the last frame's."""
        B = int(imgs.shape[0])
        T, vel, anchor = self.T_last, self.velocity, self._anchor_arg()
        stacks = None
        for j in range(B):
            res, f, lf = self._frame_step(self.ms, imgs[j], T, vel, anchor,
                                          clone=False)
            out = (res.T, res.T_rel, res.scalars, res.matched_pt,
                   res.matched_ln, f, lf)
            if stacks is None:
                stacks = pytree.tree_map_only(
                    torch.Tensor, lambda t: t.new_empty((B,) + t.shape), out)
            for dst, src in zip(step_graph.tensors_of(stacks),
                                step_graph.tensors_of(out)):
                dst[j].copy_(src)
            T, vel = stacks[0][j], res.velocity
        self.T_last, self.velocity = T, vel.clone()
        return stacks

    def _resolve_chunks(self, keep: int = 0):
        """The decisions of all but the `keep` newest chunks, frame by frame
        under each frame's own id, from one readback per chunk, through
        `_resolve_frame` with the cheap keyframe pre-gate."""
        while len(self._chunk_pending) > keep:
            (((host,), event), Ts, m_pt, m_ln, feats_s, lfeats_s, tss, ids,
             traj_start) = self._chunk_pending.pop(0)
            if event is not None:
                event.synchronize()
            saved_fid = self.frame_id
            for j, row in enumerate(host.tolist()):
                self.frame_id = ids[j]
                pick = partial(pytree.tree_map_only, torch.Tensor,
                               lambda t, j=j: t[j])
                res_j = SimpleNamespace(T=Ts[j], matched_pt=m_pt[j],
                                        matched_ln=m_ln[j])
                self._resolve_frame(row, res_j, pick(feats_s),
                                    pick(lfeats_s), tss[j],
                                    traj_i=traj_start + j, pregate=True)
            self.frame_id = saved_fid

    def track_rgbd(self, img, depth, timestamp: float):
        """`System::TrackRGBD`: one grayscale frame and its registered depth
        image (H, W), in the units of `depth_map_factor` (numpy or tensor).
        Metric depth initializes on the first frame with enough keypoints
        and creates landmarks directly. Returns the (4,4) pose Tcw on the
        System's device, or None while not initialized."""
        t0 = time.perf_counter()
        self.frame_id += 1
        self._ensure_depth_sensor("rgbd")
        if not torch.is_tensor(depth):
            depth = torch.from_numpy(np.asarray(depth, dtype=np.float32))
        depth = depth.to(self.device).to(torch.float32) \
            / self.cfg.depth_map_factor
        feats, lfeats = self._extract(img)
        self._set_depth(feats, self._depth_at(depth, feats.uv))
        T = self._track_depth_frame(feats, lfeats, timestamp)
        self.timings.append(time.perf_counter() - t0)
        return T

    def track_stereo(self, img_left, img_right, timestamp: float):
        """`System::TrackStereo`: a rectified grayscale pair. Keypoint depth
        comes from `stereo.stereo_match` against the right image's
        keypoints (points only: the JAX package's right-image lines are
        discarded unused). Returns as `track_rgbd`."""
        t0 = time.perf_counter()
        self.frame_id += 1
        self._ensure_depth_sensor("stereo")
        im_l, im_r = self._image(img_left), self._image(img_right)
        feats, lfeats = self._extract(im_l)
        feats_r, _ = self._extract(im_r, with_lines=False)
        d, _, ok = self._stereo_match(feats, feats_r,
                                      im_l.to(torch.float32),
                                      im_r.to(torch.float32))
        self._set_depth(feats, torch.where(ok, d, -1.0))
        T = self._track_depth_frame(feats, lfeats, timestamp)
        self.timings.append(time.perf_counter() - t0)
        return T

    def _set_depth(self, feats, kp_depth):
        """The frame's keypoint depths and their right-image columns."""
        self._kp_depth = kp_depth
        self._kp_ur = stereo.right_columns(feats, kp_depth, self._bf)

    def _track_depth_frame(self, feats, lfeats, timestamp):
        if self.state == NOT_INITIALIZED:
            return self._initialize_with_depth(feats, lfeats, timestamp)
        return self._track_frame(feats, lfeats, timestamp)

    def _ensure_depth_sensor(self, sensor: str):
        """A depth frame given to a System configured for another sensor
        switches it to `sensor`: the loop closer's Sim3s keep s = 1
        (`bFixScale`), and the global BA gets stereo edges
        (`_gba_kwargs`)."""
        if self.cfg.sensor != sensor:
            self.cfg.sensor = sensor
            if self.loop_closer is not None:
                self.loop_closer.fix_scale = True

    def _initialize_with_depth(self, feats, lfeats, timestamp):
        """`Tracking::StereoInitialization`: with >= 300 valid keypoints,
        one keyframe at the origin and landmarks straight from depth."""
        if int(feats.valid.sum()) < 300:
            return None
        eye = torch.eye(4, device=self.device)
        ms = self.ms
        self._insert_kf(ms, feats, eye,
                        torch.full((self.map_cfg.n_kp,), -1,
                                   dtype=torch.int32, device=self.device),
                        self.frame_id, lfeats=lfeats,
                        kp_depth=self._kp_depth)
        self._create_depth_points(ms, 0, self._kp_depth)
        self.n_kf_host = 1
        self.state = OK
        self.T_last, self.velocity = eye, eye
        self.last_kf_frame = self.frame_id
        self.ref_kf_matches = int((ms.kf_pt_idx[0] >= 0).sum())
        self.kf_timestamps = [timestamp]
        self._log_frame(timestamp, np.eye(4, dtype=np.float32), 0)
        return eye.clone()

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
        stereo_kw = {} if self._kp_ur is None else dict(kp_ur=self._kp_ur,
                                                        bf=self._bf)
        res = self._track_update(self.ms, feats, self.T_last, lfeats=lfeats,
                                 velocity=self.velocity,
                                 anchor_kf=self._anchor_arg(), **stereo_kw)
        self._step_gba()
        self.velocity = res.velocity
        self.T_last = res.T
        self._log_frame(timestamp, res.T_rel, self.n_kf_host - 1)
        # the decision scalars start for the host now; they are read when
        # the frame resolves: at once, or `async_depth` frames late
        self._pending.append((res, feats, lfeats, timestamp, self._kp_depth,
                              _to_host_async(res.scalars)))
        if not self.cfg.async_pipeline:
            self._resolve_pending()
        elif len(self._pending) > self.cfg.async_depth:
            self._resolve_pending(keep=1)
        return res.T

    def _resolve_pending(self, keep: int = 0):
        """The LOST / keyframe decisions of all but the `keep` newest
        tracked frames, in order, each from its scalars' copy through
        `_resolve_frame` (a keyframe is made from the frame's own features
        and depths)."""
        batch, self._pending = (self._pending[:len(self._pending) - keep],
                                self._pending[len(self._pending) - keep:])
        kp_depth_now = self._kp_depth
        for res, feats, lfeats, timestamp, kp_depth, ((host,), event) in batch:
            if event is not None:
                event.synchronize()
            self._kp_depth = kp_depth
            self._resolve_frame(host.tolist(), res, feats, lfeats, timestamp)
        self._kp_depth = kp_depth_now

    def _resolve_frame(self, row, res, feats, lfeats, timestamp,
                       traj_i: Optional[int] = None, pregate: bool = False):
        """One tracked frame's decisions from its six scalars `row`: LOST
        below `min_track_inliers` (marking the trajectory entry `traj_i`
        lost: a chunk's later poses are not trusted, the export repeats the
        last good pose), else OK and maybe a keyframe. With `pregate`,
        `_maybe_keyframe` is called only when the host-side pre-gate (the
        cadence and the weakening test) passes, as the JAX package's chunk
        resolution does."""
        n_inl, n_ln_inl, n_matched, nref3, n_pt, n_ln = row
        self._occupancy = (n_pt, n_ln)
        if n_inl < self.cfg.min_track_inliers:
            self.state = LOST
            if traj_i is not None:
                ts_e, _, ref_e, _ = self._traj[traj_i]
                self._traj[traj_i] = (ts_e, None, ref_e, True)
            self.stats.append({"inliers": n_inl, "kf": False, "lost": True})
            return
        self.state = OK
        made_kf = False
        if not self.cfg.localization_only:
            ref_base = nref3 if nref3 >= 30 else max(self.ref_kf_matches, 15)
            if not pregate or (
                    n_inl < self.cfg.kf_ref_ratio * ref_base and n_inl > 15
                    and self.frame_id - self.last_kf_frame
                    >= self.cfg.kf_min_interval):
                made_kf = self._maybe_keyframe(feats, lfeats, res, timestamp,
                                               n_inl, n_matched, nref3)
        self.stats.append({"inliers": n_inl, "kf": made_kf, "lost": False,
                           "line_inliers": n_ln_inl})

    def _anchor_arg(self):
        """The local-map anchor for tracking: None (the latest keyframe) or
        the keyframe the last relocalization landed in, as a 0-d tensor
        made once per anchor."""
        if self._anchor_kf is None:
            return None
        if self._anchor_t is None or self._anchor_t[0] != self._anchor_kf:
            self._anchor_t = (self._anchor_kf, torch.full(
                (), self._anchor_kf, dtype=torch.long, device=self.device))
        return self._anchor_t[1]

    def _relocalize_frame(self, feats, timestamp):
        """A LOST frame: on a map of at most 5 keyframes (likely junk) the
        map resets; otherwise `relocalize` (minimal sets from a generator
        seeded with seed + frame id), which on success sets the pose, the
        local-map anchor and the no-keyframe window; else the pose coasts on
        the motion model and the frame is exported as the last good one."""
        if self.n_kf_host <= 5 and not self.cfg.localization_only:
            self.reset()
            self.stats.append({"inliers": 0, "kf": False, "lost": True,
                               "auto_reset": True})
            return None
        gen = torch.Generator().manual_seed(self.cfg.seed + self.frame_id)
        rok, rT, rn, ranchor = self._relocalize(self.ms, feats,
                                                generator=gen)
        if bool(rok):
            self.state = OK
            self.velocity = torch.eye(4, device=self.device)
            self.T_last = rT
            self.last_reloc_frame = self.frame_id
            self._anchor_kf = int(ranchor)
            ref = self.n_kf_host - 1
            self._log_frame(timestamp,
                            rT @ se3.se3_inv(self.ms.kf_T[max(ref, 0)]), ref)
            self.stats.append({"inliers": int(rn), "kf": False,
                               "lost": False, "reloc": True})
            return rT
        T = self.velocity @ self.T_last   # dead reckoning, not exported
        self._log_frame(timestamp, None, self.n_kf_host - 1, lost=True)
        self.T_last = T
        self.stats.append({"inliers": 0, "kf": False, "lost": True})
        return T

    # ------------------------------------------------------------------
    # The asynchronous global BA (`RunGlobalBundleAdjustment` in its own
    # thread, aborted by `mbStopGBA`): its LM runs in rounds, one per
    # tracked frame, queued behind the frame's work; a new closure aborts it.
    def _gba_kwargs(self):
        """The global-BA window and budgets: the map's capacities, capped
        (the dense reduced camera system grows as K^2 P); stereo edges
        whenever the System has a depth sensor, whether the config said so
        or a depth frame switched it, and after growth too."""
        c = self.map_cfg
        return dict(window=min(c.max_kf, 128), p_ba=min(c.max_pt, 16384),
                    l_ba=min(c.max_ln, 1024), rank_by_obs=True,
                    use_stereo=self.cfg.sensor != "mono" and self._bf > 0,
                    bf=self._bf)

    def _start_gba(self, n_rounds: int = 4):
        """Select the whole map and start a global BA of `n_rounds` rounds
        of 3 LM iterations, with the chi2 demotion after the first (4 after
        a closure, as the essential graph has already moved the map)."""
        sel = mapping.ba_select(self.ms, self.sigma2, **self._gba_kwargs())
        self._gba = {"sel": sel, "st": local_ba.ba_init(sel.prob, self.cam),
                     "kf_T_old": self.ms.kf_T.clone(),
                     "start_kf": self.n_kf_host, "round": 0,
                     "n_rounds": n_rounds}

    def _abort_gba(self):
        self._gba = None

    def _step_gba(self):
        """One round of the in-flight global BA; after the last, merge it
        into the map and carry the latest keyframe's correction over to the
        tracking pose."""
        g = self._gba
        if g is None:
            return
        prob = g["sel"].prob
        g["st"] = local_ba.ba_rounds(prob, self.cam, g["st"], 3, robust=True)
        g["round"] += 1
        if g["round"] == 1:
            g["st"] = local_ba.ba_demote(prob, self.cam, g["st"])
        if g["round"] < g["n_rounds"]:
            return
        res = local_ba.ba_finalize(prob, self.cam, g["st"])
        k_last = self.n_kf_host - 1
        T_ref_before = self.ms.kf_T[k_last].clone() if k_last >= 0 else None
        mapping.gba_merge(self.ms, g["sel"], res, g["kf_T_old"],
                          g["start_kf"])
        if k_last >= 0:
            self.T_last = (self.T_last @ se3.se3_inv(T_ref_before)
                           @ self.ms.kf_T[k_last])
        self._gba = None
        self.n_gba_done += 1

    def finish_gba(self):
        """Run the in-flight global BA to its end."""
        while self._gba is not None:
            self._step_gba()

    def run_global_ba(self):
        """A synchronous full-map BA (`GlobalBundleAdjustemnt`)."""
        mapping.run_local_ba(self.cam, self.ms, self.sigma2,
                             **self._gba_kwargs())
        self._reanchor(self.n_kf_host - 1)

    def _reanchor(self, k: int):
        """Tracking restarts from keyframe k's pose with no motion."""
        if k >= 0:
            self.T_last = self.ms.kf_T[k].clone()
            self.velocity = torch.eye(4, device=self.device)

    def _loop_closed(self, k: int):
        """After a loop correction: track on from keyframe k and start a
        global BA, aborting any in flight."""
        self._reanchor(k)
        self._abort_gba()
        self._start_gba()

    def _maybe_grow(self):
        """Double-and-pad capacity growth, from the occupancy of the last
        readback, with the margins of the worst keyframe: keyframes when 2
        slots remain, points below 3 x n_kp free slots, lines below 4 x
        n_lf, each up to its `hard_max_*` ceiling. The global BA's budgets
        and the loop closer follow the new capacities."""
        n_pt, n_ln = self._occupancy
        c, cfg = self.map_cfg, self.cfg
        new_kf, new_pt, new_ln = c.max_kf, c.max_pt, c.max_ln
        if self.n_kf_host >= c.max_kf - 2 and c.max_kf < cfg.hard_max_kf:
            new_kf = min(2 * c.max_kf, cfg.hard_max_kf)
        if n_pt >= c.max_pt - 3 * c.n_kp and c.max_pt < cfg.hard_max_pt:
            new_pt = min(2 * c.max_pt, cfg.hard_max_pt)
        if n_ln >= c.max_ln - 4 * c.n_lf and c.max_ln < cfg.hard_max_ln:
            new_ln = min(2 * c.max_ln, cfg.hard_max_ln)
        if (new_kf, new_pt, new_ln) == (c.max_kf, c.max_pt, c.max_ln):
            return
        self.map_cfg = c._replace(max_kf=new_kf, max_pt=new_pt, max_ln=new_ln)
        self.ms = mstate.grow(self.ms, self.map_cfg)
        self.n_growths += 1
        if self.loop_closer is not None:
            self.loop_closer.map_cfg = self.map_cfg

    def _maybe_keyframe(self, feats, lfeats, res: tracking.TrackResult,
                        timestamp, n_inl: int, n_matched: int,
                        nref3: int) -> bool:
        """`NeedNewKeyFrame` policy: the minimum interval elapsed (1 frame
        on a depth sensor's frames, which create landmarks without a
        baseline; else `kf_min_interval`) and the tracking weakened against
        the reference keyframe (inliers below kf_ref_ratio of its >= 3-
        observation points, or of the matches stored at the last keyframe
        while it has fewer than 30)."""
        since = self.frame_id - self.last_kf_frame
        n_kf = self.n_kf_host
        # none right after a relocalization: the statistics gathered while
        # lost are unreliable
        if self.frame_id - self.last_reloc_frame < 2 * self.cfg.kf_max_interval:
            return False
        if self.cfg.grow_map:
            self._maybe_grow()
        if n_kf >= self.map_cfg.max_kf - 1:
            return False
        ref_base = nref3 if nref3 >= 30 else max(self.ref_kf_matches, 15)
        weak = n_inl < self.cfg.kf_ref_ratio * ref_base
        use_depth = self._kp_depth is not None
        min_iv = 1 if use_depth else self.cfg.kf_min_interval
        if not (weak and n_inl > 15 and since >= min_iv):
            return False
        self._process_kf(self.ms, feats, lfeats, res.T, res.matched_pt,
                         res.matched_ln, self.frame_id, self._kp_depth,
                         do_kf_cull=n_kf % 4 == 3, use_depth=use_depth)
        self.n_kf_host = n_kf + 1
        self._anchor_kf = None
        if self.loop_closer is not None:
            self.ms, closed = self.loop_closer.process_keyframe(
                self.ms, n_kf, seed=self.cfg.seed)
            if closed:
                self._loop_closed(n_kf)
        if (self._gba is None and self.cfg.young_gba_until_kf > 0
                and 2 < n_kf + 1 <= self.cfg.young_gba_until_kf):
            self.run_global_ba()      # young map: synchronous, whole map
        if (self._gba is None and self.cfg.periodic_gba_every_kf > 0
                and (n_kf + 1) % self.cfg.periodic_gba_every_kf == 0
                and n_kf + 1 > self.cfg.ba_window):
            self._start_gba(n_rounds=10)
        self.last_kf_frame = self.frame_id
        self.ref_kf_matches = n_matched
        self.kf_timestamps.append(timestamp)
        return True

    # ------------------------------------------------------------------
    def shutdown(self):
        """`System::Shutdown`: no threads to join."""

    def flush(self):
        """Resolve the deferred per-frame and per-chunk decisions and the
        pending (one keyframe late) loop detection, and run any in-flight
        global BA to its end."""
        self._resolve_pending(keep=0)
        self._resolve_chunks(keep=0)
        if self.loop_closer is not None and self.n_kf_host > 0:
            self.ms, closed = self.loop_closer.finish(self.ms,
                                                      seed=self.cfg.seed)
            if closed:
                self._loop_closed(self.n_kf_host - 1)
        self.finish_gba()

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

    def save_map(self, path: str):
        """Map checkpoint (the JAX package's npz, field for field)."""
        checkpoint.save_map(self.ms, path)

    def load_map(self, path: str):
        """Bind the map of a checkpoint (either package's). The graphs
        capture anew on it, and the host copies of its counts follow it:
        the keyframe count, the capacities (the loop closer's too) and the
        occupancy that growth reads. The JAX package's `load_map` sets the
        map alone (ROADMAP Queue 3). The tracking state (pose, velocity,
        NOT_INITIALIZED / OK) is left as it was."""
        ms = checkpoint.load_map(path, self.device)
        self.ms = ms
        K, N = ms.kf_pt_idx.shape
        self.map_cfg = self.map_cfg._replace(
            max_kf=K, max_pt=ms.pt_xyz.shape[0], max_ln=ms.ln_valid.shape[0],
            n_kp=N, n_lf=ms.kf_ln_idx.shape[1])
        if self.loop_closer is not None:
            self.loop_closer.map_cfg = self.map_cfg
        self.n_kf_host = int(ms.n_kf)
        self._occupancy = (int(ms.n_pt), int(ms.n_ln))

    def save_point_cloud(self, path: str):
        """`System::SavePointCloud`: ASCII PLY of the valid map points."""
        checkpoint.save_point_cloud(self.ms, path)

    def save_trajectory_kitti(self, path: str):
        with open(path, "w") as f:
            for _, T in self.trajectory:
                Twc = np.linalg.inv(T)
                f.write(" ".join(f"{v:.6e}" for v in Twc[:3, :4].reshape(-1))
                        + "\n")


def _track_and_update(cam, ms, feats, T_last, **kwargs):
    """`track_local_map` with the map's found / visible counts updated in
    place; returns the TrackResult."""
    return tracking.track_local_map(cam, ms, feats, T_last,
                                    update_stats=True, **kwargs)[0]


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

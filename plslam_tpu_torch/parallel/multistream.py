"""Multi-stream SLAM on one card: the offline-mapping throughput mode (BASELINE
config 5: many TUM/EuRoC streams per device).

Port of `plslam_tpu/parallel/multistream.py`.

`BatchedTracker` tracks S streams in lockstep, one map per stream: the
per-frame step (extraction, line detection, `track_local_map` with its
statistics update) is `torch.func.vmap`ed over a leading stream axis and
replayed as a CUDA graph (`models/step_graph`), bound to the stacked
`MapState`, whose storage the graph updates in place (the JAX package
donates the map for the same effect). So the step keeps one stream's
kernel count with each kernel S times wider, and K1 is one launch per
batched search. The keyframe cadence is a host decision shared by all
streams, so there are captured steps for track and for track + keyframe
chain. The JAX `lax.cond(n_kf < max_kf - 1, ...)` is decided on the host
from per-stream keyframe counts: while every stream has a free keyframe
slot the chain runs on all of them; once one has none, a third step runs
the chain on every stream and gives such a stream its map back as it was.
With a `mesh` (`parallel/mesh.py`, one process per rank) each rank tracks
its contiguous share of the streams through its own graphed step on its
device; `step` takes every stream's frame, uploads only the rank's, and
returns every stream's pose and scalars on every rank (an all-reduce after
the replay, outside the graphs), as the JAX package's global arrays read.

`RoundRobinTracker` time-multiplexes S streams through one `System`'s
graphed chunk step. Each stream's map is copied into the System's bound map
before its chunk and back out after it (device-to-device), so the graphs
are captured once and replayed for every stream.
"""
from __future__ import annotations

from functools import partial

import numpy as np
import torch

from ..geometry import camera
from ..mapstate import state as mstate
from ..models import mapping, step_graph, tracking
from ..ops import extract, lines
from . import streams


def _device(device) -> torch.device:
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the multi-stream trackers need a CUDA device; "
                           "pass device='cpu' for the kernels' plain "
                           "versions")
    return device


def copy_map(dst: mstate.MapState, src: mstate.MapState):
    """Every field of `src` into `dst`'s storage (the same capacities)."""
    for f in mstate.FIELDS:
        getattr(dst, f).copy_(getattr(src, f))


class BatchedTracker:
    """Lockstep tracker over S streams, one map per stream, on one device
    (`cuda` unless `device` names another) or sharded over the ranks of a
    `mesh` (each on the mesh's device, S divisible by the world size).
    `step(imgs)` tracks every stream one frame and runs the keyframe chain
    on every `kf_interval`-th frame (the first included); with
    `use_graphs` (on CUDA) both steps replay as CUDA graphs."""

    def __init__(self, config, n_streams: int, kf_interval: int = 5,
                 device=None, use_graphs: bool = True, mesh=None):
        self.cfg = c = config
        self.S = n_streams
        self.kf_interval = kf_interval
        self.mesh = mesh
        if mesh is None:
            self.device, self.stream_range = _device(device), (0, n_streams)
        else:
            if device is not None or n_streams % mesh.world:
                raise ValueError(f"a mesh tracker runs on the mesh's device, "
                                 f"its {n_streams} streams divisible by "
                                 f"{mesh.world} ranks")
            self.device = mesh.device
            self.stream_range = streams.share(mesh, n_streams)
        self.S_local = self.stream_range[1] - self.stream_range[0]
        self.cam = camera.Camera.create(c.fx, c.fy, c.cx, c.cy, c.k1, c.k2,
                                        c.p1, c.p2, c.k3, c.width, c.height)
        # the JAX BatchedTracker's extractor: the config's budgets and
        # thresholds, the extractor's own defaults otherwise
        self.ext_cfg = extract.ExtractorConfig(
            n_features=c.n_features, n_levels=c.n_levels,
            scale=c.scale_factor, th_fast_high=c.th_fast_high,
            th_fast_low=c.th_fast_low)
        self.map_cfg = mstate.MapConfig(
            max_kf=c.max_kf, max_pt=c.max_pt, max_ln=c.max_ln,
            n_kp=c.n_features, n_lf=c.n_lf, n_levels=c.n_levels,
            scale=c.scale_factor)
        self.scale_factors, self.sigma2 = extract.scale_factors(
            self.ext_cfg, self.device)
        self.extractor = extract.PointExtractor(
            self.ext_cfg, c.height, c.width).to(self.device)
        self.line_detector = lines.LineDetector(
            c.height, c.width, n_out=c.n_lf).to(self.device) \
            if c.use_lines else None
        self.graphs = step_graph.StepGraphs(self.device, enabled=use_graphs)
        # track, track + keyframe chain, and the chain with a per-stream
        # mask of the streams that have a free keyframe slot
        self._steps = {kind: self.graphs.step(
            partial(self._batched_step, with_kf=kind != "track"), bound=0)
            for kind in ("track", "kf", "kf_masked")}
        self.reset()

    def _stream_step(self, ms, img, T_last, velocity, frame_id, room=None,
                     with_kf: bool = False):
        """One stream's frame (under vmap): extraction, line detection,
        tracking with the statistics update, and with `with_kf` the
        keyframe chain; a `room` of False gives the stream its map back as
        it was before the chain. Returns (T, velocity, scalars)."""
        c = self.cfg
        img = img.to(torch.float32)
        feats = self.extractor(img)
        feats = feats._replace(uv_un=camera.undistort_pixels(self.cam,
                                                             feats.uv))
        lf = self.line_detector(img) if c.use_lines else None
        res, ms = tracking.track_local_map(
            self.cam, ms, feats, T_last, scale_factors=self.scale_factors,
            sigma2_levels=self.sigma2, lfeats=lf, n_levels=c.n_levels,
            scale=c.scale_factor, line_info=c.track_line_info,
            velocity=velocity, update_stats=True)
        if with_kf:
            before = None if room is None else [
                getattr(ms, f).clone() for f in mstate.FIELDS]
            mapping.process_keyframe(
                self.cam, ms, feats, lf, res.T, res.matched_pt,
                res.matched_ln, frame_id,
                torch.zeros(c.n_features, device=img.device),
                sigma2_levels=self.sigma2, scale_factors=self.scale_factors,
                window=c.ba_window, p_ba=c.ba_points, l_ba=c.ba_lines,
                max_depth=c.th_depth, do_kf_cull=False, use_depth=False)
            if room is not None:
                for f, old in zip(mstate.FIELDS, before):
                    t = getattr(ms, f)
                    t.copy_(torch.where(room, t, old))
        return res.T, res.velocity, res.scalars

    def _batched_step(self, ms, imgs, T_last, velocity, frame_id, *room,
                      with_kf: bool):
        return torch.func.vmap(partial(self._stream_step, with_kf=with_kf))(
            ms, imgs, T_last, velocity, frame_id, *room)

    def reset(self):
        """Empty maps, identity poses and velocities (this rank's
        streams)."""
        eye = torch.eye(4, device=self.device).expand(self.S_local, 4, 4)
        self.ms = mstate.broadcast(mstate.allocate(self.map_cfg,
                                                   self.device), self.S_local)
        self.T_last, self.velocity = eye.clone(), eye.clone()
        self.frame_id = -1
        self.n_kf_host = np.zeros(self.S_local, np.int64)

    def bootstrap(self, ms_batch: mstate.MapState, T_batch=None):
        """Install the streams' initial maps (stacked, `mstate.stack`; the
        steps update it in place, the JAX package's donation) and
        optionally their (S, 4, 4) poses. With a mesh, of all S streams:
        the rank keeps its share (on its device, a view where the map is
        there already)."""
        if self.mesh is not None:
            ms_batch = streams.shard_streams(self.mesh, ms_batch)
            if T_batch is not None:
                T_batch = streams.shard_streams(self.mesh, T_batch)
        self.ms = ms_batch
        self.n_kf_host = ms_batch.n_kf.cpu().numpy().astype(np.int64)
        if T_batch is not None:
            self.T_last = T_batch.to(self.device, torch.float32).clone()

    def _upload(self, x):
        """An array on the device (the (S, H, W) frames); host arrays
        through pinned memory, without waiting."""
        if not torch.is_tensor(x):
            x = torch.from_numpy(np.ascontiguousarray(x))
        if x.device == self.device or self.device.type != "cuda":
            return x.to(self.device)
        host = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
        host.copy_(x)
        return host.to(self.device, non_blocking=True)

    def step(self, imgs):
        """imgs (S, H, W) uint8 or float: every stream one frame, and the
        keyframe chain on the cadence. Returns (T (S, 4, 4), scalars
        (S, 6)) on the device, nothing read back; with a mesh, the rank
        uploads its streams' frames only and every rank returns all S
        streams' results."""
        self.frame_id += 1
        frame_id = torch.full((self.S_local,), self.frame_id,
                              dtype=torch.int32, device=self.device)
        lo, hi = self.stream_range
        args = (self.ms, self._upload(imgs[lo:hi]), self.T_last,
                self.velocity, frame_id)
        kind = "track"
        if self.frame_id % self.kf_interval == 0:
            room = self.n_kf_host < self.map_cfg.max_kf - 1
            kind = "kf"
            if not room.all():
                kind = "kf_masked"
                args += (self._upload(room),)
            self.n_kf_host += room
        T, vel, scalars = self._steps[kind](*args)
        self.T_last, self.velocity = T, vel
        if self.mesh is not None:
            T, scalars = (streams.gather_streams(self.mesh, x)
                          for x in (T, scalars))
        return T, scalars


class RoundRobinTracker:
    """S independent streams time-multiplexed through one `System`'s
    graphed chunk step (`System._track_chunk`); the keyframe chain runs for
    each chunk's last frame every `kf_every_chunks` chunks, on every stream
    with a free keyframe slot (counted on the host from the bootstrap
    maps). Unlike the JAX package's, `bootstrap` takes the streams' initial
    poses where given."""

    def __init__(self, config, n_streams: int, kf_every_chunks: int = 3,
                 device=None, use_graphs: bool = True):
        from ..models.system import System
        self.S = n_streams
        self.kf_every_chunks = kf_every_chunks
        self.slam = System(config, device=_device(device),
                           use_graphs=use_graphs)
        self.cfg = config
        self.streams = None
        self.chunk_count = 0

    def bootstrap(self, ms_list, T_list=None):
        """ms_list: S maps, or one map for every stream (each stream keeps
        a copy); T_list: optional S (4, 4) initial poses."""
        slam = self.slam
        if isinstance(ms_list, mstate.MapState):
            ms_list = [ms_list] * self.S
        ms_list = [mstate.MapState(**{f: getattr(ms, f).clone()
                                      for f in mstate.FIELDS})
                   for ms in ms_list]
        for ms in ms_list:
            for f in mstate.FIELDS:
                if getattr(ms, f).shape != getattr(slam.ms, f).shape:
                    raise ValueError(f"stream map field {f}: shape "
                                     f"{tuple(getattr(ms, f).shape)}, the "
                                     f"System's is "
                                     f"{tuple(getattr(slam.ms, f).shape)}")
        eye = torch.eye(4, device=slam.device)
        self.streams = [
            {"ms": ms, "T": eye if T_list is None else torch.as_tensor(
                T_list[s], dtype=torch.float32, device=slam.device),
             "vel": eye,
             "frame_id": 0, "n_kf": int(ms.n_kf)}
            for s, ms in enumerate(ms_list)]

    def step_chunks(self, imgs_per_stream):
        """imgs_per_stream: S (B, H, W) frame blocks. Tracks each stream
        through its chunk; returns the list of (B, 4, 4) pose stacks."""
        slam = self.slam
        self.chunk_count += 1
        make_kf = self.chunk_count % self.kf_every_chunks == 0
        out = []
        for st, imgs in zip(self.streams, imgs_per_stream):
            copy_map(slam.ms, st["ms"])
            slam.T_last, slam.velocity = st["T"], st["vel"]
            Ts, _, _, m_pt, m_ln, feats_s, lfeats_s = slam._track_chunk(
                slam._image(imgs))
            B = int(imgs.shape[0])
            st["frame_id"] += B
            if make_kf and st["n_kf"] < slam.map_cfg.max_kf - 1:
                j = B - 1
                pick = lambda x: None if x is None else type(x)(
                    *(t[j] for t in x))
                slam._process_kf(
                    slam.ms, pick(feats_s), pick(lfeats_s), Ts[j], m_pt[j],
                    m_ln[j], st["frame_id"],
                    torch.zeros(slam.map_cfg.n_kp, device=slam.device),
                    do_kf_cull=False, use_depth=False)
                st["n_kf"] += 1
            copy_map(st["ms"], slam.ms)
            st["T"], st["vel"] = slam.T_last, slam.velocity
            out.append(Ts)
        return out

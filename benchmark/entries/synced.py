"""The live-camera entry: one `System`, one frame in and its pose out
through `System.track_synced`, in a closed loop.

Set-up renders the frames of a periodic mix (its start ramp and one
period, replayed), builds the System and runs the warm-up frames through
`track_synced` (two-view initialization on the way, and every graph the
window replays captured). A step hands the next frame in as a host uint8
array and takes its pose to the host; the frame's keyframe and LOST
decisions are resolved before the call returns, so a keyframe frame pays
the chain.
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch
from torch.profiler import record_function

from ..harness import judge, traffic


class Entry:
    """`run` is the harness's run context (`benchmark/run.py`)."""

    label = "frames"

    def __init__(self, run):
        self.run = run
        self.mix = run.mix
        self.fields = run.fields
        if not run.mix.get("periodic"):
            raise ValueError(f"the synced entry replays a periodic mix; "
                             f"{run.mix['name']!r} is not")
        self.period = int(round(run.mix["path"]["period_s"]
                                * run.fields["fps"]))
        self.stream = traffic.Stream(run.mix, run.camera, run.seed,
                                     run.device)
        self.frames = []          # host uint8 (H, W): the ramp, one period
        self.next = 0             # the next frame to hand in
        self._capture = None      # (snapshot) of the frame being checked
        self.slam = None

    def frame(self, i: int) -> np.ndarray:
        return self.frames[self.stream.slot(i, self.period)]

    # -- set-up -------------------------------------------------------
    def setup(self):
        run = self.run
        warm = int(self.mix["warmup_frames"])
        n = self.stream.ramp_frames + self.period
        for a in range(0, n, 32):
            self.frames.extend(
                self.stream.frames(a, min(n, a + 32) - a).cpu().numpy())
        run.after_render()
        from plslam_tpu_torch.models.system import SLAMConfig, System
        self.cfg = SLAMConfig(**self.fields)
        run.settings = dataclasses.asdict(self.cfg)
        self.slam = System(self.cfg, device=run.device)
        self.sim3_stages = 0
        lc = self.slam.loop_closer
        if lc is not None:
            stage = lc._sim3_stage

            def counted_stage(*a, **k):
                self.sim3_stages += 1
                return stage(*a, **k)
            lc._sim3_stage = counted_stage
        frame_step = self.slam._frame_step

        def frame_step_kept(*a, **k):
            out = frame_step(*a, **k)
            if self._capture is not None:
                res, f, _ = out
                self._capture["out"] = {
                    "T": res.T.clone(), "scalars": res.scalars.clone(),
                    "matched_pt": res.matched_pt.clone(),
                    "feats": {"uv": f.uv.clone(), "octave": f.octave.clone(),
                              "desc": f.desc.clone(),
                              "valid": f.valid.clone()}}
            return out
        self.slam._frame_step = frame_step_kept
        for _ in range(warm):
            self.step()
        if self.slam.state != "OK":
            raise RuntimeError(f"not tracking after the {warm} warm-up frames"
                               f" (state {self.slam.state})")

    # -- the window -----------------------------------------------------
    def step(self, keep=None) -> dict:
        """One frame through `track_synced`: its record (frames, latency
        from hand-in to the pose on the host, LOST, keyframe). With a list
        `keep`, the frame's inputs are copied on the device before the call
        and the program's outputs after it, and appended to `keep` on the
        host once the frame's latency is taken."""
        slam = self.slam
        i = self.next
        self.next += 1
        img = self.frame(i)
        if keep is not None and slam.state == "OK":
            self._capture = {
                "img": torch.from_numpy(img),
                "map": judge.copy_fields(slam.ms, judge.TRACK_FIELDS),
                "T_last": slam.T_last.clone(),
                "velocity": slam.velocity.clone(),
                "anchor": slam._anchor_kf}
        n_stats = len(slam.stats)
        with record_function("bench.frame"):
            t0 = time.perf_counter()
            T = slam.track_synced(img, i / self.fields["fps"])
            if T is not None:
                T = T.cpu()
            dt = time.perf_counter() - t0
        st = slam.stats[-1] if len(slam.stats) > n_stats else {}
        if self._capture is not None:
            if "out" in self._capture:
                keep.append(judge.to_host(self._capture))
            self._capture = None
        return {"frames": 1, "latency_s": dt, "kf": bool(st.get("kf")),
                "lost": T is None or bool(st.get("lost"))}

    def counters(self) -> dict:
        g = self.slam.graphs
        return {"captures": g.captures, "replays": g.replays,
                "growths": self.slam.n_growths,
                "sim3_stages": self.sim3_stages,
                "keyframes": self.slam.n_kf_host}

    def occupancy(self) -> dict:
        ms = self.slam.ms
        return {"n_kf": int(ms.n_kf), "n_pt": int(ms.n_pt),
                "n_ln": int(ms.n_ln), "max_kf": self.slam.map_cfg.max_kf,
                "max_pt": self.slam.map_cfg.max_pt,
                "max_ln": self.slam.map_cfg.max_ln}

    def release(self):
        """Drop the program's state (the reference runs after)."""
        self.slam = None

    # -- judging ----------------------------------------------------------
    def judge(self, ref) -> list:
        """Per sampled frame, its numbers against `ref`."""
        rows = []
        for snap in self.run.checks:
            f, res = ref.track(snap)
            rows.append(judge.frame_numbers(snap["out"], f, res))
        return rows

    def k1_work(self, ref, snaps) -> list:
        """Per K1 launch of one traced frame (`snaps`: its snapshot):
        (bytes its shapes need, passing pairs), from the reference's
        searches on the same inputs."""
        from ..harness import k1
        out = []
        for snap in snaps:
            calls = []
            ref.track(snap, k1_calls=calls)
            out.extend(k1.launch_work(a, g) for a, g in calls)
        return out

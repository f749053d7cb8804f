"""The one trajectory generator: a traffic mix's data file in, camera poses
in camera time out.

A mix (`benchmark/traffic/<mix>.json`) gives the scene (planes, texture and
segment parameters, read by `render.Renderer`) and a path: a centre, a drift
velocity and a sum of sinusoids over the six pose coordinates (x, y, z in
metres, then a rotation vector in radians), with a period, and optionally a
start ramp (`ramp_s`, `ramp_from`): the camera starts slower and reaches
the path's speed smoothly, as a camera picked up from rest. The drift and
translation terms are scaled together so that the mean speed over a period
is `speed_m_s`, and the rotation terms so that the mean angular rate is
`rot_deg_s`: the mix states the speeds of the sequence it stands for, and
the shape of the path. Frame i shows the pose at camera time i / fps,
whatever the system's speed.
"""
from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

from . import render

TRAFFIC_DIR = Path(__file__).resolve().parents[1] / "traffic"


def load(name: str) -> dict:
    """The mix `name` from its data file."""
    with open(TRAFFIC_DIR / f"{name}.json") as f:
        return json.load(f)


class Path6:
    """The mix's camera path: `pose(t)` at camera time t (seconds)."""

    def __init__(self, path: dict):
        self.p = path
        self.period = float(path["period_s"])
        self.center = np.asarray(path["center_m"], np.float64)
        self.drift = np.asarray(path.get("drift_m_s", [0, 0, 0]), np.float64)
        self.terms = [(int(h["axis"]), float(h["amp"]), float(h["cycles"]),
                       float(h["phase"])) for h in path["harmonics"]]
        self.k_t, self.k_r = 1.0, 1.0
        # scale to the stated mean speeds, sampled finely over one period
        ts = np.linspace(0.0, self.period, 4001)[:-1]
        v, w = self._rates(ts)
        mean_v = float(np.linalg.norm(v, axis=1).mean())
        mean_w = float(np.linalg.norm(w, axis=1).mean())
        self.k_t = path["speed_m_s"] / mean_v if mean_v > 0 else 1.0
        self.k_r = math.radians(path["rot_deg_s"]) / mean_w \
            if mean_w > 0 else 1.0

    def _coords(self, t):
        t = np.asarray(t, np.float64)
        x = np.zeros(t.shape + (6,))
        x[..., :3] = self.k_t * self.drift * t[..., None]
        for axis, amp, cyc, ph in self.terms:
            k = self.k_t if axis < 3 else self.k_r
            x[..., axis] += k * amp * np.sin(
                2 * math.pi * cyc * t / self.period + ph)
        return x

    def _rates(self, t):
        t = np.asarray(t, np.float64)
        d = np.zeros(t.shape + (6,))
        d[..., :3] = self.k_t * self.drift
        for axis, amp, cyc, ph in self.terms:
            k = self.k_t if axis < 3 else self.k_r
            om = 2 * math.pi * cyc / self.period
            d[..., axis] += k * amp * om * np.cos(om * t + ph)
        return d[..., :3], d[..., 3:]

    def mean_rates(self):
        """(mean speed m/s, mean angular rate deg/s) over one period."""
        v, w = self._rates(np.linspace(0.0, self.period, 4001)[:-1])
        return (float(np.linalg.norm(v, axis=1).mean()),
                math.degrees(float(np.linalg.norm(w, axis=1).mean())))

    def poses(self, t) -> np.ndarray:
        """(n, 4, 4) float64 world->camera poses at camera times t."""
        x = self._coords(np.atleast_1d(t))
        return np.stack([render.pose_from(self.center + c[:3], c[3:])
                         for c in x])


def warp(t, ramp_s: float, ramp_from: float):
    """Path time at camera time t when the camera starts at `ramp_from` of
    the path's speed and reaches it smoothly (a smoothstep) over `ramp_s`
    seconds: a camera picked up from rest. Past the ramp, path time runs
    with camera time, `ramp_s * (1 - ramp_from) / 2` behind it."""
    t = np.asarray(t, np.float64)
    if ramp_s <= 0:
        return t
    x = np.clip(t / ramp_s, 0.0, 1.0)
    inside = ramp_from * t + (1 - ramp_from) * ramp_s * (x ** 3 - x ** 4 / 2)
    return np.where(t < ramp_s, inside, t - ramp_s * (1 - ramp_from) / 2)


class Stream:
    """One camera of a mix: its renderer (texture keyed by the seed) and its
    path, after the mix's start ramp."""

    def __init__(self, mix: dict, cam: dict, seed: int, device):
        self.fps = float(cam["fps"])
        self.path = Path6(mix["path"])
        self.ramp = (float(mix.get("ramp_s", 0.0)),
                     float(mix.get("ramp_from", 1.0)))
        self.ramp_frames = int(np.ceil(self.ramp[0] * self.fps))
        self.renderer = render.Renderer(
            cam, mix["scene"], render.seed_key(seed, 0), device)

    def poses(self, first: int, n: int) -> np.ndarray:
        """Poses of frames first .. first + n - 1."""
        t = np.arange(first, first + n) / self.fps
        return self.path.poses(warp(t, *self.ramp))

    def frames(self, first: int, n: int, depth: bool = False):
        """Frames first .. first + n - 1 on the renderer's device."""
        return self.renderer.render(self.poses(first, n), depth=depth)

    def slot(self, i: int, period: int) -> int:
        """Where frame i of a periodic mix lies among the frames made at
        set-up (the ramp's frames, then one period): past the ramp, frame i
        repeats frame i - period."""
        r = self.ramp_frames
        return i if i < r else r + (i - r) % period

"""EuRoC MAV loader (`Examples/Monocular/mono_euroc.cc:LoadImages`: image
dir + separate timestamp list in seconds*1e9).

Port of `plslam_tpu/datasets/euroc.py` (numpy), on the port's loader."""
from __future__ import annotations

import os

import numpy as np


def load_index(img_dir: str, ts_file: str):
    with open(ts_file) as f:
        stamps = [l.strip() for l in f if l.strip() and not l.startswith("#")]
    ts = np.asarray([float(s) / 1e9 for s in stamps])
    paths = [os.path.join(img_dir, s + ".png") for s in stamps]
    return ts, paths


def frames(img_dir: str, ts_file: str):
    from ..utils.native_loader import PrefetchLoader
    ts, paths = load_index(img_dir, ts_file)
    loader = PrefetchLoader(paths)
    for t, img in zip(ts, loader):
        yield float(t), img

"""KITTI odometry loader (`Examples/Monocular/mono_kitti.cc:LoadImages`).

Port of `plslam_tpu/datasets/kitti.py` (numpy), on the port's loader."""
from __future__ import annotations

import os

import numpy as np


def load_index(seq_dir: str, cam: str = "image_0"):
    with open(os.path.join(seq_dir, "times.txt")) as f:
        ts = np.asarray([float(l) for l in f if l.strip()])
    img_dir = os.path.join(seq_dir, cam)
    paths = [os.path.join(img_dir, f"{i:06d}.png") for i in range(len(ts))]
    return ts, paths


def frames(seq_dir: str, cam: str = "image_0"):
    from ..utils.native_loader import PrefetchLoader
    ts, paths = load_index(seq_dir, cam)
    loader = PrefetchLoader(paths)
    for t, img in zip(ts, loader):
        yield float(t), img

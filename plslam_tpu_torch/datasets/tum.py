"""TUM RGB-D dataset loader (`Examples/Monocular/mono_tum.cc:LoadImages`
and `Examples/RGB-D/rgbd_tum.cc` association handling).

Port of `plslam_tpu/datasets/tum.py` (numpy): frames decode through the
port's loader (`utils/native_loader.py`: native, else cv2)."""
from __future__ import annotations

import os

import numpy as np


def load_rgb_index(seq_dir: str):
    """Parse rgb.txt -> (timestamps (N,), absolute paths [N])."""
    ts, paths = [], []
    with open(os.path.join(seq_dir, "rgb.txt")) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t, p = line.split()[:2]
            ts.append(float(t))
            paths.append(os.path.join(seq_dir, p))
    return np.asarray(ts), paths


def load_associations(assoc_path: str, seq_dir: str):
    """RGB-D association file: t_rgb rgb_path t_depth depth_path."""
    out = []
    with open(assoc_path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            t_rgb, p_rgb, t_d, p_d = line.split()[:4]
            out.append((float(t_rgb), os.path.join(seq_dir, p_rgb),
                        float(t_d), os.path.join(seq_dir, p_d)))
    return out


def read_gray(path: str) -> np.ndarray:
    """(H, W) float32 gray image in [0, 255]."""
    from ..utils.native_loader import decode_gray
    if not os.path.exists(path):
        raise FileNotFoundError(path)
    return decode_gray(path).astype(np.float32)


def frames(seq_dir: str):
    """Yield (timestamp, grayscale uint8 image), decoded + prefetched by the
    native C++ loader (background threads; `native/plslam_loader.cpp`)."""
    from ..utils.native_loader import PrefetchLoader
    ts, paths = load_rgb_index(seq_dir)
    loader = PrefetchLoader(paths)
    for t, img in zip(ts, loader):
        yield float(t), img

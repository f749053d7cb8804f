"""The PyTorch port's depth entry points on the CPU: `System.track_rgbd`
and `System.track_stereo` on a config that names a depth sensor and on the
default monocular one, over the first 2 frames of
tests/test_depth_sensors.py's sequences at that file's small widths (512
features, 3 levels)."""
import numpy as np
import pytest

from plslam_tpu_torch.datasets import synthetic
from plslam_tpu_torch.models import system as tsys

STEREO_BASELINE = 0.3


def _rgbd_frames(n):
    scene = synthetic.make_scene(seed=5)
    return [synthetic.render_rgbd(scene, T)
            for T in synthetic.trajectory(18, "orbit", amplitude=1.0)[:n]]


def _stereo_frames(n):
    scene = synthetic.make_scene(seed=6)
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -STEREO_BASELINE
    return [(synthetic.render(scene, T), synthetic.render(scene, T_rl @ T))
            for T in synthetic.trajectory(14, "orbit", amplitude=0.8)[:n]]


@pytest.mark.parametrize("sensor", ["mono", "rgbd"])
@pytest.mark.parametrize("entry", ["track_rgbd", "track_stereo"])
def test_depth_entry_points_run(sensor, entry):
    """The first frame initializes from depth, the second tracks, and the
    System is switched to the entry point's sensor."""
    cfg = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=512,
               n_levels=3, max_kf=12, max_pt=4096, ba_window=4,
               ba_points=1024, use_loop_closing=False, use_lines=False,
               sensor=sensor)
    if entry == "track_rgbd":
        frames = _rgbd_frames(2)
    else:
        frames = _stereo_frames(2)
        cfg["baseline"] = STEREO_BASELINE
    slam = tsys.System(tsys.SLAMConfig(**cfg), device="cpu")
    for i, (a, b) in enumerate(frames):
        T = getattr(slam, entry)(a, b, i / 30.0)
        assert T is not None and T.shape == (4, 4)
    assert slam.state == tsys.OK and slam.n_keyframes() >= 1
    assert slam.cfg.sensor == entry[len("track_"):]
    assert slam._kp_ur is not None and int((slam._kp_ur > 0).sum()) > 150
    assert slam.n_map_points() > 150

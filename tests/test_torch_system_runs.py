"""The port's `System.track_monocular` against the JAX package's, with lines
on and loop closing and growth off, over the 28 rendered frames of the
system sequence (tests/test_torch_system.py gives the run and its bounds):
the bounds, the ATE computation, the trajectory writers and the line
bookkeeping of the port's run."""
import numpy as np
import pytest

from plslam_tpu.models import system as jsys
from plslam_tpu_torch.datasets import synthetic

from test_torch_system import N_FRAMES, SMALL, _assert_within_bounds, _both
from torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def runs():
    return _both(SMALL)


def test_system_matches_jax_over_rendered_frames(runs):
    _assert_within_bounds(runs)


def test_ate_rmse_matches_jax(runs):
    from plslam_tpu.datasets import synthetic as jsyn
    Ts, _, (_, _, traj) = runs
    idx = [i for i in range(N_FRAMES) if i / 30.0 in traj]
    est = np.stack([traj[i / 30.0] for i in idx])
    for scale in (True, False):
        assert synthetic.ate_rmse(est, Ts[idx], scale) == pytest.approx(
            jsyn.ate_rmse(est, Ts[idx], scale), rel=1e-12)


def test_trajectory_writers(runs, tmp_path):
    """TUM, keyframe TUM and KITTI files: one line per entry, numbers as the
    JAX package's writer prints them for the same poses."""
    _, _, (t, _, _) = runs
    t.save_trajectory_tum(str(tmp_path / "port.txt"))
    jsys._write_tum(str(tmp_path / "jax.txt"), t.trajectory)
    a = np.loadtxt(tmp_path / "port.txt")
    b = np.loadtxt(tmp_path / "jax.txt")
    assert a.shape == (len(t.trajectory), 8)
    np.testing.assert_allclose(a, b, atol=2e-7)
    t.save_keyframe_trajectory_tum(str(tmp_path / "kf.txt"))
    assert np.loadtxt(tmp_path / "kf.txt").shape == (t.n_keyframes(), 8)
    t.save_trajectory_kitti(str(tmp_path / "kitti.txt"))
    assert np.loadtxt(tmp_path / "kitti.txt").shape == (len(t.trajectory), 12)
    assert t.poses().shape == (len(t.trajectory), 4, 4)


def test_system_with_lines_tracks(runs):
    """With lines on, the port's System detects segments on every frame,
    triangulates map lines at initialization and in the chain, and reports
    line inliers per tracked frame."""
    _, _, (t, init_t, _) = runs
    assert t.line_detector is not None and t.line_detector.n_out == 256
    assert int(t.ms.n_ln) >= 1
    assert int(t.ms.kf_ln_valid[:t.n_keyframes()].sum(1).min()) >= 10
    tracked = [s for s in t.stats if not s.get("lost")]
    assert tracked and all("line_inliers" in s for s in tracked)

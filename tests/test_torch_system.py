"""The PyTorch port's `System` against the JAX package's `System`: the
public surface and the paths that need no full run. The two full runs over
the 28 rendered 640x480 frames of the system sequence (`make_scene(seed=1)`,
orbit) at tests/test_e2e.py's small widths (512 features, 3 levels, 16
keyframes x 4096 points, a 5 x 1024 BA window, 256 line slots) are in
tests/test_torch_system_runs.py (loop closing and growth off) and
tests/test_torch_system_loop.py (both on, 5 keyframe slots, so the map
grows, and the young-map global BA up to the 4th keyframe); their shared
runner and bounds are here.

Bounds: the same initialization frame; keyframe counts within 1; map
points within 10%; map lines created within 2; the port's ATE after Sim3
alignment below 5% of the span (the JAX package's gate); the two
Sim3-aligned trajectories within 1% of the span of each other; with growth
on, the same growth events. Here: `SLAMConfig` and `from_yaml` as the JAX
package's, a line mask read from `mask_path` as the JAX package reads it,
relocalization of a LOST frame, the defaults' constructor, and
`NotImplementedError` for every option not ported yet (the dispatch paths:
tests/test_torch_dispatch.py)."""
import dataclasses
from pathlib import Path

import numpy as np
import pytest
import torch

from plslam_tpu.models import system as jsys
from plslam_tpu_torch.datasets import synthetic
from plslam_tpu_torch.models import system as tsys
from torch_threads import one_thread  # noqa: F401

N_FRAMES = 28
SMALL = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=512,
             n_levels=3, max_kf=16, max_pt=4096, ba_window=5, ba_points=1024,
             use_lines=True, use_loop_closing=False, grow_map=False)
LOOP = dict(SMALL, max_kf=5, use_loop_closing=True, grow_map=True,
            young_gba_until_kf=4)
ROOT = Path(__file__).resolve().parents[1]


def _frames(n=N_FRAMES):
    scene = synthetic.make_scene(seed=1)
    Ts = synthetic.trajectory(60, "orbit")[:n]
    return Ts, [synthetic.render(scene, T) for T in Ts]


def _run(slam, frames):
    init = None
    for i, img in enumerate(frames):
        slam.track_monocular(img, i / 30.0)
        if init is None and slam.state == "OK":
            init = i
    slam.flush()
    traj = dict((ts, np.asarray(T)) for ts, T in slam.trajectory)
    return init, traj


def _both(cfg):
    Ts, frames = _frames()
    j = jsys.System(jsys.SLAMConfig(**cfg))
    t = tsys.System(tsys.SLAMConfig(**cfg), device="cpu")
    return Ts, (j, *_run(j, frames)), (t, *_run(t, frames))


def _centers_span(Ts, idx):
    c = lambda T: -T[:3, :3].T @ T[:3, 3]
    return float(np.linalg.norm(c(Ts[idx[-1]]) - c(Ts[idx[0]])))


def _assert_within_bounds(runs):
    Ts, (j, init_j, traj_j), (t, init_t, traj_t) = runs
    assert init_t == init_j is not None
    assert abs(t.n_keyframes() - j.n_keyframes()) <= 1
    assert t.n_keyframes() >= 3
    n_j = j.n_map_points()
    assert abs(t.n_map_points() - n_j) <= 0.1 * n_j
    assert abs(int(t.ms.n_ln) - int(j.ms.n_ln)) <= 2
    assert not any(s.get("lost") for s in t.stats)
    idx = [i for i in range(N_FRAMES) if i / 30.0 in traj_t]
    assert idx == [i for i in range(N_FRAMES) if i / 30.0 in traj_j]
    assert len(idx) >= N_FRAMES - 6
    span = max(_centers_span(Ts, idx), 0.2)
    est_t = np.stack([traj_t[i / 30.0] for i in idx])
    est_j = np.stack([traj_j[i / 30.0] for i in idx])
    ate_t = synthetic.ate_rmse(est_t, Ts[idx])
    ate_j = synthetic.ate_rmse(est_j, Ts[idx])
    gap = synthetic.ate_rmse(est_t, est_j)
    print(f"ATE port {ate_t:.4f} jax {ate_j:.4f} span {span:.3f}; "
          f"port vs jax {gap:.5f}; keyframes {t.n_keyframes()} / "
          f"{j.n_keyframes()}; points {t.n_map_points()} / {n_j}; lines "
          f"{int(t.ms.n_ln)} / {int(j.ms.n_ln)}")
    assert ate_t < 0.05 * span
    assert gap < 0.01 * span


def test_slam_config_is_the_jax_one():
    fj = [(f.name, f.default) for f in dataclasses.fields(jsys.SLAMConfig)]
    ft = [(f.name, f.default) for f in dataclasses.fields(tsys.SLAMConfig)]
    assert ft == fj
    path = str(ROOT / "examples" / "TUM1.yaml")
    assert dataclasses.asdict(tsys.SLAMConfig.from_yaml(path)) \
        == dataclasses.asdict(jsys.SLAMConfig.from_yaml(path))


def test_mask_path_reaches_detect_lines(tmp_path):
    """A mask image at `mask_path` is read as the JAX package reads it
    (pixels > 127) and suppresses the line blocks it covers."""
    import cv2
    from plslam_tpu_torch.ops import lines as tl
    mask = np.full((480, 640), 255, np.uint8)
    mask[:, :320] = 0
    path = str(tmp_path / "mask.png")
    cv2.imwrite(path, mask)
    cfg = {**SMALL, "mask_path": path}
    t = tsys.System(tsys.SLAMConfig(**cfg), device="cpu")
    j = jsys.System(jsys.SLAMConfig(**cfg))
    np.testing.assert_array_equal(t._line_mask.numpy(),
                                  np.asarray(j._line_mask))
    scene = synthetic.make_scene(seed=1)
    img = synthetic.render(scene, synthetic.trajectory(60, "orbit")[0])
    _, lf = t._extract(img)
    want = tl.detect_lines(torch.from_numpy(img.astype(np.uint8)).float(),
                           n_out=256, mask=t._line_mask)
    np.testing.assert_array_equal(lf.valid.numpy(), want.valid.numpy())
    np.testing.assert_allclose(lf.uv_a.numpy(), want.uv_a.numpy(), atol=1e-4)
    v = lf.valid.numpy()
    assert v.sum() >= 3
    assert (lf.uv_a.numpy()[v, 0] > 312).all()
    assert (lf.uv_b.numpy()[v, 0] > 312).all()


@pytest.mark.parametrize("option,value,item", [("subpixel", True, 16)])
def test_unported_options_raise(option, value, item):
    cfg = tsys.SLAMConfig(**{**SMALL, option: value})
    with pytest.raises(NotImplementedError, match=f"item {item}$"):
        tsys.System(cfg, device="cpu")


def test_system_defaults_construct_on_cuda_only():
    """`System(SLAMConfig())` takes every default (loop closing and growth
    on); without a device it means cuda, with no fallback to the CPU."""
    t = tsys.System(tsys.SLAMConfig(), device="cpu")
    assert t.loop_closer is not None and t.cfg.grow_map
    _, frames = _frames(2)
    assert t.track_monocular(frames[0], 0.0) is None
    t.track_monocular(frames[1], 1 / 30.0)
    assert t.frame_id == 1 and t.state in (tsys.OK, tsys.NOT_INITIALIZED)
    if torch.cuda.is_available():
        assert tsys.System().device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="needs a CUDA device"):
            tsys.System()


def test_relocalization_runs_past_the_young_map():
    """LOST with 5 or fewer keyframes resets the map, as in the JAX
    package; past that a LOST frame relocalizes against the map. On the
    first 12 frames of tests/test_reloc_e2e.py's sequence with its cadence
    (a keyframe every frame), frame 9 seen again while LOST: its tracked
    pose within 1e-2, OK again, the local-map anchor set until the next
    keyframe, and no keyframe within 2 x kf_max_interval frames."""
    slam = tsys.System(tsys.SLAMConfig(**SMALL), device="cpu")
    slam.state, slam.n_kf_host, slam.frame_id = tsys.LOST, 5, 10
    assert slam._relocalize_frame(None, 0.3) is None
    assert slam.state == tsys.NOT_INITIALIZED and slam.stats[-1]["auto_reset"]

    scene = synthetic.make_scene(seed=2)
    Ts = synthetic.trajectory(30, "orbit", amplitude=1.0)
    frames = [synthetic.render(scene, Ts[i]) for i in range(13)]
    slam = tsys.System(tsys.SLAMConfig(**dict(
        SMALL, kf_max_interval=2, kf_min_interval=1, kf_ref_ratio=2.0)),
        device="cpu")
    for i in range(12):
        slam.track_monocular(frames[i], i / 30.0)
    assert slam.state == tsys.OK and slam.n_kf_host > 5
    T9 = dict(slam.trajectory)[9 / 30.0]
    slam.state = tsys.LOST
    slam.frame_id += 1
    T = slam._relocalize_frame(slam._extract(frames[9])[0], 12 / 30.0)
    assert slam.state == tsys.OK and slam.stats[-1]["reloc"]
    assert slam.stats[-1]["inliers"] >= 50
    assert slam.last_reloc_frame == 12 and slam._anchor_kf is not None
    np.testing.assert_allclose(T.numpy(), T9, atol=1e-2)
    slam.track_monocular(frames[12], 13 / 30.0)
    assert slam.state == tsys.OK and not slam.stats[-1]["kf"]
    assert slam._anchor_kf is not None

"""The port's example drivers and bench on the CPU.

Each driver's `main` runs with `--device cpu` on an 8-frame 320x240
sequence the test writes in its dataset's layout (512 features, 3 levels,
the settings' other fields at their defaults): exit 0, its files written,
and rows in the format of the JAX package's writers (TUM: timestamp, centre,
quaternion x y z w; KITTI: a 3x4 camera-to-world matrix). The bench's
sections run at tiny widths with 2 streams, as tests/test_bench_paths.py
drives `bench.py`. The slow tier runs both packages' `mono_tum` on
tests/test_tum_driver_photo.py's 28 photo frames against that test's bar.
"""
import json
import os

import numpy as np
import pytest
import torch

from torch_threads import one_thread  # noqa: F401

W, H, FX, N = 320, 240, 250.0, 8
SETTINGS = f"""%YAML:1.0
Camera.fx: {FX}
Camera.fy: {FX}
Camera.cx: {W / 2}
Camera.cy: {H / 2}
Camera.width: {W}
Camera.height: {H}
ORBextractor.nFeatures: 512
ORBextractor.nLevels: 3
LINEextractor.nFeatures: 64
"""


@pytest.fixture(scope="module")
def sequence():
    """8 frames of a 24-frame orbit (init within them), with depth and a
    right view 0.3 m to the right."""
    from plslam_tpu_torch.datasets import synthetic
    scene = synthetic.make_scene(seed=1, width=W, height=H, fx=FX, fy=FX)
    Ts = synthetic.trajectory(24, "orbit")[:N]
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -0.3
    rgbd = [synthetic.render_rgbd(scene, T) for T in Ts]
    right = [synthetic.render(scene, T_rl @ T) for T in Ts]
    u8 = lambda f: np.clip(f, 0, 255).astype(np.uint8)
    return dict(frames=[u8(f) for f, _ in rgbd], depth=[d for _, d in rgbd],
                right=[u8(f) for f in right])


def _run(module, argv, cwd, monkeypatch):
    import importlib
    monkeypatch.chdir(cwd)
    driver = importlib.import_module(f"plslam_tpu_torch.examples.{module}")
    return driver.main([str(a) for a in argv] + ["--device", "cpu"])


def _tum_rows(path):
    rows = [l.split() for l in open(path).read().splitlines() if l.strip()]
    for r in rows:
        assert len(r) == 8
        q = np.array([float(v) for v in r[4:8]])
        assert abs(np.linalg.norm(q) - 1.0) < 1e-5
    return rows


def _kitti_rows(path):
    rows = [np.array([float(v) for v in l.split()]).reshape(3, 4)
            for l in open(path).read().splitlines() if l.strip()]
    for M in rows:
        np.testing.assert_allclose(M[:, :3] @ M[:, :3].T, np.eye(3),
                                   atol=1e-4)
    return rows


@pytest.mark.parametrize("chunked", [0, 4])
def test_mono_tum(sequence, tmp_path, monkeypatch, chunked):
    from plslam_tpu_torch.datasets import textured
    seq = tmp_path / "seq"
    textured.write_tum_sequence(str(seq), sequence["frames"],
                                [i / 30.0 for i in range(N)])
    (tmp_path / "s.yaml").write_text(SETTINGS)
    argv = [tmp_path / "s.yaml", seq, "traj.txt", "--trace", "trace.json"]
    if chunked:
        argv += ["--chunked", chunked]
    assert _run("mono_tum", argv, tmp_path, monkeypatch) == 0
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    spans = [e for e in events if e["ph"] == "X"]
    assert {"frame", "initialize", "local_ba"} <= {e["name"] for e in spans}
    assert all(e["dur"] >= 0 for e in spans)
    rows = _tum_rows(tmp_path / "traj.txt")
    assert len(rows) >= 4
    assert {round(float(r[0]) * 30) for r in rows} <= set(range(N))
    assert len(_tum_rows(tmp_path / "KeyFrameTrajectory.txt")) >= 2
    stats = json.loads((tmp_path / "mono_tum_stats.json").read_text())
    for key in ("median_track_s", "mean_track_s", "n_kf", "n_loops",
                "n_gba_done"):
        assert key in stats
    assert stats["n_kf"] >= 2 and stats["native_loader"] is True
    assert _run("mono_tum", [], tmp_path, monkeypatch) == 1   # usage


def test_mono_kitti_and_stereo_kitti(sequence, tmp_path, monkeypatch):
    from plslam_tpu_torch.utils.native_loader import write_png
    for cam, key in (("image_0", "frames"), ("image_1", "right")):
        (tmp_path / cam).mkdir()
        for i, f in enumerate(sequence[key]):
            write_png(str(tmp_path / cam / f"{i:06d}.png"), f)
    (tmp_path / "times.txt").write_text(
        "".join(f"{i / 30.0:.6e}\n" for i in range(N)))
    (tmp_path / "s.yaml").write_text(SETTINGS)
    assert _run("mono_kitti", [tmp_path / "s.yaml", tmp_path, "mono.txt"],
                tmp_path, monkeypatch) == 0
    assert len(_kitti_rows(tmp_path / "mono.txt")) >= 4
    (tmp_path / "st.yaml").write_text(SETTINGS + f"Camera.bf: {FX * 0.3}\n"
                                      "ThDepth: 35\n")
    assert _run("stereo_kitti", [tmp_path / "st.yaml", tmp_path,
                                 "stereo.txt"], tmp_path, monkeypatch) == 0
    rows = _kitti_rows(tmp_path / "stereo.txt")
    assert len(rows) == N          # a stereo pair initializes at once


def test_mono_euroc(sequence, tmp_path, monkeypatch):
    from plslam_tpu_torch.utils.native_loader import write_png
    (tmp_path / "data").mkdir()
    stamps = [1403636579763555584 + i * 33333333 for i in range(N)]
    for s, f in zip(stamps, sequence["frames"]):
        write_png(str(tmp_path / "data" / f"{s}.png"), f)
    (tmp_path / "ts.txt").write_text("".join(f"{s}\n" for s in stamps))
    (tmp_path / "s.yaml").write_text(SETTINGS)
    assert _run("mono_euroc", [tmp_path / "s.yaml", tmp_path / "data",
                               tmp_path / "ts.txt", "kf.txt"],
                tmp_path, monkeypatch) == 0
    rows = _tum_rows(tmp_path / "kf.txt")
    assert len(rows) >= 2
    assert all(abs(float(r[0]) - stamps[0] / 1e9) < 1.0 for r in rows)


def test_rgbd_tum(sequence, tmp_path, monkeypatch):
    from plslam_tpu_torch.utils.native_loader import write_png
    (tmp_path / "rgb").mkdir()
    (tmp_path / "depth").mkdir()
    lines = []
    for i, (f, d) in enumerate(zip(sequence["frames"], sequence["depth"])):
        ts = f"{i / 30.0:.6f}"
        write_png(str(tmp_path / "rgb" / f"{ts}.png"), f)
        write_png(str(tmp_path / "depth" / f"{ts}.png"),
                  np.clip(np.round(d * 5000.0), 0, 65535).astype(np.uint16))
        lines.append(f"{ts} rgb/{ts}.png {ts} depth/{ts}.png\n")
    (tmp_path / "assoc.txt").write_text("".join(lines))
    (tmp_path / "s.yaml").write_text(SETTINGS + "DepthMapFactor: 5000.0\n")
    assert _run("rgbd_tum", [tmp_path / "s.yaml", tmp_path,
                             tmp_path / "assoc.txt", "traj.txt"],
                tmp_path, monkeypatch) == 0
    rows = _tum_rows(tmp_path / "traj.txt")
    assert len(rows) == N          # depth initializes on the first frame
    assert len(_tum_rows(tmp_path / "KeyFrameTrajectory.txt")) >= 1
    (tmp_path / "empty.txt").write_text("# nothing\n")
    assert _run("rgbd_tum", [tmp_path / "s.yaml", tmp_path,
                             tmp_path / "empty.txt"], tmp_path,
                monkeypatch) == 1


def test_bench_sections_on_cpu():
    """Every section of `plslam_tpu_torch.bench` at tiny widths (the
    configuration of tests/test_bench_paths.py at 320x240), 2 streams."""
    from plslam_tpu_torch import bench
    from plslam_tpu_torch.models.system import SLAMConfig, System
    cfg = SLAMConfig(
        fx=FX, fy=FX, cx=W / 2, cy=H / 2, k1=0, k2=0, p1=0, p2=0, k3=0,
        width=W, height=H, n_features=384, n_levels=3, max_kf=8,
        max_pt=2048, n_lf=32, ba_window=3, ba_points=512, ba_lines=32,
        kf_max_interval=5, use_loop_closing=False, grow_map=False,
        min_init_matches=60)
    device = torch.device("cpu")
    Ts, frames = bench.render_frames(12, W, H)
    slam = System(cfg, device=device)
    frames_dev, chunks = bench.stage(frames, device, chunk=4)
    assert len(chunks) == 3 and chunks[0].shape == (4, H, W)
    bench.warm_up(slam, frames_dev, chunks, chunk=4, n_single=6)
    full = bench.full_slam(slam, frames_dev, chunks, Ts, chunk=4, n_init=4)
    assert full["fps"] > 0 and full["keyframes"] >= 2
    assert full["ate"] is not None and np.isfinite(full["ate"])
    with pytest.raises(ValueError):
        bench.full_slam(slam, frames_dev, chunks, Ts, chunk=4, n_init=6)
    # one chunk per steady pass and per upload pass: the sections' loops
    # run all the same, in a third of the CPU time
    windows, kf = bench.steady_windows(slam, chunks[:1], chunk=4,
                                       n_windows=1, reps=1)
    assert len(windows) == 1 and windows[0] > 0 and kf >= 0
    assert bench.upload_included(slam, frames[:4], chunk=4, reps=1) > 0
    assert bench.synced_latency(slam, frames_dev, n=2) > 0
    rr, bt = bench.multistream(cfg, slam.ms, frames, device, n_streams=2,
                               n_steps=1, chunk=2)
    assert rr > 0 and bt > 0


@pytest.mark.slow
def test_mono_tum_photo_against_jax(tmp_path, monkeypatch):
    """tests/test_tum_driver_photo.py's 28 photo frames through both
    packages' `mono_tum`: each within that test's bar."""
    import sys
    from plslam_tpu.datasets import synthetic as jsyn, textured as jtex
    n, fx = 28, 500.0
    scene = jtex.make_photo_scene(seed=5, fx=fx, fy=fx)
    Ts = jsyn.trajectory(n, "orbit", amplitude=1.0)
    tss = [i / 30.0 for i in range(n)]
    jtex.write_tum_sequence(str(tmp_path / "seq"),
                            [jsyn.render(scene, T) for T in Ts], tss)
    (tmp_path / "s.yaml").write_text(
        SETTINGS.replace(f"Camera.fx: {FX}", f"Camera.fx: {fx}")
        .replace(f"Camera.fy: {FX}", f"Camera.fy: {fx}")
        .replace(f"Camera.cx: {W / 2}", "Camera.cx: 320.0")
        .replace(f"Camera.cy: {H / 2}", "Camera.cy: 240.0")
        .replace(f"Camera.width: {W}", "Camera.width: 640")
        .replace(f"Camera.height: {H}", "Camera.height: 480"))
    argv = [str(tmp_path / "s.yaml"), str(tmp_path / "seq")]
    assert _run("mono_tum", argv + ["port.txt"], tmp_path, monkeypatch) == 0
    sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))
    import examples.mono_tum as jax_mono_tum
    monkeypatch.setattr(sys, "argv", ["mono_tum.py", *argv, "jax.txt"])
    assert jax_mono_tum.main() == 0

    gt_c = np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts])
    from plslam_tpu_torch.utils import metrics
    for name in ("port.txt", "jax.txt"):
        rows = _tum_rows(tmp_path / name)
        assert len(rows) >= n - 6, (name, len(rows))
        by_i = {int(round(float(r[0]) * 30)): [float(v) for v in r[1:4]]
                for r in rows}
        idx = sorted(by_i)
        est = np.array([by_i[i] for i in idx])
        s, R, t = metrics.umeyama_align(est, gt_c[idx])
        ate = np.sqrt((((s * (R @ est.T)).T + t - gt_c[idx]) ** 2)
                      .sum(-1).mean())
        span = np.linalg.norm(gt_c[idx].max(0) - gt_c[idx].min(0))
        print(f"{name}: {len(rows)} rows, ATE {ate:.4f} m, span {span:.3f}")
        assert ate < 0.05 * span + 0.02, (name, ate, span)

"""The port's tracer (`plslam_tpu_torch/utils/trace.py`) on the CPU, and one
card case that skips without a card.

A CPU System (the dispatch tests' tiny configuration: 384 features, 3
levels, lines on) takes 7 rendered frames twice, host spans off and on:
frame 0 anchors the initialization, frame 1 initializes, frames 2-6 go
through `track_synced`, the frame step's path. Each synced frame logs its
11 device marks in order under its own frame id; the spans nest under
their `frame` span; the outputs of the two runs are bit-equal. Then the
tracer alone: the arithmetic of `frame_rows` on a hand-made log, the rings
wrapping under a window and the benchmark's readers returning None there,
and `BatchedTracker`'s vmapped step running with no stamp. No jax: the card
case runs where only PyTorch is installed

    python -m pytest tests/test_torch_trace.py -m cuda --noconftest
"""
import numpy as np
import pytest
import torch

from plslam_tpu_torch.datasets import synthetic
from plslam_tpu_torch.models import system as tsys
from plslam_tpu_torch.utils import trace
from torch_threads import one_thread  # noqa: F401

CFG = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, k1=0, k2=0, p1=0, p2=0,
           k3=0, n_features=384, n_levels=3, max_kf=8, max_pt=2048, n_lf=32,
           ba_window=3, ba_points=512, ba_lines=32, kf_max_interval=5,
           use_loop_closing=False, grow_map=False, min_init_matches=60)
N_FRAMES = 7
FRAME_MARKS = [("frame", False), ("extract.points", False),
               ("extract.lines", False), ("extract", True),
               ("track.search_a", False), ("track.pose_a", False),
               ("track.search_b", False), ("track.pose_b", False),
               ("track.finish", False), ("track", True), ("frame", True)]


@pytest.fixture(scope="module")
def frames():
    scene = synthetic.make_scene(seed=7)
    return [synthetic.render(scene, T).astype(np.uint8)
            for T in synthetic.trajectory(N_FRAMES, "orbit")]


def _track(frames, device="cpu", spans=False):
    """The frames through a System with host spans on or off: (System,
    poses, per-frame keypoints (uv, octave, valid) of every extraction)."""
    slam = tsys.System(tsys.SLAMConfig(**CFG), device=device)
    slam.tracer.enable(spans)
    kps = []
    for name in ("_extract_step", "_frame_step"):
        step = getattr(slam, name)

        def kept(*a, _step=step, _name=name, **k):
            out = _step(*a, **k)
            f = out[0] if _name == "_extract_step" else out[1]
            kps.append(tuple(t.cpu().clone() for t in (f.uv, f.octave,
                                                        f.valid)))
            return out
        setattr(slam, name, kept)
    poses = []
    for i, img in enumerate(frames):
        track = slam.track_synced if slam.state == "OK" \
            else slam.track_monocular
        T = track(img, i / 30.0)
        poses.append(None if T is None else T.cpu().clone())
    return slam, poses, kps


@pytest.fixture(scope="module")
def runs(frames):
    return {spans: _track(frames, spans=spans) for spans in (False, True)}


@pytest.mark.parametrize("spans", [False, True], ids=["spans-off",
                                                      "spans-on"])
def test_each_synced_frame_logs_its_stages_in_order(runs, spans):
    slam = runs[spans][0]
    assert slam.state == "OK" and slam.n_kf_host >= 2
    recs = slam.tracer.records()
    synced = [s for s in range(N_FRAMES)
              if any(f == s and n == "track.search_a" for f, n, _, _ in recs)]
    assert synced == list(range(2, N_FRAMES))
    for fid in synced:
        mine = [(n, e) for f, n, e, _ in recs if f == fid]
        assert mine == FRAME_MARKS
    rows = {r["frame"]: r for r in slam.tracer.frames()}
    for fid in synced:
        d = rows[fid]["device_ms"]
        stages = sum(v for k, v in d.items() if k in trace.STAGES)
        assert 0 < stages <= d["frame"]
        assert rows[fid]["gap_ms"] > 0
    # the frame span's host seconds are System.timings
    assert len(slam.timings) == N_FRAMES
    if spans:
        host = [rows[f]["host_ms"]["frame"] for f in range(N_FRAMES)]
        np.testing.assert_allclose(host, 1e3 * np.array(slam.timings),
                                   rtol=1e-3)


def test_host_spans_nest_under_their_frame(runs):
    assert runs[False][0].tracer.host_spans() == []
    spans = runs[True][0].tracer.host_spans()
    by_index = {s[0]: s for s in spans}
    names = [s[1] for s in spans]
    assert names.count("frame") == N_FRAMES
    assert {"resolve", "initialize", "local_ba"} <= set(names)
    for i, name, t0, t1, parent, fid in spans:
        assert t0 <= t1
        if name == "frame":
            assert parent == -1
            continue
        p = by_index[parent]
        assert p[5] == fid and p[2] <= t0 and t1 <= p[3]
        if name == "local_ba":      # the initial map's BA
            assert p[1] == "initialize"
        if name in ("resolve", "initialize"):
            assert p[1] == "frame"


def test_outputs_bit_equal_with_spans_on_and_off(runs):
    (_, poses_off, kps_off), (_, poses_on, kps_on) = runs[False], runs[True]
    assert len(kps_off) == len(kps_on) == N_FRAMES
    for a, b in zip(poses_off, poses_on):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    for a, b in zip(kps_off, kps_on):
        for x, y in zip(a, b):
            assert torch.equal(x, y)
    stats_off, stats_on = runs[False][0].stats, runs[True][0].stats
    assert [s["inliers"] for s in stats_off] == \
        [s["inliers"] for s in stats_on]
    assert all(s["inliers"] >= CFG["min_init_matches"] // 2
               for s in stats_off)


def test_frame_rows_arithmetic():
    ms = 1_000_000
    recs = [(3, "frame", False, 0), (3, "extract.points", False, 1 * ms),
            (3, "extract.lines", False, 4 * ms), (3, "extract", True, 6 * ms),
            (3, "track.search_a", False, 7 * ms),
            (3, "track.pose_a", False, 9 * ms),
            (3, "track.search_b", False, 14 * ms),
            (3, "track.pose_b", False, 15 * ms),
            (3, "track.finish", False, 25 * ms), (3, "track", True, 26 * ms),
            (3, "frame", True, 27 * ms),
            (4, "upload", False, 28 * ms), (4, "upload", True, 29 * ms),
            (4, "frame", False, 30 * ms),
            (4, "extract.points", False, 31 * ms),
            (4, "frame", True, 35 * ms),
            (-1, "calibrate", False, 36 * ms)]
    spans = [(0, "frame", 0, 30 * ms, -1, 3), (1, "wait", 20 * ms, 28 * ms,
                                               0, 3),
             (2, "frame", 31 * ms, 40 * ms, -1, 4),
             (3, "wait", 32 * ms, 33 * ms, 2, 4),
             (4, "wait", 34 * ms, 36 * ms, 2, 4)]
    rows = trace.frame_rows(recs, spans)
    assert [r["frame"] for r in rows] == [3, 4]
    a, b = rows
    assert a["device_ms"] == {
        "frame": 27.0, "extract.points": 3.0, "extract.lines": 2.0,
        "track.search_a": 2.0, "track.pose_a": 5.0, "track.search_b": 1.0,
        "track.pose_b": 10.0, "track.finish": 1.0}
    assert a["gap_ms"] is None
    assert a["host_ms"] == {"frame": 30.0, "wait": 8.0}
    # frame 4 starts at its `frame` mark, 3 ms after frame 3's end; its
    # open stage runs to the next record, its `frame.end`
    assert b["gap_ms"] == 3.0
    assert b["device_ms"] == {"upload": 1.0, "frame": 5.0,
                              "extract.points": 4.0}
    assert b["host_ms"] == {"frame": 9.0, "wait": 3.0}


def test_rings_wrap_and_readers_return_none():
    from benchmark import run as brun

    class _Run:
        def __init__(self, tracer):
            self.entry = type("E", (), {"slam": type("S", (), {
                "tracer": tracer})()})()

    tr = trace.Tracer("cpu", records=16, host_spans=8)
    readers = [brun.load_reader(n) for n in (
        "step_device_ms", "extract_device_ms", "lines_device_ms",
        "search_device_ms", "pose_opt_device_ms", "device_gap_ms",
        "host_frame_ms")]

    def window(n_frames):
        r = _Run(tr)
        undo = [m.install(r) for m in readers]
        assert undo[0] is not None and undo[1:] == [None] * 6
        for f in range(n_frames):
            with tr.frame(f, sink=[]):
                for name, end in FRAME_MARKS:
                    tr.stamp(name, end)
        undo[0]()
        assert not tr.on
        return r, [m.read(r) for m in readers]

    r, values = window(1)        # 11 records, 1 span: held
    assert all(v is not None for v in values[:5]) and values[5] is None
    assert values[0] == r.slam_trace.rows()[0]["device_ms"]["frame"]
    r, values = window(2)        # 22 records: the ring of 16 wrapped
    assert r.slam_trace.rows() is None and values == [None] * 7
    assert tr.records(r.slam_trace.start, r.slam_trace.end) is None
    tr2 = trace.Tracer("cpu", records=1024, host_spans=8)
    w = tr2.window()
    for _ in range(9):           # 9 spans: the ring of 8 wrapped
        with tr2.span("resolve"):
            pass
    w.close()
    assert w.rows() is None
    # a program without a tracer: nothing installed, nothing read
    r = _Run(None)
    assert all(m.install(r) is None and m.read(r) is None for m in readers)


def test_batched_tracker_runs_with_no_stamp(monkeypatch):
    """The vmapped multi-stream step stamps nothing (no stamp is passed to
    `track_local_map` there, and no custom op runs under vmap) and runs
    with vmap's per-example fallback off."""
    from plslam_tpu_torch.geometry import camera
    from plslam_tpu_torch.mapstate import state as tstate
    from plslam_tpu_torch.models import mapping
    from plslam_tpu_torch.ops import extract, stereo
    from plslam_tpu_torch.parallel import multistream

    def no_stamp(self, name, end=False):
        raise AssertionError(f"stamp {name} under the batched step")
    monkeypatch.setattr(trace.Tracer, "stamp", no_stamp)
    H, W, FX = 240, 320, 250.0
    cfg = tsys.SLAMConfig(fx=FX, fy=FX, cx=W / 2, cy=H / 2, width=W,
                          height=H, n_features=256, n_levels=3, max_kf=6,
                          max_pt=1024, max_ln=64, n_lf=32, ba_window=4,
                          ba_points=512, ba_lines=32, use_loop_closing=False,
                          grow_map=False)
    Ts = synthetic.trajectory(24, "orbit")
    ext_cfg = extract.ExtractorConfig(n_features=256, n_levels=3)
    sf, _ = extract.scale_factors(ext_cfg)
    cam = camera.Camera.create(FX, FX, W / 2, H / 2, width=W, height=H)
    maps, frames = [], []
    for s in range(2):
        scene = synthetic.make_scene(seed=100 + s, width=W, height=H, fx=FX,
                                     fy=FX)
        img0, depth0 = synthetic.render_rgbd(scene, Ts[0])
        f = extract.PointExtractor(ext_cfg, H, W)(
            torch.from_numpy(img0.astype(np.uint8)).to(torch.float32))
        f = f._replace(uv_un=camera.undistort_pixels(cam, f.uv))
        ms = tstate.allocate(tstate.MapConfig(
            max_kf=6, max_pt=1024, max_ln=64, n_kp=256, n_lf=32,
            n_levels=3), "cpu")
        mapping.insert_keyframe(cam, ms, f, torch.eye(4), torch.full(
            (256,), -1, dtype=torch.int32), 0, sf)
        mapping.create_points_from_depth(
            cam, ms, ms.n_kf - 1,
            stereo.depth_at(torch.from_numpy(depth0), f.uv), sf)
        maps.append(ms)
        frames.append([synthetic.render(scene, T).astype(np.uint8)
                       for T in Ts[1:3]])
    functorch = torch._C._functorch
    fallback = functorch._is_vmap_fallback_enabled()
    functorch._set_vmap_fallback_enabled(False)
    try:
        bt = multistream.BatchedTracker(cfg, 2, device="cpu")
        bt.bootstrap(tstate.stack(maps))
        for j in range(2):         # a keyframe step, then a tracking step
            T, scalars = bt.step(np.stack([f[j] for f in frames]))
            assert torch.isfinite(T).all()
            assert (scalars[:, 0] >= 10).all(), scalars
    finally:
        functorch._set_vmap_fallback_enabled(fallback)


@pytest.mark.cuda
def test_replays_append_their_records_on_card():
    """On the card: each replay of the frame graph appends exactly the
    records its capture recorded (the host's count and the device's cursor
    agree, every record read back in place); host spans turned on after
    set-up capture nothing; a replay's outputs are bit-equal with host
    spans off and on from the same state."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the stamps have no CPU kernel")
    scene = synthetic.make_scene(seed=7)
    frames = [synthetic.render(scene, T).astype(np.uint8)
              for T in synthetic.trajectory(12, "orbit")]
    slam = tsys.System(tsys.SLAMConfig(**CFG), device="cuda")
    tr = slam.tracer
    for i in range(6):
        (slam.track_synced if slam.state == "OK"
         else slam.track_monocular)(frames[i], i / 30.0)
    assert slam.state == "OK"
    captures = slam.graphs.captures
    recorded = [e.recorded.get(tr, 0)
                for e in slam._frame_step._entries.values()]
    assert recorded == [len(FRAME_MARKS)]
    mark = tr.mark()
    slam.track_synced(frames[6], 6 / 30.0)
    torch.cuda.synchronize()
    assert tr.launches - mark.records == len(FRAME_MARKS)
    assert int(tr._cursor.item()) == tr.launches
    fid = slam.frame_id
    assert [(n, e) for f, n, e, _ in tr.records(mark)] == FRAME_MARKS
    assert all(f == fid for f, _, _, _ in tr.records(mark))
    # the same state into both replays: off, then on
    state = ([t.clone() for t in vars(slam.ms).values()],
             slam.T_last.clone(), slam.velocity.clone())
    outs = []
    for on in (False, True):
        for dst, src in zip(vars(slam.ms).values(), state[0]):
            dst.copy_(src)
        tr.enable(on)
        res, f, _ = slam._frame_step(slam.ms, slam._image(frames[7]),
                                     state[1], state[2], None)
        outs.append([t.cpu() for t in (res.T, res.scalars, res.matched_pt,
                                       f.uv, f.desc)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    for i in range(8, 12):
        slam.track_synced(frames[i], i / 30.0)
    assert slam.graphs.captures == captures
    rows = tr.frames(mark)
    assert rows is not None and rows[-1]["host_ms"]["frame"] > 0
    assert all(r["device_ms"]["frame"] > 0 for r in rows
               if "frame" in r["device_ms"])
    res_ns = tr.timer_resolution_ns()
    assert res_ns is not None and 0 < res_ns <= 1000
    assert tr.clock_error_ns() < 1_000_000

"""The PyTorch port's depth-sensor System against the JAX package's:
`System.track_rgbd` over the first 6 frames of tests/test_depth_sensors.py's
RGB-D sequence (`make_scene(seed=5)`, `trajectory(18, "orbit",
amplitude=1.0)`) at that file's small widths (512 features, 3 levels, 12
keyframes x 4096 points, a 4 x 1024 BA window, lines on), the depth
keyframe chain on the JAX System's own input maps, the global BA's stereo
edges. The slow tier
runs both packages over that file's full RGB-D (18 frames) and stereo (14
frames, baseline 0.3) sequences.

Tolerances: the same keyframes (frame ids) and every frame tracked, poses
within 1e-3 (tracking's sequence bar, tests/test_torch_tracking.py); the
depth chain as tests/test_torch_mapping.py's chain: every JAX binding kept,
the port's extra bindings (writes the JAX package's scatters lose, ROADMAP
Queue 3) at most 3% of the bound slots, the same number of map points,
created points within 1e-3 and poses within 1e-3; in the slow tier
tests/test_depth_sensors.py's bars for both packages and metric ATEs within
0.01 m of each other."""
import numpy as np
import pytest
import torch

from plslam_tpu.models import system as jsys
from plslam_tpu_torch.datasets import synthetic
from plslam_tpu_torch.geometry import camera as tcam
from plslam_tpu_torch.mapstate import checkpoint as tckpt
from plslam_tpu_torch.models import mapping as tmap, system as tsys
from plslam_tpu_torch.ops import extract as text, lines as tlines

N_FRAMES = 6
SMALL = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, k1=0.0, k2=0.0, p1=0.0,
             p2=0.0, k3=0.0, n_features=512, n_levels=3, max_kf=12,
             max_pt=4096, ba_window=4, ba_points=1024, kf_max_interval=5,
             use_loop_closing=False)
STEREO_BASELINE = 0.3
TCAM = tcam.Camera.create(500.0, 500.0, 320.0, 240.0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np_map(ms):
    return {k: np.array(v) for k, v in ms._asdict().items()}


def rgbd_sequence(n=18):
    scene = synthetic.make_scene(seed=5)
    Ts = synthetic.trajectory(18, "orbit", amplitude=1.0)[:n]
    return Ts, [synthetic.render_rgbd(scene, T) for T in Ts]


def stereo_sequence(n=14):
    scene = synthetic.make_scene(seed=6)
    Ts = synthetic.trajectory(14, "orbit", amplitude=0.8)[:n]
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -STEREO_BASELINE
    return Ts, [(synthetic.render(scene, T), synthetic.render(scene, T_rl @ T))
                for T in Ts]


def _traj(slam):
    return {ts: np.asarray(T) for ts, T in slam.trajectory}


def _recording_jax_system(cfg):
    """A JAX System whose depth keyframe chains are recorded as (map
    before, arguments, map after)."""
    j = jsys.System(jsys.SLAMConfig(**cfg))
    calls, chain = [], j._process_kf[True]
    arrays = lambda f: None if f is None else {
        k: np.array(getattr(f, k)) for k in f._fields}

    def record(ms, feats, lfeats, T, matched_pt, matched_ln, frame_id,
               kp_depth, do_kf_cull):
        before = _np_map(ms)
        out = chain(ms, feats, lfeats, T, matched_pt, matched_ln, frame_id,
                    kp_depth, do_kf_cull=do_kf_cull)
        calls.append((before, dict(
            feats=arrays(feats), lfeats=arrays(lfeats), T=np.array(T),
            matched_pt=np.array(matched_pt), matched_ln=np.array(matched_ln),
            kp_depth=np.array(kp_depth), frame_id=int(frame_id),
            do_kf_cull=bool(do_kf_cull)), _np_map(out)))
        return out
    j._process_kf[True] = record
    return j, calls


@pytest.fixture(scope="module")
def rgbd_runs():
    """Both packages' Systems over the first 6 RGB-D frames with lines off
    (on the line path the reference loses BA slot 0's line observation,
    ROADMAP Queue 3, which moves the map lines of the first chain and a
    later pose by more than 1e-3), the JAX System's depth chains
    recorded."""
    Ts, frames = rgbd_sequence(N_FRAMES)
    cfg = dict(SMALL, use_lines=False)
    j, calls = _recording_jax_system(cfg)
    t = tsys.System(tsys.SLAMConfig(**cfg), device="cpu")
    for slam in (j, t):
        for i, (img, depth) in enumerate(frames):
            slam.track_rgbd(img, depth, i / 30.0)
        slam.flush()
    return Ts, j, t, calls


@pytest.fixture(scope="module")
def rgbd_chain_with_lines():
    """The JAX System with lines on over the first 2 RGB-D frames: the
    depth chain of its second keyframe, recorded."""
    _, frames = rgbd_sequence(2)
    j, calls = _recording_jax_system(SMALL)
    for i, (img, depth) in enumerate(frames):
        j.track_rgbd(img, depth, i / 30.0)
    assert len(calls) == 1
    return calls


def test_track_rgbd_matches_jax(rgbd_runs):
    Ts, j, t, calls = rgbd_runs
    n_kf = t.n_keyframes()
    assert n_kf == j.n_keyframes() >= 2 and len(calls) == n_kf - 1
    np.testing.assert_array_equal(t.ms.kf_frame_id.numpy()[:n_kf],
                                  np.asarray(j.ms.kf_frame_id)[:n_kf])
    tr_t, tr_j = _traj(t), _traj(j)
    assert sorted(tr_t) == sorted(tr_j) == [i / 30.0 for i in range(N_FRAMES)]
    gaps = [float(np.abs(tr_t[ts] - tr_j[ts]).max()) for ts in sorted(tr_j)]
    print(f"pose gaps per frame: {['%.1e' % g for g in gaps]}")
    assert max(gaps) < 1e-3
    assert t.state == j.state == "OK"
    assert t.cfg.sensor == "rgbd" and not any(s.get("lost") for s in t.stats)
    # metric depth: the first frame is the origin, and the scale is the
    # scene's (no alignment of scale)
    est = np.stack([tr_t[i / 30.0] for i in range(N_FRAMES)])
    ate = synthetic.ate_rmse(est, Ts, align_scale=False)
    print(f"keyframes {n_kf} at frames {t.ms.kf_frame_id.numpy()[:n_kf]}, "
          f"points {t.n_map_points()} / {j.n_map_points()}, metric ATE "
          f"{ate:.4f}")
    assert ate < 0.03
    # the keyframes carry right-image columns for BA's stereo edges
    assert (t.ms.kf_ur.numpy()[:n_kf] > 0).sum(1).min() > 300


@pytest.mark.parametrize("use_lines", [False, True])
def test_process_keyframe_with_depth_matches_jax(rgbd_runs,
                                                 rgbd_chain_with_lines,
                                                 use_lines):
    """The depth chain (insert with u_r, triangulations, with lines their
    triangulation and fusion, points from depth, fusion, local BA with
    stereo edges, culls) on the JAX System's own input map of its second
    keyframe, with lines off and on."""
    calls = rgbd_chain_with_lines if use_lines else rgbd_runs[3]
    before, args, after = calls[0]
    sf, s2 = text.scale_factors(text.ExtractorConfig(n_features=512,
                                                     n_levels=3))
    ms = tckpt.from_numpy(before, "cpu")
    lfeats = None if args["lfeats"] is None else tlines.LineFeatures(
        **{k: _t(v) for k, v in args["lfeats"].items()})
    tmap.process_keyframe(
        TCAM, ms, text.PointFeatures(**{k: _t(v) for k, v in
                                        args["feats"].items()}),
        lfeats, _t(args["T"]), _t(args["matched_pt"]), _t(args["matched_ln"]),
        args["frame_id"], _t(args["kp_depth"]), s2, sf, window=4,
        p_ba=1024, l_ba=256, max_depth=40.0, do_kf_cull=args["do_kf_cull"],
        use_depth=True, bf=500.0 * 0.08, tri_covis=True, tri_covis_k=3,
        sin_covis=True, sin_reverse_n=2)
    idx_t, idx_j = ms.kf_pt_idx.numpy(), after["kf_pt_idx"]
    np.testing.assert_array_equal(idx_t[idx_j >= 0], idx_j[idx_j >= 0])
    bound = (idx_t >= 0) | (idx_j >= 0)
    extra = int((idx_t != idx_j).sum())
    n_new = int(after["n_pt"]) - int(before["n_pt"])
    print(f"{extra} extra port bindings of {bound.sum()}; {n_new} new points")
    assert extra <= 0.03 * bound.sum() and n_new > 50
    assert int(ms.n_pt) == int(after["n_pt"])
    np.testing.assert_array_equal(ms.pt_valid.numpy(), after["pt_valid"])
    v = after["pt_valid"]
    np.testing.assert_allclose(ms.pt_xyz.numpy()[v], after["pt_xyz"][v],
                               atol=1e-3, rtol=1e-3)
    np.testing.assert_allclose(ms.kf_T.numpy(), after["kf_T"], atol=1e-3)
    np.testing.assert_allclose(ms.kf_ur.numpy(), after["kf_ur"], atol=1e-4)
    ln_t, ln_j = ms.kf_ln_idx.numpy(), after["kf_ln_idx"]
    np.testing.assert_array_equal(ln_t[ln_j >= 0], ln_j[ln_j >= 0])
    assert int(ms.n_ln) == int(after["n_ln"]) and (int(ms.n_ln) > 0) \
        == use_lines


def _gba_has_stereo(slam):
    kw = slam._gba_kwargs()
    sel = tmap.ba_select(slam.ms, slam.sigma2, **kw)
    return kw["use_stereo"] and sel.prob.obs_ur is not None


def _grow(slam):
    slam.n_kf_host = slam.map_cfg.max_kf - 2
    slam._maybe_grow()
    assert slam.n_growths == 1


@pytest.mark.parametrize("how", ["config", "depth frame"])
def test_global_ba_has_stereo_edges_with_a_depth_sensor(how):
    """Fault of the reference, deviated from on purpose: the JAX System
    builds its global-BA selection with stereo edges only when a depth
    frame switches a monocular config (`_ensure_depth_sensor`), and map
    growth rebuilds it without them, so its selection's `obs_ur` is None
    with `sensor` set in the config and after a growth event (both pinned
    here). The port's global BA has stereo edges whenever the System has a
    depth sensor, before and after growth, and a monocular System has
    none."""
    cfg = dict(SMALL, max_kf=6, max_pt=1024, use_loop_closing=True)
    if how == "config":
        cfg["sensor"] = "rgbd"
    t = tsys.System(tsys.SLAMConfig(**cfg), device="cpu")
    j = jsys.System(jsys.SLAMConfig(**cfg))
    assert not _gba_has_stereo(t) if how != "config" else _gba_has_stereo(t)
    if how == "depth frame":
        t._ensure_depth_sensor("rgbd")
        j._ensure_depth_sensor("rgbd")
    assert _gba_has_stereo(t) and t.loop_closer.fix_scale
    assert j.loop_closer.fix_scale
    jax_stereo = j._gba_select(j.ms).prob.obs_ur is not None
    assert jax_stereo == (how == "depth frame")
    _grow(t)
    _grow(j)
    assert _gba_has_stereo(t)
    t._start_gba()
    assert t._gba["sel"].prob.obs_ur is not None
    assert j._gba_select(j.ms).prob.obs_ur is None     # the reference's
    m = tsys.System(tsys.SLAMConfig(**dict(cfg, sensor="mono")),
                    device="cpu")
    assert not _gba_has_stereo(m) and not m.loop_closer.fix_scale


def _depth_run(package, kind):
    """tests/test_depth_sensors.py's RGB-D or stereo run on either package's
    System; returns (system, metric ATE, frames tracked)."""
    mod = jsys if package == "jax" else tsys
    if kind == "rgbd":
        Ts, frames = rgbd_sequence()
        cfg = mod.SLAMConfig(**SMALL)
    else:
        Ts, frames = stereo_sequence()
        cfg = mod.SLAMConfig(**SMALL, baseline=STEREO_BASELINE,
                             th_depth=35 * STEREO_BASELINE)
    slam = mod.System(cfg) if package == "jax" else mod.System(cfg, "cpu")
    for i, (a, b) in enumerate(frames):
        getattr(slam, f"track_{kind}")(a, b, i / 30.0)
    slam.flush()
    est = _traj(slam)
    idx = [i for i in range(len(Ts)) if i / 30.0 in est]
    ate = synthetic.ate_rmse(np.stack([est[i / 30.0] for i in idx]),
                             Ts[idx], align_scale=False)
    return slam, ate, len(idx)


@pytest.mark.slow
@pytest.mark.parametrize("kind,n_frames,min_points,max_ate",
                         [("rgbd", 18, 200, 0.03), ("stereo", 14, 150, 0.10)])
def test_depth_sensor_runs_in_both_packages(kind, n_frames, min_points,
                                            max_ate):
    """Both packages over tests/test_depth_sensors.py's full sequences:
    that file's bars for each, and metric ATEs within 0.01 m."""
    res = {p: _depth_run(p, kind) for p in ("jax", "port")}
    for p, (slam, ate, n) in res.items():
        print(f"{kind} {p}: {n} frames, {slam.n_keyframes()} keyframes, "
              f"{slam.n_map_points()} points, metric ATE {ate:.4f}")
        assert slam.state == "OK" and n == n_frames
        assert slam.n_map_points() > min_points
        assert ate < max_ate
    assert abs(res["jax"][1] - res["port"][1]) < 0.01

"""Parity of the PyTorch port's depth-sensor pieces against plslam_tpu:
`stereo_match` on tests/test_depth_sensors.py's rendered stereo pair
(`make_scene(seed=6)`, frame 3 of `trajectory(14, "orbit", amplitude=0.8)`,
baseline 0.3) at 512 features and 3 levels, the 3-dof stereo residual,
`pose_optimize` and `bundle_adjust` with stereo edges, `insert_keyframe`'s
right-image columns, and `track_local_map` on a metric map with stereo
edges.

Tolerances and why: the search's matches exact (integer Hamming distances
under the same float gates); `ok` equal except on lanes whose refined
disparity lies within 1e-3 px of a disparity gate (listed, none on this
pair); u_r within 1e-3 px (the SAD means sum 121 floats in another order
than XLA's); depth within 1e-3 relative on `ok` lanes. Residuals and
Jacobians within 1e-5 relative to max(|x|, 1). Pose optimization: T within
1e-4 and inliers within 1 (ROADMAP item 6's bar); BA within 1e-4 relative
(item 9's); `kf_ur` within 1e-4 px; tracking as tests/test_torch_tracking.py
(T within 1e-4, inliers within 2, >= 99% of `matched_pt` equal)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plslam_tpu.datasets import synthetic as jsyn
from plslam_tpu.geometry import camera as jcam, se3 as jse3
from plslam_tpu.mapstate import state as jstate
from plslam_tpu.models import mapping as jmap, tracking as jtrk
from plslam_tpu.ops import extract as jext, stereo as jst
from plslam_tpu.optim import local_ba as jba, pose_opt as jpo
from plslam_tpu.optim import residuals as jres
from plslam_tpu_torch.geometry import camera as tcam
from plslam_tpu_torch.mapstate import checkpoint as tckpt
from plslam_tpu_torch.models import mapping as tmap, tracking as ttrk
from plslam_tpu_torch.ops import extract as text, stereo as tst
from plslam_tpu_torch.optim import local_ba as tba, pose_opt as tpo
from plslam_tpu_torch.optim import residuals as tres

NF, LEVELS, FX, BASELINE = 512, 3, 500.0, 0.3
BF = FX * BASELINE
JCFG = jext.ExtractorConfig(n_features=NF, n_levels=LEVELS)
TCFG = text.ExtractorConfig(n_features=NF, n_levels=LEVELS)
JCAM = jcam.Camera.create(FX, FX, 320.0, 240.0)
TCAM = tcam.Camera.create(FX, FX, 320.0, 240.0)
DISP_GATES = (0.1, 128.0)


def _t(x):
    return torch.from_numpy(np.array(x))


def _feats(f):
    return text.PointFeatures(*[_t(getattr(f, k)) for k in f._fields])


def _rel(a, b):
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max())


def _stereo_frames(i):
    """Left and right images and the left depth of frame i of
    tests/test_depth_sensors.py's stereo sequence."""
    scene = jsyn.make_scene(seed=6)
    T = np.asarray(jsyn.trajectory(14, "orbit", amplitude=0.8)[i])
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -BASELINE
    img_l = jsyn.render(scene, T)
    img_r = jsyn.render(scene, T_rl @ T)
    _, dep = jsyn.render_rgbd(scene, T)
    return (img_l.astype(np.uint8).astype(np.float32),
            img_r.astype(np.uint8).astype(np.float32), dep, T)


def _record_best2(monkeypatch, module, box):
    """Keeps the (idx, best, second) of `module.hamming.masked_best2`."""
    orig = module.hamming.masked_best2

    def rec(D, mask):
        out = orig(D, mask)
        box.append(out)
        return out
    monkeypatch.setattr(module.hamming, "masked_best2", rec)


@pytest.fixture(scope="module")
def pair():
    """The JAX package's features of frame 3's pair and its stereo_match,
    with the search's matches, and the port's stereo_match on the same
    features."""
    img_l, img_r, dep, _ = _stereo_frames(3)
    ext = jax.jit(lambda im: jext.extract_points(im, JCFG))
    fl, fr = ext(jnp.asarray(img_l)), ext(jnp.asarray(img_r))
    sf, _ = jext.scale_factors(JCFG)
    with pytest.MonkeyPatch.context() as mp:
        box_j, box_t = [], []
        _record_best2(mp, jst, box_j)
        _record_best2(mp, tst, box_t)
        out_j = jax.jit(lambda a, b, il, ir: (jst.stereo_match(
            a, b, il, ir, FX, BASELINE, sf), box_j[-1][:2]))(
            fl, fr, jnp.asarray(img_l), jnp.asarray(img_r))
        out_t = tst.stereo_match(_feats(fl), _feats(fr), _t(img_l),
                                 _t(img_r), FX, BASELINE, _t(sf))
    (d_j, ur_j, ok_j), (idx_j, best_j) = out_j
    jax_out = dict(depth=np.asarray(d_j), ur=np.asarray(ur_j),
                   ok=np.asarray(ok_j), idx=np.asarray(idx_j),
                   best=np.asarray(best_j))
    port_out = dict(depth=out_t[0].numpy(), ur=out_t[1].numpy(),
                    ok=out_t[2].numpy(), idx=box_t[-1][0].numpy(),
                    best=box_t[-1][1].numpy())
    return dict(img_l=img_l, img_r=img_r, dep=dep, fl=fl, fr=fr,
                jax=jax_out, port=port_out)


def _depth_errors(uv, depth, dep_gt):
    d_gt = dep_gt[np.clip(np.round(uv[:, 1]).astype(int), 0, 479),
                  np.clip(np.round(uv[:, 0]).astype(int), 0, 639)]
    valid = d_gt > 0
    rel = np.abs(depth[valid] - d_gt[valid]) / d_gt[valid]
    far = d_gt[valid] > np.median(d_gt[valid])
    return int(valid.sum()), rel, rel[far]


def test_stereo_match_matches_jax(pair):
    j, t = pair["jax"], pair["port"]
    np.testing.assert_array_equal(t["idx"], j["idx"])
    np.testing.assert_array_equal(t["best"], j["best"])
    ul = np.round(np.asarray(pair["fl"].uv)[:, 0])
    near = np.zeros_like(j["ok"])
    for gate in DISP_GATES:
        for ur in (j["ur"], t["ur"]):
            near |= np.abs(ul - ur - gate) <= 1e-3
    print(f"lanes within 1e-3 px of a disparity gate: {np.nonzero(near)[0]}")
    np.testing.assert_array_equal(t["ok"][~near], j["ok"][~near])
    assert j["ok"].sum() >= 150
    np.testing.assert_allclose(t["ur"], j["ur"], atol=1e-3)
    ok = j["ok"] & t["ok"]
    np.testing.assert_allclose(t["depth"][ok], j["depth"][ok], rtol=1e-3)


def test_stereo_depth_bars_on_the_port_alone(pair):
    """tests/test_depth_sensors.py::test_stereo_depth_p90_under_2pct's bars,
    with the port's own extraction and stereo_match."""
    ext = text.PointExtractor(TCFG, 480, 640)
    fl, fr = ext(_t(pair["img_l"])), ext(_t(pair["img_r"]))
    sf, _ = text.scale_factors(TCFG)
    depth, _, ok = tst.stereo_match(fl, fr, _t(pair["img_l"]),
                                    _t(pair["img_r"]), FX, BASELINE, sf)
    ok = ok.numpy()
    n, rel, rel_far = _depth_errors(fl.uv.numpy()[ok], depth.numpy()[ok],
                                    pair["dep"])
    print(f"{n} valid matches, median {np.median(rel):.4f}, p90 "
          f"{np.percentile(rel, 90):.4f}, far p90 "
          f"{np.percentile(rel_far, 90):.4f}")
    assert n > 150
    assert np.median(rel) < 0.006
    assert np.percentile(rel, 90) < 0.02
    assert np.percentile(rel_far, 90) < 0.02


def test_gather_patches_is_the_jax_slicing():
    rng = np.random.default_rng(0)
    img = rng.uniform(0, 255, (40, 60)).astype(np.float32)
    uv = np.stack([rng.uniform(-8, 70, 50), rng.uniform(-8, 50, 50)],
                  -1).astype(np.float32)
    np.testing.assert_array_equal(
        tst._gather_patches(_t(img), _t(uv), 5).numpy(),
        np.asarray(jst._gather_patches(jnp.asarray(img), jnp.asarray(uv), 5)))


def _stereo_obs(rng, n, T, mono_share=0.3):
    """Points in front of the camera T, their noisy left pixels and right
    columns (-1 for a monocular share), per-octave variances."""
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(2, 6, n)], -1).astype(np.float32)
    Xc = X @ T[:3, :3].T + T[:3, 3]
    uv = np.stack([FX * Xc[:, 0] / Xc[:, 2] + 320,
                   FX * Xc[:, 1] / Xc[:, 2] + 240], -1)
    ur = uv[:, 0] - BF / Xc[:, 2]
    uv = uv + rng.normal(0, 0.7, uv.shape)
    ur = ur + rng.normal(0, 0.7, n)
    ur[rng.random(n) < mono_share] = -1.0
    octave = rng.integers(0, LEVELS, n)
    return (X, uv.astype(np.float32), ur.astype(np.float32),
            (1.2 ** (2 * octave)).astype(np.float32))


def test_point_residual_stereo_matches_jax():
    rng = np.random.default_rng(1)
    T = np.asarray(jse3.se3_exp(jnp.asarray(
        [0.05, -0.02, 0.03, 0.2, -0.1, 0.3], jnp.float32)))
    X, uv, ur, _ = _stereo_obs(rng, 200, T)
    out_j = jres.point_residual_stereo(JCAM, BF, jnp.asarray(T),
                                       jnp.asarray(X), jnp.asarray(uv),
                                       jnp.asarray(ur))
    out_t = tres.point_residual_stereo(TCAM, BF, _t(T), _t(X), _t(uv),
                                       _t(ur))
    for a, b in zip(out_t, out_j):
        assert _rel(a.numpy(), np.asarray(b)) < 1e-5
    mono = ur <= 0
    assert mono.any() and (~mono).any()
    assert (out_t[0].numpy()[mono, 2] == 0).all()
    assert (out_t[1].numpy()[mono, 2] == 0).all()


def test_pose_optimize_with_stereo_edges_matches_jax():
    rng = np.random.default_rng(4)
    n = 300
    T_gt = np.asarray(jse3.se3_exp(jnp.asarray(
        [0.02, -0.03, 0.01, 0.1, -0.05, 0.08], jnp.float32)))
    X, uv, ur, sigma2 = _stereo_obs(rng, n, T_gt)
    uv[:30] += rng.uniform(-40, 40, (30, 2)).astype(np.float32)    # outliers
    ur[30:40] += rng.uniform(-20, 20, 10).astype(np.float32)
    mask = rng.random(n) > 0.05
    T0 = np.asarray(jse3.se3_exp(jnp.asarray(
        [0.0, 0.0, 0.0, 0.05, 0.02, -0.03], jnp.float32)) @ jnp.asarray(T_gt))
    rj = jpo.pose_optimize(JCAM, jnp.asarray(T0), jpo.PoseObs(
        jnp.asarray(X), jnp.asarray(uv), jnp.asarray(sigma2), jnp.asarray(mask),
        *jpo.PoseObs.empty_lines(1), pt_ur=jnp.asarray(ur), bf=BF))
    rt = tpo.pose_optimize(TCAM, _t(T0), tpo.PoseObs(
        _t(X), _t(uv), _t(sigma2), _t(mask), *tpo.PoseObs.empty_lines(1),
        pt_ur=_t(ur), bf=BF))
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=1e-4)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 1
    assert int(rt.n_inliers) > 200
    assert np.abs(rt.T.numpy() - T_gt).max() < 0.02
    # the stereo gate (7.815) kept the stereo edges the mono gate would cut
    assert (rt.pt_inlier.numpy() == np.asarray(rj.pt_inlier)).mean() >= 0.99


def test_bundle_adjust_with_stereo_edges_matches_jax():
    """A 5-camera window (first two fixed) over 300 points with stereo
    observations in 70% of the cells, 5% gross outliers in either column,
    perturbed starting values; no lines."""
    rng = np.random.default_rng(0)
    K, P, L = 5, 300, 1
    xi = np.zeros((K, 6), np.float32)
    xi[:, 3] = -0.15 * np.arange(K)
    xi[:, :3] = rng.normal(0, 0.01, (K, 3))
    T_gt = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    X = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P),
                  rng.uniform(3, 6, P)], -1).astype(np.float32)
    Xc = np.einsum("kij,pj->kpi", T_gt[:, :3, :3], X) + T_gt[:, None, :3, 3]
    uv = Xc[..., :2] / Xc[..., 2:] * FX + [320.0, 240.0]
    ur = uv[..., 0] - BF / Xc[..., 2] + rng.normal(0, 0.5, (K, P))
    uv = uv + rng.normal(0, 0.5, uv.shape)
    out = rng.random((K, P)) < 0.05
    uv[out] += rng.uniform(-30, 30, (int(out.sum()), 2))
    out = rng.random((K, P)) < 0.05
    ur[out] += rng.uniform(-30, 30, int(out.sum()))
    ur[rng.random((K, P)) < 0.3] = -1.0
    T0 = T_gt.copy()
    for k in range(2, K):
        T0[k] = np.asarray(jse3.se3_exp(jnp.asarray(
            rng.normal(0, 0.01, 6).astype(np.float32))) @ jnp.asarray(T_gt[k]))
    arrays = dict(
        kf_T=T0.astype(np.float32), kf_fixed=np.arange(K) < 2,
        kf_mask=np.ones(K, bool),
        pt_xyz=(X + rng.normal(0, 0.03, X.shape)).astype(np.float32),
        pt_mask=np.ones(P, bool), obs_uv=uv.astype(np.float32),
        obs_mask=(rng.random((K, P)) < 0.8) & (Xc[..., 2] > 0),
        obs_sigma2=(1.2 ** (2 * rng.integers(0, 3, (K, P)))).astype(
            np.float32),
        ln_xyz=np.zeros((L, 2, 3), np.float32), ln_mask=np.zeros(L, bool),
        ln_obs_l2d=np.broadcast_to(np.float32([1.0, 0.0, -1e9]),
                                   (K, L, 3)).copy(),
        ln_obs_mask=np.zeros((K, L), bool), obs_ur=ur.astype(np.float32))
    pj = jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()},
                       ln_info=0.5, bf=BF)
    pt = tba.BAProblem(**{k: _t(v) for k, v in arrays.items()}, ln_info=0.5,
                       bf=BF)
    rj = jax.jit(lambda p: jba.bundle_adjust(p, JCAM))(pj)
    rt = tba.bundle_adjust(pt, TCAM)
    assert _rel(rt.kf_T.numpy(), np.asarray(rj.kf_T)) < 1e-4
    assert _rel(rt.pt_xyz.numpy(), np.asarray(rj.pt_xyz)) < 1e-4
    inl_t, inl_j = rt.obs_inlier.numpy(), np.asarray(rj.obs_inlier)
    assert (inl_t == inl_j).mean() >= 0.99
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-4)
    assert inl_j[arrays["obs_mask"]].mean() > 0.85
    np.testing.assert_array_equal(rt.kf_T.numpy()[:2], arrays["kf_T"][:2])
    # the metric stereo edges pin the free cameras near the ground truth
    assert np.abs(rt.kf_T.numpy() - T_gt).max() < 0.01


@pytest.fixture(scope="module")
def metric_map(pair):
    """A JAX map from the left frame's ground-truth depth (keyframe 0 at the
    origin), with u_r columns from that depth, as the System's RGB-D
    initialization builds it."""
    sf, _ = jext.scale_factors(JCFG)
    fl = pair["fl"]
    kd = jst.depth_at(jnp.asarray(pair["dep"]), fl.uv)
    ms = jmap.insert_keyframe(JCAM, jstate.allocate(jstate.MapConfig(
        max_kf=8, max_pt=2048, max_ln=64, n_kp=NF, n_lf=32,
        n_levels=LEVELS)), fl, jnp.eye(4), jnp.full((NF,), -1, jnp.int32),
        jnp.int32(0), sf, kp_depth=kd, bf=BF)
    return jmap.create_points_from_depth(JCAM, ms, jnp.int32(0), kd, sf), kd


def test_insert_keyframe_with_depth_matches_jax(pair, metric_map):
    """The `kf_ur` row of a keyframe whose every 7th keypoint has no depth,
    inserted as keyframe 1 of the metric map."""
    ms_j, kd = metric_map
    kd = np.array(kd)
    kd[::7] = 0.0
    sf, _ = jext.scale_factors(JCFG)
    T = np.asarray(jse3.se3_exp(jnp.asarray(
        [0.01, 0.02, 0.0, 0.05, 0.0, 0.01], jnp.float32)))
    ins_j = jmap.insert_keyframe(JCAM, ms_j, pair["fl"], jnp.asarray(T),
                                 jnp.full((NF,), -1, jnp.int32), jnp.int32(1),
                                 sf, kp_depth=jnp.asarray(kd), bf=BF)
    maps = {}
    for bf in (BF, 0.0):
        maps[bf] = tckpt.from_numpy({k: np.array(v) for k, v in
                                     ms_j._asdict().items()}, "cpu")
        tmap.insert_keyframe(TCAM, maps[bf], _feats(pair["fl"]), _t(T),
                             torch.full((NF,), -1, dtype=torch.int32), 1,
                             text.scale_factors(TCFG)[0], kp_depth=_t(kd),
                             bf=bf)
    ur_t, ur_j = maps[BF].kf_ur.numpy(), np.asarray(ins_j.kf_ur)
    np.testing.assert_allclose(ur_t, ur_j, atol=1e-4)
    assert (ur_j[1] > 0).sum() > 300 and (ur_j[1, ::7] == -1).all()
    # bf = 0 (no baseline): the row stays monocular
    np.testing.assert_array_equal(maps[0.0].kf_ur.numpy()[1], -1.0)


def test_track_local_map_with_stereo_edges_matches_jax(metric_map):
    """Both packages track frame 4 of the stereo sequence against the same
    metric JAX map from the same features, with u_r from the frame's
    depth: the jump guard runs relative to the metric scene depth."""
    ms_j, _ = metric_map
    img_l, _, dep, T_gt = _stereo_frames(4)
    fj = jax.jit(lambda im: jext.extract_points(im, JCFG))(jnp.asarray(img_l))
    kd = np.asarray(jst.depth_at(jnp.asarray(dep), fj.uv))
    uv_un = np.asarray(fj.uv_un)
    ur = np.where(np.asarray(fj.valid) & (kd > 0),
                  uv_un[:, 0] - BF / np.maximum(kd, 1e-6), -1.0
                  ).astype(np.float32)
    sf, s2 = jext.scale_factors(JCFG)
    rj, _ = jax.jit(lambda m, f, u: jtrk.track_local_map(
        JCAM, m, f, jnp.eye(4), sf, s2, n_levels=LEVELS, scale=1.2,
        kp_ur=u, bf=BF, update_stats=True))(ms_j, fj, jnp.asarray(ur))
    ms_t = tckpt.from_numpy({k: np.array(v) for k, v in
                             ms_j._asdict().items()}, "cpu")
    tsf, ts2 = text.scale_factors(TCFG)
    rt, _ = ttrk.track_local_map(TCAM, ms_t, _feats(fj), torch.eye(4), tsf,
                                 ts2, n_levels=LEVELS, scale=1.2,
                                 kp_ur=_t(ur), bf=BF, update_stats=True)
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=1e-4)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 2
    assert int(rt.n_inliers) >= 100
    assert (rt.matched_pt.numpy() == np.asarray(rj.matched_pt)).mean() >= 0.99
    # metric: the tracked pose is the ground truth's, frame 3 -> 4 relative
    T3 = np.asarray(jsyn.trajectory(14, "orbit", amplitude=0.8)[3])
    T_rel_gt = T_gt @ np.linalg.inv(T3)
    assert np.abs(rt.T.numpy() - T_rel_gt).max() < 0.02

"""Parity of the PyTorch port's tracking step against plslam_tpu at 240x320
(3 levels, 512 features, a 2048-point map), and of the map that crosses
between the packages.

Tolerances and why: pose optimization solves 6x6 float32 systems whose
einsum sums run in another order than XLA's, so poses agree within 1e-4
after one optimization (inlier counts within 1 or 2, the chi2 gate flipping
for edges at its border) and within 1e-3 over a tracked sequence, whose
extraction differs slightly at levels >= 1 (see test_torch_extract.py)."""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plslam_tpu.geometry import camera as jcam, se3 as jse3
from plslam_tpu.mapstate import checkpoint as jckpt, state as jstate
from plslam_tpu.models import mapping as jmap, tracking as jtrk
from plslam_tpu.ops import extract as jext, stereo as jstereo
from plslam_tpu.optim import pose_opt as jpo
from plslam_tpu_torch.datasets import synthetic
from plslam_tpu_torch.geometry import camera as tcam
from plslam_tpu_torch.mapstate import checkpoint as tckpt, state as tstate
from plslam_tpu_torch.models import mapping as tmap, tracking as ttrk
from plslam_tpu_torch.ops import extract as text, stereo as tstereo
from plslam_tpu_torch.optim import pose_opt as tpo
from torch_threads import one_thread  # noqa: F401

H, W, LEVELS, NF = 240, 320, 3, 512
FX = 250.0
MAP = dict(max_kf=8, max_pt=2048, max_ln=64, n_kp=NF, n_lf=32, n_levels=LEVELS)
JCFG = jext.ExtractorConfig(n_features=NF, n_levels=LEVELS)
TCFG = text.ExtractorConfig(n_features=NF, n_levels=LEVELS)
JCAM = jcam.Camera.create(FX, FX, W / 2, H / 2, width=W, height=H)
TCAM = tcam.Camera.create(FX, FX, W / 2, H / 2, width=W, height=H)
N_FRAMES = 5


def _t(x):
    return torch.from_numpy(np.array(x))


def _feats_to_torch(f):
    return text.PointFeatures(*[_t(getattr(f, k)) for k in f._fields])


@pytest.fixture(scope="module")
def seq():
    scene = synthetic.make_scene(seed=0, width=W, height=H, fx=FX, fy=FX)
    Ts = synthetic.trajectory(24, "orbit")[:N_FRAMES]
    frames, depth0 = [], None
    for i, T in enumerate(Ts):
        img, depth = synthetic.render_rgbd(scene, T)
        frames.append(img.astype(np.uint8).astype(np.float32))
        depth0 = depth if i == 0 else depth0
    return Ts, frames, depth0


@pytest.fixture(scope="module")
def jax_fns():
    sf, s2 = jext.scale_factors(JCFG)
    ext = jax.jit(lambda im: jext.extract_points(im, JCFG))
    boot = jax.jit(lambda ms, f, d: jmap.create_points_from_depth(
        JCAM, jmap.insert_keyframe(JCAM, ms, f, jnp.eye(4),
                                   jnp.full((NF,), -1, jnp.int32),
                                   jnp.int32(0), sf),
        jnp.int32(0), jstereo.depth_at(d, f.uv), sf))
    track = jax.jit(partial(jtrk.track_local_map, JCAM, scale_factors=sf,
                            sigma2_levels=s2, n_levels=LEVELS, scale=1.2,
                            update_stats=True))
    return ext, boot, track


@pytest.fixture(scope="module")
def jax_run(seq, jax_fns):
    """The JAX package over the sequence: depth bootstrap on frame 0, then
    extraction + tracking, carrying pose and velocity."""
    _, frames, depth0 = seq
    ext, boot, track = jax_fns
    feats = [ext(jnp.asarray(f)) for f in frames]
    ms0 = boot(jstate.allocate(jstate.MapConfig(**MAP)), feats[0],
               jnp.asarray(depth0))
    ms, T, vel, out = ms0, jnp.eye(4), jnp.eye(4), []
    for f in feats[1:]:
        res, ms = track(ms, f, T, velocity=vel)
        T, vel = res.T, res.velocity
        out.append(res)
    return feats, ms0, out


def _port_map(ms_jax):
    return tckpt.from_numpy({k: np.array(v) for k, v in ms_jax._asdict().items()},
                            "cpu")


def test_bootstrap_matches_jax(seq, jax_run):
    _, frames, depth0 = seq
    feats_j, ms0_j, _ = jax_run
    f = _feats_to_torch(feats_j[0])
    sf, _ = text.scale_factors(TCFG)
    ms = tstate.allocate(tstate.MapConfig(**MAP), "cpu")
    ms = tmap.insert_keyframe(TCAM, ms, f, torch.eye(4),
                              torch.full((NF,), -1, dtype=torch.int32), 0, sf)
    kd = tstereo.depth_at(_t(depth0), f.uv)
    np.testing.assert_array_equal(
        kd.numpy(), np.asarray(jstereo.depth_at(jnp.asarray(depth0),
                                                feats_j[0].uv)))
    ms = tmap.create_points_from_depth(TCAM, ms, 0, kd, sf)
    assert int(ms.n_pt) == int(ms0_j.n_pt) > 300 and int(ms.n_kf) == 1
    for name in tstate.FIELDS:
        a, b = getattr(ms, name).numpy(), np.asarray(getattr(ms0_j, name))
        assert a.dtype == b.dtype, name
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_insert_keyframe_binds_points_like_jax(seq, jax_run):
    """A second keyframe that binds tracked points: counts, normals, vote
    accumulators and descriptors as in the JAX package."""
    _, _, out = jax_run
    feats_j, ms0_j, _ = jax_run
    sf, _ = jext.scale_factors(JCFG)
    res = out[0]
    T = np.asarray(res.T)
    ms_j = jmap.insert_keyframe(JCAM, ms0_j, feats_j[1], jnp.asarray(T),
                                res.matched_pt, jnp.int32(1), sf)
    ms_t = tmap.insert_keyframe(TCAM, _port_map(ms0_j),
                                _feats_to_torch(feats_j[1]), _t(T),
                                _t(res.matched_pt), 1,
                                text.scale_factors(TCFG)[0])
    assert int(ms_t.n_kf) == 2 and (np.asarray(res.matched_pt) >= 0).sum() > 50
    for name in tstate.FIELDS:
        a, b = getattr(ms_t, name).numpy(), np.asarray(getattr(ms_j, name))
        if a.dtype == np.float32:
            np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)
        else:
            np.testing.assert_array_equal(a, b, err_msg=name)


def test_pose_optimize_matches_jax():
    rng = np.random.default_rng(4)
    n = 300
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(2, 6, n)], -1).astype(np.float32)
    T_gt = np.asarray(jse3.se3_exp(jnp.asarray(
        [0.02, -0.03, 0.01, 0.1, -0.05, 0.08], jnp.float32)))
    Xc = X @ T_gt[:3, :3].T + T_gt[:3, 3]
    uv = np.stack([FX * Xc[:, 0] / Xc[:, 2] + W / 2,
                   FX * Xc[:, 1] / Xc[:, 2] + H / 2], -1)
    uv = (uv + rng.normal(0, 0.7, uv.shape)).astype(np.float32)
    uv[:30] += rng.uniform(-40, 40, (30, 2)).astype(np.float32)    # outliers
    octave = rng.integers(0, LEVELS, n)
    sigma2 = (1.2 ** (2 * octave)).astype(np.float32)
    mask = rng.random(n) > 0.05
    T0 = np.asarray(jse3.se3_exp(jnp.asarray(
        [0.0, 0.0, 0.0, 0.05, 0.02, -0.03], jnp.float32)) @ jnp.asarray(T_gt))
    rj = jpo.pose_optimize(JCAM, jnp.asarray(T0), jpo.PoseObs(
        jnp.asarray(X), jnp.asarray(uv), jnp.asarray(sigma2), jnp.asarray(mask),
        *jpo.PoseObs.empty_lines(1)))
    rt = tpo.pose_optimize(TCAM, _t(T0), tpo.PoseObs(
        _t(X), _t(uv), _t(sigma2), _t(mask), *tpo.PoseObs.empty_lines(1)))
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=1e-4)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 1
    assert int(rt.n_inliers) > 200
    assert np.abs(rt.T.numpy() - T_gt).max() < 0.02


def test_track_local_map_on_jax_map(jax_run):
    """Both packages track frame 1 against the same JAX-built map from the
    same features."""
    feats_j, ms0_j, out = jax_run
    rj = out[0]
    ms = _port_map(ms0_j)
    sf, s2 = text.scale_factors(TCFG)
    rt, ms = ttrk.track_local_map(TCAM, ms, _feats_to_torch(feats_j[1]),
                                  torch.eye(4), sf, s2, n_levels=LEVELS,
                                  scale=1.2, velocity=torch.eye(4),
                                  update_stats=True)
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=1e-4)
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 2
    assert int(rt.n_inliers) >= 100
    same = rt.matched_pt.numpy() == np.asarray(rj.matched_pt)
    print(f"inliers port {int(rt.n_inliers)} jax {int(rj.n_inliers)}; "
          f"matched_pt equal in {same.sum()}/{same.size} slots")
    assert same.mean() >= 0.99
    np.testing.assert_array_equal(rt.visible_pts.numpy(),
                                  np.asarray(rj.visible_pts))
    np.testing.assert_array_equal(rt.scalars.numpy()[4:],
                                  np.asarray(rj.scalars)[4:])
    np.testing.assert_allclose(rt.velocity.numpy(), np.asarray(rj.velocity),
                               atol=1e-4)
    # in-place found/visible statistics, as the JAX program returns them
    np.testing.assert_array_equal(ms.pt_visible.numpy(),
                                  np.array(ms0_j.pt_visible)
                                  + np.asarray(rj.visible_pts))
    found = np.array(ms0_j.pt_found)
    np.add.at(found, rt.matched_pt.numpy()[rt.matched_pt.numpy() >= 0], 1)
    np.testing.assert_array_equal(ms.pt_found.numpy(), found)


def test_local_map_mask_matches_jax(jax_run):
    _, ms0_j, _ = jax_run
    ms_j = ms0_j
    rng = np.random.default_rng(6)
    # a map with several keyframes sharing points: rows drawn from the points
    kf_pt_idx = np.full((MAP["max_kf"], NF), -1, np.int32)
    for k in range(6):
        cols = rng.choice(NF, 200, replace=False)
        kf_pt_idx[k, cols] = rng.integers(0, 400, 200)
    ms_j = ms_j._replace(kf_pt_idx=jnp.asarray(kf_pt_idx),
                         kf_valid=jnp.asarray(np.arange(8) < 6),
                         n_kf=jnp.int32(6))
    ms_t = _port_map(ms_j)
    for window in (2, 4, 12):
        for anchor in (None, -1, 3):
            a_j = None if anchor is None else jnp.int32(anchor)
            a_t = None if anchor is None else torch.tensor(anchor, dtype=torch.int32)
            np.testing.assert_array_equal(
                ttrk.local_map_mask(ms_t, window, a_t).numpy(),
                np.asarray(jtrk.local_map_mask(ms_j, window, a_j)))


def test_slice_over_rendered_frames(seq, jax_run):
    """Extraction + tracking over the rendered frames in both packages, each
    from its own depth bootstrap."""
    Ts, frames, depth0 = seq
    _, _, out_j = jax_run
    sf, s2 = text.scale_factors(TCFG)
    extractor = text.PointExtractor(TCFG, H, W)
    f0 = extractor(_t(frames[0]))
    ms = tstate.allocate(tstate.MapConfig(**MAP), "cpu")
    tmap.insert_keyframe(TCAM, ms, f0, torch.eye(4),
                         torch.full((NF,), -1, dtype=torch.int32), 0, sf)
    tmap.create_points_from_depth(TCAM, ms, 0,
                                  tstereo.depth_at(_t(depth0), f0.uv), sf)
    T, vel = torch.eye(4), torch.eye(4)
    for i, rj in enumerate(out_j, start=1):
        f = extractor(_t(frames[i]))
        f = f._replace(uv_un=tcam.undistort_pixels(TCAM, f.uv))
        res, ms = ttrk.track_local_map(TCAM, ms, f, T, sf, s2,
                                       n_levels=LEVELS, scale=1.2,
                                       velocity=vel, update_stats=True)
        T, vel = res.T, res.velocity
        n_t, n_j = int(res.n_inliers), int(rj.n_inliers)
        print(f"frame {i}: inliers port {n_t} jax {n_j}; |dT| "
              f"{np.abs(T.numpy() - np.asarray(rj.T)).max():.2e}; "
              f"gt err {np.abs(T.numpy() - Ts[i]).max():.3f}")
        np.testing.assert_allclose(T.numpy(), np.asarray(rj.T), atol=1e-3)
        assert abs(n_t - n_j) <= 0.03 * n_j and n_t >= 100
        assert np.abs(T.numpy() - Ts[i]).max() < 0.05


def test_load_map_reads_jax_checkpoint(tmp_path, jax_run):
    _, ms0_j, _ = jax_run
    path = str(tmp_path / "map.npz")
    jckpt.save_map(ms0_j, path)
    ms = tckpt.load_map(path, "cpu")
    for name in tstate.FIELDS:
        a, b = getattr(ms, name).numpy(), np.asarray(getattr(ms0_j, name))
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    # a checkpoint written before the newer fields existed loads with the
    # JAX loader's defaults
    with np.load(path) as data:
        old = {k: data[k] for k in data.files
               if k not in ("pt_desc_acc", "pt_desc_cnt", "ln_cond", "kf_ur")}
    old_path = str(tmp_path / "old.npz")
    np.savez_compressed(old_path, **old)
    ms, ms_j = tckpt.load_map(old_path, "cpu"), jckpt.load_map(old_path)
    for name in tstate.FIELDS:
        np.testing.assert_array_equal(getattr(ms, name).numpy(),
                                      np.asarray(getattr(ms_j, name)),
                                      err_msg=name)


def test_from_numpy_rejects_bad_maps(jax_run):
    _, ms0_j, _ = jax_run
    arrays = {k: np.array(v) for k, v in ms0_j._asdict().items()}
    with pytest.raises(ValueError, match="missing"):
        tckpt.from_numpy({k: v for k, v in arrays.items() if k != "pt_xyz"},
                         "cpu")
    with pytest.raises(ValueError, match="extra"):
        tckpt.from_numpy({**arrays, "bogus": np.zeros(3)}, "cpu")
    with pytest.raises(ValueError, match="dtype"):
        tckpt.from_numpy({**arrays, "pt_xyz": arrays["pt_xyz"].astype(np.float64)},
                         "cpu")


def test_create_points_at_capacity_keeps_the_last_slot():
    """Three points fit before the map is full. The port writes the created
    lanes only; the JAX package's scatter also writes the stale value of slot
    P-1 from every other lane, which loses the point created there (its
    pt_valid stays False while kf_pt_idx binds it). Every other field and slot
    agrees."""
    from plslam_tpu.ops.extract import PointFeatures as JFeats

    n, p = 16, 40
    rng = np.random.default_rng(0)
    cfg = dict(max_kf=4, max_pt=p, max_ln=8, n_kp=n, n_lf=4, n_levels=3)
    uv = rng.uniform(20, 300, (n, 2)).astype(np.float32)
    desc = rng.integers(0, 2, (n, 256)).astype(np.uint8)
    depth = rng.uniform(1, 5, n).astype(np.float32)
    sf = np.asarray([1.0, 1.2, 1.44], np.float32)
    ms_j = jstate.allocate(jstate.MapConfig(**cfg))._replace(n_pt=jnp.int32(p - 3))
    feats = JFeats(jnp.asarray(uv), jnp.asarray(uv), jnp.ones(n),
                   jnp.zeros(n, jnp.int32), jnp.zeros(n), jnp.asarray(desc),
                   jnp.ones(n, bool))
    ms_j = jmap.insert_keyframe(JCAM, ms_j, feats, jnp.eye(4),
                                jnp.full((n,), -1, jnp.int32), jnp.int32(0),
                                jnp.asarray(sf))
    ms_t = _port_map(ms_j)
    ms_j = jmap.create_points_from_depth(JCAM, ms_j, jnp.int32(0),
                                         jnp.asarray(depth), jnp.asarray(sf))
    ms_t = tmap.create_points_from_depth(TCAM, ms_t, 0, _t(depth), _t(sf))
    assert int(ms_t.n_pt) == int(ms_j.n_pt) == p
    np.testing.assert_array_equal(ms_t.kf_pt_idx[0, :4].numpy(), [37, 38, 39, -1])
    assert ms_t.pt_valid[37:].all()
    assert not bool(np.asarray(ms_j.pt_valid)[p - 1])       # the reference's loss
    Xc = np.concatenate([(uv[2] - [W / 2, H / 2]) / FX, [1.0]]) * depth[2]
    np.testing.assert_allclose(ms_t.pt_xyz[p - 1].numpy(), Xc, atol=1e-5)
    for name in tstate.FIELDS:
        a, b = getattr(ms_t, name).numpy(), np.asarray(getattr(ms_j, name))
        if a.ndim and a.shape[0] == p:
            a, b = a[:p - 1], b[:p - 1]
        np.testing.assert_allclose(a, b, atol=1e-5, err_msg=name)


def test_track_local_map_with_lines_and_no_map_lines(jax_run):
    """Line features against a map without lines: no line is visible or
    matched, and the point result is the points-only one, bit for bit
    (the masked line edges add exact zeros). The line path against the JAX
    package is in tests/test_torch_lines.py."""
    from plslam_tpu_torch.ops import lines as tl
    feats_j, ms0_j, _ = jax_run
    sf, s2 = text.scale_factors(TCFG)
    f = _feats_to_torch(feats_j[1])
    img = np.random.default_rng(0).uniform(0, 255, (H, W)).astype(np.float32)
    lf = tl.detect_lines(_t(img), n_out=32)
    kw = dict(n_levels=LEVELS, scale=1.2, velocity=torch.eye(4))
    r0 = ttrk.track_local_map(TCAM, _port_map(ms0_j), f, torch.eye(4), sf, s2,
                              **kw)
    r1 = ttrk.track_local_map(TCAM, _port_map(ms0_j), f, torch.eye(4), sf, s2,
                              lfeats=lf, **kw)
    np.testing.assert_array_equal(r1.T.numpy(), r0.T.numpy())
    np.testing.assert_array_equal(r1.matched_pt.numpy(), r0.matched_pt.numpy())
    assert r1.matched_ln.shape == (32,) and (r1.matched_ln == -1).all()
    assert int(r1.n_ln_inliers) == 0 and not r1.visible_lns.any()
    assert r0.matched_ln.shape == (1,) and int(r0.n_ln_inliers) == 0

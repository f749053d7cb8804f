"""Parity of the PyTorch port's line path against plslam_tpu: detection and
LBD descriptors (`ops/lines`), the Hamming helpers of the line matchers, and,
on a line map built from ground-truth-posed keyframes of the line-rich scene
(`make_scene(seed=9, n_lines=24)` with flattened plane textures, the
40-frame orbit of tests/test_lines_help.py, 480x640), line triangulation,
3-view support and fusion (`models/mapping`), tracking with lines
(`models/tracking`).

Tolerances and why:
- `sobel`, the blur, the LBD pairs, `mutual_best`, `vector_mad` (an even
  count, whose median averages the two middle values): exact. The blur and
  sobel are exact against the JAX functions run op by op; in a jitted program
  XLA's CPU code fuses multiply-adds (FMA), which moves them by <= 1 ulp.
- `detect_lines`: the JAX program computes with fused multiply-adds and its
  own atan2/cos approximations (neither is bit-reproducible here), and the
  chain fit subtracts two ~1e5 moments to get a covariance of ~1, which
  turns those ulps into ~1e-2 px at the endpoints. So: `valid` equal and
  the same segments (matched by endpoints) within 0.02 px, angles within
  1e-3 (that gap over a 24 px segment), lengths within 0.01 px, descriptor
  bits <= 0.5% different (a 1e-2 px shift moves some band samples to the
  next pixel); on the drawn-segment image of tests/test_lines.py, endpoints
  within 1e-3 px, angles within 5e-5 and no differing bit. Given the same gradients and
  endpoints, the descriptors are bit-equal. On other frames a chain of
  exactly 3 blocks sits at the 24 px length floor and can fall on either
  side of it (seen on 1 of 8 frames probed).
- triangulation of lines, 3-view support, `create_new_lines`,
  `fuse_duplicate_lines`: bindings and counts exact, endpoints 5e-4
  relative.
- `_match_lines_against_map` indices and mask exact; `track_local_map`
  with lines: T within 1e-4, `matched_ln` and `matched_pt` >= 99% equal,
  inlier counts +-1 / +-2.
(`process_keyframe` with lines is held against the JAX package in
tests/test_torch_mapping.py, on the JAX System's own keyframe chain.)
"""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plslam_tpu.datasets import synthetic as jsyn
from plslam_tpu.geometry import camera as jcam
from plslam_tpu.mapstate import state as jstate
from plslam_tpu.models import mapping as jmap, tracking as jtrk
from plslam_tpu.ops import extract as jext, hamming as jham, lines as jl
from plslam_tpu.ops import pyramid as jpyr, stereo as jstereo
from plslam_tpu_torch.geometry import camera as tcam
from plslam_tpu_torch.mapstate import checkpoint as tckpt
from plslam_tpu_torch.models import mapping as tmap, tracking as ttrk
from plslam_tpu_torch.ops import extract as text, hamming as tham
from plslam_tpu_torch.ops import lines as tl, pyramid as tpyr
from torch_threads import one_thread  # noqa: F401

H, W, FX = 480, 640, 500.0
NF, LEVELS, NLF = 256, 3, 96
KF_FRAMES = (0, 3, 6)     # ground-truth-posed keyframes (the lines-help cadence)
TRACK_FRAME = 7
MAP = dict(max_kf=8, max_pt=2048, max_ln=128, n_kp=NF, n_lf=NLF,
           n_levels=LEVELS)
JCAM = jcam.Camera.create(FX, FX, W / 2, H / 2, width=W, height=H)
TCAM = tcam.Camera.create(FX, FX, W / 2, H / 2, width=W, height=H)
JCFG = jext.ExtractorConfig(n_features=NF, n_levels=LEVELS)


def _t(x):
    return torch.from_numpy(np.array(x))


def _np(tree):
    return {k: np.array(v) for k, v in tree._asdict().items()}


def _tlines(lf):
    return tl.LineFeatures(**{k: _t(v) for k, v in _np(lf).items()})


def _jax_map(arrays):
    return jstate.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _port_map(arrays):
    return tckpt.from_numpy(arrays, "cpu")


def flattened(scene):
    """The scene with its plane textures flattened to 5% contrast
    (tests/test_lines_help.py's weak-corner form)."""
    planes = [jsyn.Plane(p.origin, p.e1, p.e2, p.scale,
                         (110.0 + (p.tex - float(p.tex.mean())) * 0.05
                          ).astype(np.float32)) for p in scene.planes]
    return jsyn.Scene(planes, scene.lines, scene.points, scene.K,
                      scene.width, scene.height)


def segment_image():
    """tests/test_lines.py's four drawn segments on a noisy 240x320 image."""
    from test_lines import draw_segment
    img = np.full((240, 320), 40.0, np.float32)
    img += np.random.default_rng(0).uniform(-2, 2, (240, 320)).astype(
        np.float32)
    for a, b in [((40, 40), (250, 60)), ((60, 200), (280, 180)),
                 ((160, 30), (150, 210)), ((30, 120), (300, 120))]:
        draw_segment(img, np.asarray(a, float), np.asarray(b, float))
    return img


_J_CREATE_LINES = jax.jit(partial(jmap.create_new_lines, JCAM))


def observed_lines(segments, T, rng):
    """JAX `LineFeatures` (NLF slots, numpy) of the scene's 3-D segments
    (L, 6) seen at pose T: endpoints projected with 0.3 px of noise, each
    segment in a shuffled slot, its descriptor a fixed random row with 6
    bits flipped; valid when in front, inside the image and >= 24 px."""
    A, B = segments[:, :3], segments[:, 3:]
    proj = lambda X: (X @ T[:3, :3].T + T[:3, 3])
    Ac, Bc = proj(A), proj(B)
    uv = lambda Xc: FX * Xc[:, :2] / np.maximum(Xc[:, 2:], 1e-6) + [W / 2,
                                                                    H / 2]
    ua = uv(Ac) + rng.normal(0, 0.3, (len(A), 2))
    ub = uv(Bc) + rng.normal(0, 0.3, (len(A), 2))
    inside = lambda q: ((q >= 0) & (q < [W, H])).all(-1)
    length = np.linalg.norm(ub - ua, axis=-1)
    valid = ((Ac[:, 2] > 0.5) & (Bc[:, 2] > 0.5) & inside(ua) & inside(ub)
             & (length >= 24.0))
    desc = np.random.default_rng(5).integers(0, 2, (len(A), 256))
    for d in desc:
        d[rng.choice(256, 6, replace=False)] ^= 1
    slot = rng.permutation(NLF)[:len(A)]
    out = dict(uv_a=np.zeros((NLF, 2)), uv_b=np.zeros((NLF, 2)),
               l2d=np.zeros((NLF, 3)), angle=np.zeros(NLF),
               length=np.zeros(NLF), response=np.zeros(NLF),
               desc=np.zeros((NLF, 256)), valid=np.zeros(NLF, bool))
    l = np.cross(np.c_[ua, np.ones(len(A))], np.c_[ub, np.ones(len(A))])
    for name, value in (
            ("uv_a", ua), ("uv_b", ub),
            ("l2d", l / np.linalg.norm(l[:, :2], axis=-1, keepdims=True)),
            ("angle", np.arctan2(*(ub - ua).T[::-1]) % np.pi),
            ("length", length), ("response", length / W), ("desc", desc),
            ("valid", valid)):
        out[name][slot] = value
    return jl.LineFeatures(**{k: v.astype(np.uint8 if k == "desc" else
                                          bool if k == "valid" else
                                          np.float32)
                              for k, v in out.items()})


@pytest.fixture(scope="module")
def world():
    """The line-rich scene and its flattened-texture form (the one
    tests/test_lines_help.py tracks), the textured frames at the keyframe
    and tracking poses with their point features (the port's extractor) and
    the scene's segments observed there (`observed_lines`), and the
    JAX-built maps: `base` (the keyframes at their true poses with their
    features and depth points, no lines) and `lined` (base + the lines of
    the pairs (1, 0) and (2, 1) with support in 0)."""
    scene = jsyn.make_scene(seed=9, n_lines=24)
    Ts = jsyn.trajectory(40, "orbit", amplitude=1.0)
    extractor = text.PointExtractor(text.ExtractorConfig(
        n_features=NF, n_levels=LEVELS), H, W)
    sf, _ = jext.scale_factors(JCFG)
    rng = np.random.default_rng(11)

    @jax.jit
    def add_keyframe(ms, f, lf, T, frame_id, depth):
        k = ms.n_kf
        ms = jmap.insert_keyframe(JCAM, ms, f, T, jnp.full((NF,), -1,
                                                           jnp.int32),
                                  frame_id, sf, lfeats=lf)
        return jmap.create_points_from_depth(
            JCAM, ms, k, jstereo.depth_at(depth, f.uv), sf)

    feats, lfeats = {}, {}
    ms = jstate.allocate(jstate.MapConfig(**MAP))
    for i in KF_FRAMES + (TRACK_FRAME,):
        img, depth = jsyn.render_rgbd(scene, Ts[i])
        feats[i] = jext.PointFeatures(**{k: np.array(v) for k, v in extractor(
            _t(img.astype(np.uint8).astype(np.float32)))._asdict().items()})
        lfeats[i] = observed_lines(scene.lines, Ts[i], rng)
        if i in KF_FRAMES:
            ms = add_keyframe(ms, feats[i], lfeats[i], jnp.asarray(Ts[i]),
                              jnp.int32(i), jnp.asarray(depth))
    base = _np(ms)
    ms = _J_CREATE_LINES(ms, jnp.int32(1), jnp.int32(0))
    ms = _J_CREATE_LINES(ms, jnp.int32(2), jnp.int32(1), k_third=jnp.int32(0))
    flat_frame = jsyn.render(flattened(scene), Ts[0]).astype(np.uint8).astype(
        np.float32)
    return dict(Ts=Ts, feats=feats, lfeats=lfeats, base=base, lined=_np(ms),
                flat_frame=flat_frame, flat_lines=jax.jit(partial(
                    jl.detect_lines, n_out=NLF))(jnp.asarray(flat_frame)))


def test_sobel_blur_and_lbd_pairs_are_exact():
    img = np.random.default_rng(0).uniform(0, 255, (120, 160)).astype(
        np.float32)
    taps = torch.from_numpy(tpyr.gaussian_kernel1d(5, 1.4))
    bt = tpyr.blur(_t(img), taps)
    bj = jpyr.blur(jnp.asarray(img), 5, 1.4)
    np.testing.assert_array_equal(bt.numpy(), np.asarray(bj))
    for a, b in zip(tl.sobel(bt), jl.sobel(bj)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the jitted program fuses the multiply-adds: within an ulp
    bjit = jax.jit(lambda x: jpyr.blur(x, 5, 1.4))(jnp.asarray(img))
    np.testing.assert_allclose(bt.numpy(), np.asarray(bjit), rtol=2.5e-7)
    np.testing.assert_array_equal(tl.make_lbd_pairs(), jl.LBD_PAIRS)
    np.testing.assert_array_equal(
        tl.LineDetector(8, 8).lbd_pairs.numpy(), jl.LBD_PAIRS)


def test_mutual_best_and_vector_mad_are_exact():
    rng = np.random.default_rng(3)
    dist = rng.integers(0, 120, (40, 60)).astype(np.int32)
    mask = rng.random((40, 60)) > 0.3
    mask[5] = False                                   # a row with no pair
    got = tham.mutual_best(_t(dist), _t(mask))
    want = jham.mutual_best(jnp.asarray(dist), jnp.asarray(mask))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < int(got[3].sum()) < 40
    x = rng.integers(0, 80, 64).astype(np.int32)
    for n_valid in (0, 1, 2, 3, 10, 37):
        valid = np.zeros(64, bool)
        valid[rng.choice(64, n_valid, replace=False)] = True
        a = float(tham.vector_mad(_t(x), _t(valid)))
        b = float(jham.vector_mad(jnp.asarray(x), jnp.asarray(valid)))
        assert a == b, (n_valid, a, b)
    # an even count: the medians average the two middle values
    valid = np.zeros(64, bool)
    valid[:4] = True
    x[:4] = [1, 2, 4, 9]                  # median 3, deviations 2 1 1 6 -> 1.5
    assert float(tham.vector_mad(_t(x), _t(valid))) == pytest.approx(
        1.4826 * 1.5)
    assert float(tham.vector_mad(_t(x), _t(valid))) == float(
        jham.vector_mad(jnp.asarray(x), jnp.asarray(valid)))


def _match_segments(lt, lj, n_valid):
    """Index of the port's segment nearest each JAX segment, and the
    endpoint distance."""
    ej = np.concatenate([np.asarray(lj.uv_a), np.asarray(lj.uv_b)], 1)
    et = np.concatenate([lt.uv_a.numpy(), lt.uv_b.numpy()], 1)
    d = np.abs(ej[:n_valid, None] - et[None, :n_valid]).max(-1)
    return d.argmin(1), d.min(1)


@pytest.mark.parametrize("image", ["segments", "rendered"])
def test_detect_lines_matches_jax(world, image):
    if image == "segments":
        img, n_out, ep_tol, ang_tol, bit_tol = segment_image(), 64, 1e-3, \
            5e-5, 0.0
        lj = jax.jit(partial(jl.detect_lines, n_out=n_out))(jnp.asarray(img))
    else:
        img, n_out, ep_tol, ang_tol, bit_tol = world["flat_frame"], NLF, \
            0.02, 1e-3, 5e-3
        lj = world["flat_lines"]
    lt = tl.detect_lines(_t(img), n_out=n_out)
    vj = np.asarray(lj.valid)
    np.testing.assert_array_equal(lt.valid.numpy(), vj)
    n = int(vj.sum())
    assert n >= 4 and vj[:n].all()          # valid slots come first
    m, d = _match_segments(lt, lj, n)
    assert sorted(m) == list(range(n)) and d.max() < ep_tol, d.max()
    for name, tol in (("angle", ang_tol), ("length", 0.01),
                      ("response", 1e-5)):
        np.testing.assert_allclose(getattr(lt, name).numpy()[m],
                                   np.asarray(getattr(lj, name))[:n],
                                   atol=tol, err_msg=name)
    l2d_t, l2d_j = lt.l2d.numpy()[m], np.asarray(lj.l2d)[:n]
    np.testing.assert_allclose(l2d_t[:, :2], l2d_j[:, :2], atol=ang_tol)
    bits = (lt.desc.numpy()[m] != np.asarray(lj.desc)[:n]).mean()
    print(f"{image}: {n} segments, max endpoint gap {d.max():.2e} px, "
          f"{bits:.4%} descriptor bits differ")
    assert bits <= bit_tol


def test_lbd_descriptor_on_the_same_segments_is_exact(world):
    """The JAX package's gradients and endpoints through both descriptors."""
    lj = world["flat_lines"]
    img = jnp.asarray(world["flat_frame"])
    gx, gy = jax.jit(lambda x: jl.sobel(jpyr.blur(x, 5, 1.4)))(img)
    want = jax.jit(jl.lbd_descriptor)(gx, gy, lj.uv_a, lj.uv_b)
    got = tl.lbd_descriptor(_t(gx), _t(gy), _t(lj.uv_a), _t(lj.uv_b),
                            tl.LineDetector(H, W).lbd_pairs)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_detect_lines_with_a_mask_matches_jax(world):
    """A suppression mask over the left half: no segment there, the rest as
    in the JAX package."""
    img = world["flat_frame"]
    mask = np.ones((H, W), np.float32)
    mask[:, :W // 2] = 0.0
    lj = jax.jit(partial(jl.detect_lines, n_out=NLF))(
        jnp.asarray(img), mask=jnp.asarray(mask))
    lt = tl.detect_lines(_t(img), n_out=NLF, mask=_t(mask))
    vj = np.asarray(lj.valid)
    np.testing.assert_array_equal(lt.valid.numpy(), vj)
    n = int(vj.sum())
    m, d = _match_segments(lt, lj, n)
    assert n >= 3 and sorted(m) == list(range(n)) and d.max() < 0.02
    assert (lt.uv_a.numpy()[:n, 0] > W // 2 - 8).all()
    assert (lt.uv_b.numpy()[:n, 0] > W // 2 - 8).all()


def _lines_equal(ms_t, ms_j, n0, n1):
    """The lines created in slots n0..n1 and all line bindings."""
    assert int(ms_t.n_ln) == int(ms_j.n_ln) == n1
    np.testing.assert_array_equal(ms_t.kf_ln_idx.numpy(),
                                  np.asarray(ms_j.kf_ln_idx))
    sl = slice(n0, n1)
    for name in ("ln_valid", "ln_first_kf", "ln_n_obs", "ln_desc",
                 "ln_visible", "ln_found"):
        np.testing.assert_array_equal(getattr(ms_t, name).numpy()[sl],
                                      np.asarray(getattr(ms_j, name))[sl],
                                      name)
    for name in ("ln_xyz", "ln_cond"):
        a = getattr(ms_t, name).numpy()[sl]
        b = np.asarray(getattr(ms_j, name))[sl]
        assert (np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max() < 5e-4, name


@pytest.mark.parametrize("k_new,k_ref,k_third", [(1, 0, None), (2, 1, 0),
                                                 (2, 0, None)])
def test_create_new_lines_matches_jax(world, k_new, k_ref, k_third):
    base = world["base"]
    kw = {} if k_third is None else dict(k_third=k_third)
    ms_j = _J_CREATE_LINES(_jax_map(base), jnp.int32(k_new), jnp.int32(k_ref),
                           **{k: jnp.int32(v) for k, v in kw.items()})
    ms_t = tmap.create_new_lines(TCAM, _port_map(base), k_new, k_ref, **kw)
    n1 = int(ms_j.n_ln)
    print(f"({k_new}, {k_ref}, third {k_third}): {n1} lines")
    assert n1 >= 3
    _lines_equal(ms_t, ms_j, 0, n1)


def test_create_new_lines_disabled_or_without_third_view(world):
    """`enabled=False` leaves the map as it was; a negative third keyframe
    is the 2-view call."""
    base = world["base"]
    ms = tmap.create_new_lines(TCAM, _port_map(base), 2, 1,
                               enabled=torch.tensor(False))
    for name, value in base.items():
        np.testing.assert_array_equal(getattr(ms, name).numpy(), value, name)
    a = tmap.create_new_lines(TCAM, _port_map(base), 2, 1,
                              k_third=torch.tensor(-1))
    b = tmap.create_new_lines(TCAM, _port_map(base), 2, 1)
    for name in base:
        np.testing.assert_array_equal(getattr(a, name).numpy(),
                                      getattr(b, name).numpy(), name)


def test_third_view_support_matches_jax(world):
    lined = world["lined"]
    n = int(lined["n_ln"])
    Xa, Xb = lined["ln_xyz"][:, 0], lined["ln_xyz"][:, 1]
    for k3 in (0, 1, 2):
        got = tmap.third_view_support(TCAM, _port_map(lined), k3, _t(Xa),
                                      _t(Xb))
        want = jax.jit(partial(jmap.third_view_support, JCAM))(
            _jax_map(lined), jnp.int32(k3), jnp.asarray(Xa), jnp.asarray(Xb))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert got[:n].sum() >= 2


def test_fuse_duplicate_lines_matches_jax(world):
    """Copies of the map's lines, 1 cm away with their descriptors, merge
    into the originals; bindings rewired, counts recounted, conditioning
    upgraded."""
    arrays = {k: v.copy() for k, v in world["lined"].items()}
    n = int(arrays["n_ln"])
    src = np.arange(n)
    dst = n + src
    for name in ("ln_xyz", "ln_desc", "ln_valid", "ln_first_kf", "ln_n_obs"):
        arrays[name][dst] = arrays[name][src]
    arrays["ln_xyz"][dst] += 0.01
    arrays["ln_cond"][src] = 0.5
    arrays["n_ln"] = np.int32(2 * n)
    idx = arrays["kf_ln_idx"]
    free = np.nonzero(idx[2] < 0)[0]
    idx[2, free[:n]] = dst                    # the copies bound in keyframe 2
    ms_j = jax.jit(jmap.fuse_duplicate_lines)(_jax_map(arrays))
    ms_t = tmap.fuse_duplicate_lines(_port_map(arrays))
    for name in ("kf_ln_idx", "ln_valid", "ln_n_obs", "ln_cond"):
        np.testing.assert_array_equal(getattr(ms_t, name).numpy(),
                                      np.asarray(getattr(ms_j, name)), name)
    assert not ms_t.ln_valid[dst].any() and (ms_t.ln_cond[src] == 1.0).all()


@pytest.fixture(scope="module")
def tracked(world):
    """Both packages track the frame after the last keyframe against the
    lined map, from the last keyframe's pose, with lines."""
    sf, s2 = jext.scale_factors(JCFG)
    T_last = world["Ts"][KF_FRAMES[-1]]
    f, lf = world["feats"][TRACK_FRAME], world["lfeats"][TRACK_FRAME]
    rj, _ = jax.jit(partial(jtrk.track_local_map, JCAM, scale_factors=sf,
                            sigma2_levels=s2, n_levels=LEVELS, scale=1.2,
                            update_stats=True))(
        _jax_map(world["lined"]), f, jnp.asarray(T_last), lfeats=lf,
        velocity=jnp.eye(4))
    tsf, ts2 = text.scale_factors(text.ExtractorConfig(n_features=NF,
                                                       n_levels=LEVELS))
    ms = _port_map(world["lined"])
    rt, ms = ttrk.track_local_map(
        TCAM, ms, text.PointFeatures(**{k: _t(v) for k, v in _np(f).items()}),
        _t(T_last), tsf, ts2, lfeats=_tlines(lf), n_levels=LEVELS, scale=1.2,
        velocity=torch.eye(4), update_stats=True)
    return rj, rt, ms


def test_match_lines_against_map_matches_jax(world):
    lined = world["lined"]
    T = world["Ts"][TRACK_FRAME]
    lf = world["lfeats"][TRACK_FRAME]
    want = jax.jit(partial(jtrk._match_lines_against_map, JCAM))(
        _jax_map(lined), lf, jnp.asarray(T))
    got = ttrk._match_lines_against_map(TCAM, _port_map(lined), _tlines(lf),
                                        _t(T))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert int(got[1].sum()) >= 2


def test_track_local_map_with_lines_matches_jax(world, tracked):
    rj, rt, ms = tracked
    np.testing.assert_allclose(rt.T.numpy(), np.asarray(rj.T), atol=1e-4)
    n_t, n_j = int(rt.n_ln_inliers), int(rj.n_ln_inliers)
    print(f"line inliers port {n_t} jax {n_j}; point inliers port "
          f"{int(rt.n_inliers)} jax {int(rj.n_inliers)}")
    assert abs(n_t - n_j) <= 1 and n_j >= 2
    assert abs(int(rt.n_inliers) - int(rj.n_inliers)) <= 2
    assert (rt.matched_ln.numpy() == np.asarray(rj.matched_ln)).mean() >= 0.99
    assert (rt.matched_pt.numpy() == np.asarray(rj.matched_pt)).mean() >= 0.99
    np.testing.assert_array_equal(rt.visible_lns.numpy(),
                                  np.asarray(rj.visible_lns))
    np.testing.assert_array_equal(rt.scalars.numpy()[4:],
                                  np.asarray(rj.scalars)[4:])
    # the map's line statistics, updated in place
    lined = world["lined"]
    np.testing.assert_array_equal(
        ms.ln_visible.numpy(), lined["ln_visible"] + rt.visible_lns.numpy())
    found = lined["ln_found"].copy()
    m = rt.matched_ln.numpy()
    np.add.at(found, m[m >= 0], 1)
    np.testing.assert_array_equal(ms.ln_found.numpy(), found)

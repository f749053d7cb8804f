"""Parity of the PyTorch port's loop closing against plslam_tpu: Sim3
algebra, Horn and its RANSAC, the Sim3 LM, the essential graph, the map
operations of the correction and of growth, and the loop closer's device
stages, on the same numpy-seeded inputs.

Two maps: a hand-built one (`_synthetic_map`: 24 keyframes, banded
covisibility, keyframes 20-23 revisiting the points and place signatures
of keyframes 2-5, descriptors with ties) for the candidate selection and
the pair matching, and the map the JAX `System` builds from the first 12
frames of tests/test_reloc_e2e.py's sequence (512 features, 3 levels, a
keyframe every frame) for the geometric stages.

Tolerances: integer outputs exact (covisibility, growth, the global BA's
point selection, candidate ids and group rows, pair matches, fusion
bindings; the group scores of the candidates within 1e-6 relative, as
sums in another order); Sim3 maps within 1e-5 (including rotations of 1e-7, 1e-3 and
pi - 1e-3 rad); Horn within 1e-5 relative; Sim3 RANSAC on the JAX
package's sets the same winner and inliers within 1; the Sim3 LM and the
essential graph within 1e-4; the global-BA merge and the graph correction
within 1e-5 relative."""
from collections import namedtuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.datasets import synthetic as jsyn
from plslam_tpu.geometry import camera as jcam, se3 as jse3, sim3 as jsim3
from plslam_tpu.mapstate import state as jst
from plslam_tpu.models import loop_closing as jlc, mapping as jmap
from plslam_tpu.models import system as jsys
from plslam_tpu.ops import extract as jext
from plslam_tpu.optim import pose_graph as jpg, sim3_opt as jso
from plslam_tpu.solvers import horn as jhorn
from plslam_tpu_torch.geometry import camera as tcam, sim3 as tsim3
from plslam_tpu_torch.mapstate import checkpoint as tckpt, state as tst
from plslam_tpu_torch.models import loop_closing as tlc, mapping as tmap
from plslam_tpu_torch.ops import extract as text
from plslam_tpu_torch.optim import pose_graph as tpg, sim3_opt as tso
from plslam_tpu_torch.solvers import horn as thorn
from torch_threads import one_thread  # noqa: F401

CFG = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=512,
           n_levels=3, max_kf=16, max_pt=4096, ba_window=5, ba_points=1024,
           kf_max_interval=2, kf_min_interval=1, kf_ref_ratio=2.0,
           use_loop_closing=False, grow_map=False)
JCAM = jcam.Camera.create(500.0, 500.0, 320.0, 240.0)
TCAM = tcam.Camera.create(500.0, 500.0, 320.0, 240.0)
_, S2_J = jext.scale_factors(jext.ExtractorConfig(n_features=512,
                                                  n_levels=3))
_, S2_T = text.scale_factors(text.ExtractorConfig(n_features=512,
                                                  n_levels=3))
Res = namedtuple("Res", "kf_T pt_xyz ln_xyz")


def _t(x):
    return torch.from_numpy(np.array(x))


def _n(x):
    return x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)


def _maps(arrays):
    """The same map for both packages."""
    ms_j = jst.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})
    return ms_j, tckpt.from_numpy(arrays, "cpu")


def _sim3_j(s):
    return jsim3.Sim3(*(jnp.asarray(x) for x in s))


def _sim3_t(s):
    return tsim3.Sim3(*(_t(x) for x in s))


def _close_sim3(a, b, atol, rtol=0.0):
    for x, y in zip(a, b):
        np.testing.assert_allclose(_n(x), _n(y), atol=atol, rtol=rtol)


@pytest.fixture(scope="module")
def built():
    """The JAX System's map after frames 0-11 (numpy arrays)."""
    slam = jsys.System(jsys.SLAMConfig(**CFG))
    scene = jsyn.make_scene(seed=2)
    Ts = jsyn.trajectory(30, "orbit", amplitude=1.0)
    for i in range(12):
        slam.track_monocular(jsyn.render(scene, Ts[i]).astype(np.uint8),
                             i / 30.0)
    assert int(slam.ms.n_kf) >= 8
    return {k: np.array(v) for k, v in slam.ms._asdict().items()}


def _synthetic_map(seed=0, K=24, N=64, P=700):
    """A map of K keyframes whose keyframe k observes 48 of the points
    20 k .. 20 k + 63, keyframes 20-23 also 24 new points (ids 600 on)
    with the corners and place signatures of keyframes 2-5 (a revisit that
    made duplicates), two culled keyframes, and descriptors with repeated
    rows (ties)."""
    rng = np.random.default_rng(seed)
    a = {k: np.array(v) for k, v in jst.allocate(jst.MapConfig(
        max_kf=K, max_pt=P, max_ln=32, n_kp=N, n_lf=16,
        n_levels=3))._asdict().items()}
    n_kf = K
    idx = np.full((K, N), -1, np.int32)
    for k in range(n_kf):
        ids = 20 * k + rng.permutation(64)[:48]
        if k >= 20:
            ids[:24] = 600 + 20 * (k - 20) + rng.permutation(40)[:24]
        idx[k, :48] = ids
    idx[3, 50] = idx[3, 0]                  # a point bound twice in a row
    a["kf_pt_idx"] = idx
    a["kf_valid"][:] = True
    a["kf_valid"][[9, 15]] = False
    a["kf_kp_valid"][:] = True
    bow = rng.dirichlet(np.full(a["kf_bow"].shape[1], 0.02), K)
    bow[20:24] = 0.7 * bow[2:6] + 0.3 * bow[20:24]
    bow[13] = bow[12]                       # equal scores: ties to lower ids
    a["kf_bow"] = bow.astype(np.float32)
    desc = rng.integers(0, 2, (K, N, 256)).astype(np.uint8)
    desc[20:24, :24] = desc[2:6, :24]      # the revisit sees the same corners
    flip = rng.random((4, 24, 256)) < 0.04
    desc[20:24, :24] ^= flip.astype(np.uint8)
    desc[21, 30] = desc[21, 31]            # two equal query rows
    desc[3, 40] = desc[3, 41]              # two equal map rows
    a["kf_desc"] = desc
    a["pt_valid"][:] = True
    a["pt_xyz"] = rng.uniform(-2, 2, (P, 3)).astype(np.float32)
    a["pt_xyz"][:, 2] += 6.0
    a["kf_uv"] = rng.uniform(0, 480, (K, N, 2)).astype(np.float32)
    a["kf_octave"] = rng.integers(0, 3, (K, N)).astype(np.int32)
    T = np.tile(np.eye(4, dtype=np.float32), (K, 1, 1))
    T[:, 0, 3] = np.linspace(0, 1, K)
    a["kf_T"] = T
    a["n_kf"] = np.int32(n_kf)
    a["n_pt"] = np.int32(P)
    return a


# ---------------------------------------------------------------- Sim3
@pytest.mark.parametrize("angle", [1e-7, 1e-3, 0.7, np.pi - 1e-3])
@pytest.mark.parametrize("sigma", [0.0, 3e-5, -0.4])
def test_sim3_algebra_matches_jax(angle, sigma):
    rng = np.random.default_rng(int(angle * 1e3) + int(abs(sigma) * 1e5))
    axis = rng.normal(size=3)
    axis /= np.linalg.norm(axis)
    xi = np.concatenate([angle * axis, rng.normal(size=3), [sigma]]
                        ).astype(np.float32)
    xi2 = rng.normal(0, 0.3, 7).astype(np.float32)
    pts = rng.normal(size=(5, 3)).astype(np.float32)
    Sj, St = jsim3.expmap(jnp.asarray(xi)), tsim3.expmap(_t(xi))
    _close_sim3(St, Sj, 1e-5)
    Bj, Bt = jsim3.expmap(jnp.asarray(xi2)), tsim3.expmap(_t(xi2))
    _close_sim3(tsim3.compose(St, Bt), jsim3.compose(Sj, Bj), 1e-5)
    _close_sim3(tsim3.inverse(St), jsim3.inverse(Sj), 1e-5)
    np.testing.assert_allclose(_n(tsim3.apply(St, _t(pts))),
                               _n(jsim3.apply(Sj, jnp.asarray(pts))),
                               atol=1e-5)
    np.testing.assert_allclose(_n(tsim3.logmap(St)), _n(jsim3.logmap(Sj)),
                               atol=1e-5)
    T = _n(jse3.se3_exp(jnp.asarray(xi[:6])))
    _close_sim3(tsim3.from_se3(_t(T)), jsim3.from_se3(jnp.asarray(T)), 0)
    _close_sim3(tsim3.identity((2,)), jsim3.identity((2,)), 0)
    np.testing.assert_allclose(_n(tsim3.to_se3(St)), _n(jsim3.to_se3(Sj)),
                               atol=1e-5)


def test_horn_sim3_matches_jax():
    rng = np.random.default_rng(2)
    A = rng.normal(size=(64, 3, 3)).astype(np.float32)
    B = (1.7 * A @ _n(jse3.so3_exp(jnp.asarray([0.2, -0.1, 0.3]))).T
         + np.array([0.5, -1.0, 2.0]) + rng.normal(0, 0.05, A.shape)
         ).astype(np.float32)
    for fix_scale in (False, True):
        got = thorn.horn_sim3(_t(A), _t(B), fix_scale)
        want = jhorn.horn_sim3(jnp.asarray(A), jnp.asarray(B), fix_scale)
        _close_sim3(got, want, 1e-5, rtol=1e-5)


def _sim3_scene():
    """tests/test_loop_components.py's Sim3 scene: 80 landmarks in two
    cameras related by a Sim3 of scale 1.3, 20 correspondences corrupted."""
    rng = np.random.default_rng(3)
    n = 80
    X2 = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                   rng.uniform(4, 8, n)], -1).astype(np.float32)
    S = jsim3.Sim3(jnp.float32(1.3),
                   jse3.so3_exp(jnp.asarray([0.05, 0.1, -0.08])),
                   jnp.asarray([0.3, -0.2, 0.5]))
    X1 = np.asarray(jsim3.apply(S, jnp.asarray(X2)))
    uv1 = np.asarray(jcam.project(JCAM, jnp.asarray(X1)))
    uv2 = np.asarray(jcam.project(JCAM, jnp.asarray(X2)))
    X2[:20] += rng.uniform(1, 3, (20, 3)).astype(np.float32)
    return X1, X2, uv1, uv2, np.ones(n, bool)


def test_ransac_sim3_on_jax_sets():
    X1, X2, uv1, uv2, mask = _sim3_scene()
    key = jax.random.PRNGKey(0)
    g = jax.random.gumbel(key, (1024, len(mask)))
    sets = np.array(jax.lax.top_k(jnp.where(jnp.asarray(mask)[None], g,
                                            -jnp.inf), 3)[1])
    want = jhorn.ransac_sim3(key, *map(jnp.asarray, (X1, X2, uv1, uv2,
                                                     mask)), JCAM)
    got = thorn.ransac_sim3(None, *map(_t, (X1, X2, uv1, uv2, mask)), TCAM,
                            sets=_t(sets))
    assert bool(got.ok) == bool(want.ok) is True
    assert abs(int(got.n_inliers) - int(want.n_inliers)) <= 1
    _close_sim3(got.S12, want.S12, 1e-5, rtol=1e-5)
    assert (_n(got.inliers) != _n(want.inliers)).sum() <= 1


@pytest.mark.parametrize("fix_scale", [False, True])
def test_optimize_sim3_matches_jax(fix_scale):
    X1, X2, uv1, uv2, mask = _sim3_scene()
    init = (np.float32(1.25), _n(jse3.so3_exp(jnp.asarray(
        [0.04, 0.12, -0.07]))), np.array([0.28, -0.25, 0.45], np.float32))
    s2 = (1.2 ** np.random.default_rng(4).integers(0, 3, len(mask))
          ).astype(np.float32)
    want = jso.optimize_sim3(JCAM, _sim3_j(init), *map(jnp.asarray, (
        X1, X2, uv1, uv2, mask, s2, s2)), fix_scale=fix_scale)
    got = tso.optimize_sim3(TCAM, _sim3_t(init), *map(_t, (
        X1, X2, uv1, uv2, mask, s2, s2)), fix_scale=fix_scale)
    _close_sim3(got.S12, want.S12, 1e-4)
    assert int(got.n_inliers) == int(want.n_inliers) >= 50
    np.testing.assert_array_equal(_n(got.inliers), _n(want.inliers))


def _drift_chain(K=10):
    """tests/test_loop_components.py's essential-graph case: a circle of K
    poses with growing drift, chain edges and one loop edge carrying the
    true relative poses."""
    gt, drift = [], []
    for k in range(K):
        ang = 2 * np.pi * k / K
        gt.append(_n(jse3.se3_exp(jnp.asarray(
            [0, 0, 0, np.cos(ang), np.sin(ang), 0], jnp.float32))))
        mag = 0.05 * k
        drift.append(_n(jse3.se3_exp(jnp.asarray(
            [0.01 * k, 0, 0.005 * k, mag, 0.3 * mag, 0], jnp.float32)))
            @ gt[-1])
    ei = list(range(1, K)) + [K - 1]
    ej = list(range(K - 1)) + [0]
    rel = jsim3.compose(jsim3.from_se3(jnp.asarray(np.stack(gt)[ei])),
                        jsim3.inverse(jsim3.from_se3(
                            jnp.asarray(np.stack(gt)[ej]))))
    return (np.stack(drift), np.array(ei, np.int32), np.array(ej, np.int32),
            tuple(np.asarray(x) for x in rel))


@pytest.mark.parametrize("fix_scale", [False, True])
def test_essential_graph_matches_jax(fix_scale):
    drift, ei, ej, meas = _drift_chain()
    K, E = len(drift), len(ei)
    w = np.ones(E, np.float32)
    w[-1] = 2.0
    fixed = np.arange(K) == 0
    want = jpg.optimize_essential_graph(
        jsim3.from_se3(jnp.asarray(drift)), jnp.ones(K, bool),
        jnp.asarray(fixed), jpg.PoseGraphEdges(
            jnp.asarray(ei), jnp.asarray(ej), _sim3_j(meas),
            jnp.ones(E, bool), jnp.asarray(w)), iters=30,
        fix_scale=fix_scale)
    got = tpg.optimize_essential_graph(
        tsim3.from_se3(_t(drift)), torch.ones(K, dtype=torch.bool),
        _t(fixed), tpg.PoseGraphEdges(_t(ei), _t(ej), _sim3_t(meas),
                                      torch.ones(E, dtype=torch.bool),
                                      _t(w)), iters=30, fix_scale=fix_scale)
    _close_sim3(got, want, 1e-4)
    moved = np.abs(_n(want.t) - drift[:, :3, 3]).max()
    assert moved > 0.05        # the graph did move the drifted poses


# ------------------------------------------------------------ map state
@pytest.mark.parametrize("which", ["built", "synthetic"])
def test_covisibility_matches_jax(built, which):
    arrays = built if which == "built" else _synthetic_map()
    ms_j, ms_t = _maps(arrays)
    want = np.asarray(jst.covisibility(ms_j))
    np.testing.assert_array_equal(_n(tst.covisibility(ms_t)), want)
    np.testing.assert_array_equal(_n(tst.covisibility(ms_t, 30)),
                                  np.asarray(jst.covisibility(ms_j, 30)))
    assert want.sum() > 0


def test_grow_matches_jax(built):
    ms_j, ms_t = _maps(built)
    cfg = jst.MapConfig(max_kf=32, max_pt=8192, max_ln=2048, n_kp=512,
                        n_lf=256, n_levels=3)
    want = jst.grow(ms_j, cfg)
    got = tst.grow(ms_t, tst.MapConfig(*cfg))
    for name, w in want._asdict().items():
        g = _n(getattr(got, name))
        assert g.dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


def test_ba_select_rank_by_obs_matches_jax(built):
    """The global BA's selection with a point budget that binds: the most
    observed points, newer ids breaking ties in groups of 8."""
    ms_j, ms_t = _maps(built)
    kw = dict(window=16, p_ba=96, l_ba=64, rank_by_obs=True)
    want = jmap.ba_select(ms_j, S2_J, **kw)
    got = tmap.ba_select(ms_t, S2_T, **kw)
    assert int(np.asarray(want.sel_ok).sum()) == 96
    for name in ("ids_c", "kf_mask", "sel", "sel_ok", "lsel_ok", "has",
                 "l_has"):
        np.testing.assert_array_equal(_n(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    has = np.asarray(want.has)
    np.testing.assert_array_equal(_n(got.slot_safe)[has],
                                  np.asarray(want.slot_safe)[has])


# ------------------------------------------------------- the loop closer
def _closers(arrays):
    cfg = jst.MapConfig(*(int(arrays[f].shape[0]) for f in (
        "kf_T", "pt_xyz", "ln_xyz")), n_kp=arrays["kf_uv"].shape[1],
        n_lf=arrays["kf_ln_valid"].shape[1], n_levels=3)
    j = jlc.LoopClosing(JCAM, cfg, S2_J, None, use_jit=False)
    t = tlc.LoopClosing(TCAM, tst.MapConfig(*cfg), S2_T)
    return j, t


@pytest.mark.parametrize("k", [20, 22, 23])
def test_detect_inputs_match_jax(k):
    arrays = _synthetic_map()
    ms_j, ms_t = _maps(arrays)
    lj, lt = _closers(arrays)
    want = lj._detect_inputs_impl(ms_j, jnp.int32(k))
    got = lt._detect_inputs(ms_t, k)
    np.testing.assert_array_equal(_n(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(_n(got[2]), np.asarray(want[2]))
    # group scores: sums of 4096 minima, added in another order
    np.testing.assert_allclose(_n(got[1]), np.asarray(want[1]), rtol=1e-6)
    assert (np.asarray(want[1]) > 0).any()


@pytest.mark.parametrize("k,c", [(21, 3), (20, 2), (22, 9), (5, 6)])
def test_match_pairs_match_jax(k, c):
    """K1's plain path, forward and reverse, against the JAX package's
    masked best-2 and column argmin: ties (repeated descriptor rows) and an
    empty side (keyframe 9's bindings cleared) included."""
    arrays = _synthetic_map()
    arrays["kf_pt_idx"][9] = -1
    arrays["kf_pt_idx"][21, 5:10] = -1
    ms_j, ms_t = _maps(arrays)
    lj, lt = _closers(arrays)
    want = lj._match_pairs_impl(ms_j, k, c)
    got = lt._match_pairs(ms_t, k, c)
    for name, g, w in zip(("idx", "ok"), got, want):
        np.testing.assert_array_equal(_n(g).astype(np.int64),
                                      np.asarray(w).astype(np.int64),
                                      err_msg=name)
    for g, w in zip(got[2:], want[2:]):
        np.testing.assert_allclose(_n(g), np.asarray(w), atol=1e-5)
    if (k, c) == (21, 3):
        assert np.asarray(want[1]).sum() >= 10


def test_match_pairs_on_the_built_map(built):
    ms_j, ms_t = _maps(built)
    lj, lt = _closers(built)
    n_kf = int(built["n_kf"])
    want = lj._match_pairs_impl(ms_j, n_kf - 1, 0)
    got = lt._match_pairs(ms_t, n_kf - 1, 0)
    np.testing.assert_array_equal(_n(got[0]), np.asarray(want[0]))
    np.testing.assert_array_equal(_n(got[1]), np.asarray(want[1]))
    assert np.asarray(want[1]).sum() >= 20


def _with_duplicates(arrays, k, c, n_dup=20, n_free=10):
    """Copies of points that keyframes k and c both observe, in free slots,
    with k rebound to the copies (the duplicates a revisit creates), and
    n_free of k's other shared keypoints unbound."""
    a = {n: v.copy() for n, v in arrays.items()}
    P = a["pt_xyz"].shape[0]
    shared = np.intersect1d(a["kf_pt_idx"][k], a["kf_pt_idx"][c])
    shared = shared[shared >= 0]
    assert len(shared) >= n_dup + n_free
    n_pt = int(a["n_pt"])
    for i, p in enumerate(shared[:n_dup]):
        q = n_pt + i
        for f in ("pt_xyz", "pt_desc", "pt_normal", "pt_min_dist",
                  "pt_max_dist", "pt_valid", "pt_n_obs", "pt_visible",
                  "pt_found"):
            a[f][q] = a[f][p]
        a["pt_first_kf"][q] = k
        a["kf_pt_idx"][k][a["kf_pt_idx"][k] == p] = q
    for p in shared[n_dup:n_dup + n_free]:
        a["kf_pt_idx"][k][a["kf_pt_idx"][k] == p] = -1
    a["n_pt"] = np.int32(min(n_pt + n_dup, P))
    return a


def test_loop_fuse_matches_jax(built):
    n_kf = int(built["n_kf"])
    k, c = n_kf - 1, 0
    arrays = _with_duplicates(built, k, c)
    ms_j, ms_t = _maps(arrays)
    P = arrays["pt_xyz"].shape[0]
    rows = arrays["kf_pt_idx"][c]
    cand = np.zeros(P, bool)
    cand[rows[rows >= 0]] = True
    cand &= arrays["pt_valid"]
    want = jmap.loop_fuse(JCAM, ms_j, jnp.int32(k), jnp.asarray(cand))
    got = tmap.loop_fuse(TCAM, ms_t, k, _t(cand))
    for name in ("kf_pt_idx", "pt_n_obs", "pt_valid"):
        np.testing.assert_array_equal(_n(getattr(got, name)),
                                      np.asarray(getattr(want, name)),
                                      err_msg=name)
    # the copies were replaced by the originals and freed
    assert (~np.asarray(want.pt_valid)[int(built["n_pt"]):
                                        int(arrays["n_pt"])]).sum() >= 10


def test_gba_merge_matches_jax(built):
    """A global BA selected when the map had n_kf - 3 keyframes, merged
    into the map with 3 more: the window's poses and points take the
    solution, the newer keyframes walk their spanning-tree parents, the
    other landmarks follow their reference keyframe."""
    rng = np.random.default_rng(8)
    n_kf = int(built["n_kf"])
    start = n_kf - 3
    at_start = dict(built, n_kf=np.int32(start))
    old = built["kf_T"].copy()
    old[:, :3, 3] += rng.normal(0, 0.02, (old.shape[0], 3))
    ms_j, ms_t = _maps(built)
    sj = jmap.ba_select(_maps(at_start)[0], S2_J, window=16, p_ba=4096,
                        l_ba=64, rank_by_obs=True)
    st = tmap.ba_select(_maps(at_start)[1], S2_T, window=16, p_ba=4096,
                        l_ba=64, rank_by_obs=True)
    W = np.asarray(sj.ids_c).shape[0]
    dT = np.stack([_n(jse3.se3_exp(jnp.asarray(
        rng.normal(0, 0.01, 6).astype(np.float32)))) for _ in range(W)])
    res = Res(dT @ built["kf_T"][np.asarray(sj.ids_c)],
              built["pt_xyz"][np.asarray(sj.sel)]
              + rng.normal(0, 0.01, (4096, 3)).astype(np.float32),
              built["ln_xyz"][np.asarray(sj.lsel)])
    want = jmap.gba_merge(ms_j, sj, Res(*map(jnp.asarray, res)),
                          jnp.asarray(old), jnp.int32(start))
    got = tmap.gba_merge(ms_t, st, Res(*map(_t, res)), _t(old), start)
    for name in ("kf_T", "pt_xyz", "ln_xyz"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(_n(getattr(got, name)), w,
                                   rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
    assert np.abs(np.asarray(want.kf_T) - built["kf_T"]).max() > 1e-3


def test_correct_matches_jax(built):
    """The essential-graph correction on the built map: the edges built on
    the host from the covisibility, the relative measurements, the solve,
    and the poses, points and lines moved (`_apply_graph`)."""
    ms_j, ms_t = _maps(built)
    lj, lt = _closers(built)
    n_kf = int(built["n_kf"])
    k, c = n_kf - 1, 0
    T = built["kf_T"]
    rel = T[k] @ np.linalg.inv(T[c])
    xi = _n(jsim3.logmap(jsim3.from_se3(jnp.asarray(rel))))
    S_kc = tuple(np.asarray(x) for x in jsim3.expmap(jnp.asarray(
        xi + np.array([0.01, -0.02, 0.01, 0.03, 0.0, -0.02, 0.05],
                      np.float32))))
    want = lj.correct(ms_j, k, c, _sim3_j(S_kc))
    got = lt.correct(ms_t, k, c, _sim3_t(S_kc))
    for name in ("kf_T", "pt_xyz", "ln_xyz"):
        w = np.asarray(getattr(want, name))
        np.testing.assert_allclose(_n(getattr(got, name)), w,
                                   rtol=1e-5, atol=1e-5 * np.abs(w).max(),
                                   err_msg=name)
    assert np.abs(np.asarray(want.kf_T) - T).max() > 1e-3
    assert len(lt.loop_edges) == len(lj.loop_edges) == 1


@pytest.mark.slow
def test_circuit_closes_in_both_packages():
    """tests/test_loop_closure_e2e.py's circuit through both packages'
    Systems at that test's widths: both close the loop and hold that test's
    bars plus a growth event (`chip_smoke.loop_failures`)."""
    import dataclasses
    import chip_smoke
    from plslam_tpu_torch.models import system as tsys
    Ts, frames = chip_smoke.render_loop_sequence()
    cfg = chip_smoke.loop_config()
    for slam in (jsys.System(jsys.SLAMConfig(**dataclasses.asdict(cfg))),
                 tsys.System(cfg, device="cpu")):
        for i, img in enumerate(frames):
            slam.track_monocular(img, i / 30.0)
        slam.flush()
        m = chip_smoke.loop_metrics(slam, Ts)
        assert not chip_smoke.loop_failures(m), m

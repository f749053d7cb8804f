"""Parity of the PyTorch port's relocalization against plslam_tpu: BoW
scoring, EPnP and RANSAC PnP, the candidate gate and `relocalize` on a map
the JAX `System` built from the first 12 frames of tests/test_reloc_e2e.py's
kidnap sequence (`make_scene(seed=2)`, orbit) at that test's widths (512
features, 3 levels, 16 keyframes x 4096 points, a keyframe every frame).

Tolerances: integer outputs exact (score ranks, candidate ids, the point
mask); single EPnP hypotheses on noisy 8-point sets R and t within 1e-4
where both eigh calls sign the control points alike (see that test for
why not 4-point sets); single DLT hypotheses as close to float64 as JAX's;
RANSAC PnP on the JAX package's own minimal sets: both winners within the
reference test's bars of the ground truth, EPnP inliers within 2 and,
refined, poses within 1e-4 and inliers within 1 (the winner may be
another set of the same consensus); `relocalize` on the same sets: `ok`
and the anchor keyframe equal, T within 1e-4, inliers within 2 (two staged
LMs whose 6x6 sums run in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.datasets import synthetic as jsyn
from plslam_tpu.geometry import camera as jcam, se3 as jse3
from plslam_tpu.models import system as jsys, tracking as jtrk
from plslam_tpu.ops import hamming as jham
from plslam_tpu.solvers import pnp as jpnp
from plslam_tpu.vocab import bow as jbow
from plslam_tpu_torch.geometry import camera as tcam
from plslam_tpu_torch.mapstate import checkpoint as tckpt
from plslam_tpu_torch.models import system as tsys, tracking as ttrk
from plslam_tpu_torch.ops import extract as text
from plslam_tpu_torch.solvers import pnp as tpnp
from plslam_tpu_torch.vocab import bow as tbow
from torch_threads import one_thread  # noqa: F401

CFG = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=512,
           n_levels=3, max_kf=16, max_pt=4096, ba_window=5, ba_points=1024,
           kf_max_interval=2, kf_min_interval=1, kf_ref_ratio=2.0,
           use_loop_closing=False, grow_map=False)
JCAM = jcam.Camera.create(500.0, 500.0, 320.0, 240.0)
TCAM = tcam.Camera.create(500.0, 500.0, 320.0, 240.0)
QUERIES = (9, 16)   # a mapped frame and one 4 frames past the map


def _t(x):
    return torch.from_numpy(np.array(x))


def _port_map(ms):
    return tckpt.from_numpy({k: np.array(v) for k, v in ms._asdict().items()},
                            "cpu")


def _port_feats(f):
    return text.PointFeatures(*[_t(getattr(f, k)) for k in f._fields])


@pytest.fixture(scope="module")
def built():
    """The JAX System over frames 0-11, and its features of the queries."""
    slam = jsys.System(jsys.SLAMConfig(**CFG))
    scene = jsyn.make_scene(seed=2)
    Ts = jsyn.trajectory(30, "orbit", amplitude=1.0)
    frames = [jsyn.render(scene, T).astype(np.uint8) for T in Ts]
    for i in range(12):
        slam.track_monocular(frames[i], i / 30.0)
    assert slam.n_kf_host > 5
    feats = {q: slam._extract(jnp.asarray(frames[q]))[0] for q in QUERIES}
    return slam, feats


def _gumbel_sets(key, mask, n_iters, n_min):
    """The JAX package's minimal sets: Gumbel top-k over `mask`."""
    g = jax.random.gumbel(key, (n_iters, mask.shape[0]))
    g = jnp.where(jnp.asarray(mask)[None, :], g, -jnp.inf)
    return torch.from_numpy(np.array(jax.lax.top_k(g, n_min)[1]))


def test_l1_score_ranks_match_jax():
    rng = np.random.default_rng(0)
    W = rng.dirichlet(np.full(tbow.N_WORDS, 0.05), 24).astype(np.float32)
    W[7] = W[3]                      # a tie: the lower id ranks first
    v = rng.dirichlet(np.full(tbow.N_WORDS, 0.05)).astype(np.float32)
    got = tbow.l1_score(_t(v), _t(W))
    want = np.asarray(jbow.l1_score(jnp.asarray(v), jnp.asarray(W)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    order_t = torch.sort(got, descending=True, stable=True)[1].numpy()
    np.testing.assert_array_equal(order_t,
                                  np.asarray(jax.lax.top_k(want, 24)[1]))


@pytest.mark.parametrize("min_score", [0.0, 0.3])
def test_detect_candidates_matches_jax(min_score):
    rng = np.random.default_rng(5)
    q = rng.dirichlet(np.full(tbow.N_WORDS, 0.05)).astype(np.float32)
    W = rng.dirichlet(np.full(tbow.N_WORDS, 0.05), 12).astype(np.float32)
    W[[2, 5, 9]] = q                 # equal best scores: ties to lower ids
    kf_mask = np.arange(12) < 11
    exclude = np.isin(np.arange(12), [0, 5])
    got = tbow.detect_candidates(_t(q), _t(W), _t(kf_mask), _t(exclude),
                                 min_score)
    want = jbow.detect_candidates(jnp.asarray(q), jnp.asarray(W),
                                  jnp.asarray(kf_mask), jnp.asarray(exclude),
                                  min_score)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=1e-6)


def _scene(n=120, seed=0, noise=0.5):
    """tests/test_loop_components.py's PnP scene."""
    rng = np.random.default_rng(seed)
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(4, 8, n)], -1).astype(np.float32)
    xi = np.array([0.06, -0.04, 0.02, 0.4, -0.3, 0.15], np.float32)
    T = np.asarray(jse3.se3_exp(jnp.asarray(xi)))
    Xc = (T[:3, :3] @ X.T).T + T[:3, 3]
    uv = np.asarray(jcam.project(JCAM, jnp.asarray(Xc)))
    uv = uv + rng.normal(0, noise, uv.shape).astype(np.float32)
    return X, T, uv.astype(np.float32), rng


def test_epnp_minimal_matches_jax_on_noisy_sets():
    """Single EPnP hypotheses on noisy 8-point sets (1 px): R and t within
    1e-4 wherever both packages' eigh returns the control points' principal
    axes with the same signs (LAPACK's choice; with noise the algebraic EPnP
    solution depends on the control points, by up to ~1e-2 here). With 4
    points M (8 x 12) has a 4-dimensional null space, noise or not, so its
    basis and the case-1 start are arbitrary in both packages: 4-point
    hypotheses are compared through RANSAC and relocalization below."""
    X, _, uv, rng = _scene(n=192, noise=1.0)
    xn = np.stack([(uv[:, 0] - 320.0) / 500.0, (uv[:, 1] - 240.0) / 500.0],
                  -1).astype(np.float32)
    X, xn = X.reshape(24, 8, 3), xn.reshape(24, 8, 2)
    Rt, tt = tpnp._epnp_minimal(_t(X), _t(xn))
    Rj, tj = jax.vmap(jpnp._epnp_minimal)(jnp.asarray(X), jnp.asarray(xn))
    A = X - X.mean(1, keepdims=True)
    cov = np.einsum("bsi,bsj->bij", A, A) / 8
    Vj = np.asarray(jax.vmap(jnp.linalg.eigh)(jnp.asarray(cov))[1])
    Vt = torch.linalg.eigh(_t(cov))[1].numpy()
    same = (np.einsum("bij,bij->bj", Vj, Vt) > 0).all(1)
    assert same.sum() >= 12
    np.testing.assert_allclose(Rt.numpy()[same], np.asarray(Rj)[same],
                               atol=1e-4)
    np.testing.assert_allclose(tt.numpy()[same], np.asarray(tj)[same],
                               atol=1e-4)


def test_dlt_hypotheses_as_close_to_float64_as_jax():
    """Single 6-point DLT hypotheses on noisy sets (0.5 px): M^T M squares
    the DLT's condition number, so float32 poses scatter around the float64
    solution of the same algorithm; the port's scatter is held to the JAX
    package's (median within 1.5x + 1e-4)."""
    X, _, uv, _ = _scene(n=192)
    xn = np.stack([(uv[:, 0] - 320.0) / 500.0, (uv[:, 1] - 240.0) / 500.0],
                  -1).astype(np.float32)
    X, xn = X.reshape(32, 6, 3), xn.reshape(32, 6, 2)
    _, t64 = tpnp._pose_from_projection(
        tpnp._dlt_projection(_t(X).double(), _t(xn).double()))
    _, tt = tpnp._pose_from_projection(tpnp._dlt_projection(_t(X), _t(xn)))
    _, tj = jax.vmap(jpnp._pose_from_projection)(
        jax.vmap(jpnp._dlt_projection)(jnp.asarray(X), jnp.asarray(xn)))
    err_t = np.abs(tt.numpy() - t64.numpy()).max(-1)
    err_j = np.abs(np.asarray(tj) - t64.numpy()).max(-1)
    assert np.median(err_t) <= 1.5 * np.median(err_j) + 1e-4, (
        np.median(err_t), np.median(err_j))


@pytest.mark.parametrize("minimal,n_min", [("epnp", 4), ("dlt", 6)])
def test_ransac_pnp_on_jax_sets(minimal, n_min):
    """RANSAC PnP on the JAX package's own minimal sets, in
    tests/test_loop_components.py's scene (0.5 px noise, 25% outliers).
    Single float32 hypotheses are not comparable across the packages
    (4-point EPnP's null basis is arbitrary, see above; the DLT's float32
    scatter, above), so the winner may be another set of the same
    consensus: both succeed, both winners hold that file's bars against
    the ground truth (rotation 0.02, translation 0.1, under 5 outliers
    kept), EPnP's inlier counts agree within 2; after the staged refinement
    `relocalize` applies to the winner, poses within 1e-4 and inliers
    within 1."""
    from plslam_tpu.optim import pose_opt as jpo
    from plslam_tpu_torch.optim import pose_opt as tpo
    X, T, uv, rng = _scene()
    uv[:30] += rng.uniform(40, 120, (30, 2)).astype(np.float32)
    mask = np.ones(len(X), bool)
    mask[-10:] = False
    key = jax.random.PRNGKey(3)
    want = jpnp.ransac_pnp(key, jnp.asarray(X), jnp.asarray(uv),
                           jnp.asarray(mask), JCAM, minimal=minimal)
    got = tpnp.ransac_pnp(None, _t(X), _t(uv), _t(mask), TCAM,
                          minimal=minimal,
                          sets=_gumbel_sets(key, mask, 256, n_min))
    assert bool(got.ok) == bool(want.ok) is True
    if minimal == "epnp":
        assert abs(int(got.n_inliers) - int(want.n_inliers)) <= 2
    for res in (got, want):
        d = np.asarray(jse3.se3_log(jnp.asarray(
            np.asarray(res.T) @ np.linalg.inv(T))))
        assert np.linalg.norm(d[:3]) < 0.02 and np.linalg.norm(d[3:]) < 0.1
        assert np.asarray(res.inliers)[:30].sum() < 5
    ones = np.ones(len(X), np.float32)
    out_j = jpo.pose_optimize(JCAM, want.T, jpo.PoseObs(
        jnp.asarray(X), jnp.asarray(uv), jnp.asarray(ones), jnp.asarray(mask),
        *jpo.PoseObs.empty_lines(1)))
    out_t = tpo.pose_optimize(TCAM, got.T, tpo.PoseObs(
        _t(X), _t(uv), _t(ones), _t(mask), *tpo.PoseObs.empty_lines(1)))
    np.testing.assert_allclose(out_t.T.numpy(), np.asarray(out_j.T),
                               atol=1e-4)
    assert abs(int(out_t.n_inliers) - int(out_j.n_inliers)) <= 1


@pytest.mark.parametrize("no_bow", [False, True])
def test_reloc_candidate_mask_matches_jax(built, no_bow):
    """The candidate gate on the built map; a map without BoW signatures
    falls back to every valid point."""
    slam, feats = built
    arrays = {k: np.array(v) for k, v in slam.ms._asdict().items()}
    if no_bow:
        arrays["kf_bow"][:] = 0.0
    ms_j = type(slam.ms)(**{k: jnp.asarray(v) for k, v in arrays.items()})
    f = feats[QUERIES[1]]
    want = jtrk.reloc_candidate_mask(ms_j, f)
    got = ttrk.reloc_candidate_mask(tckpt.from_numpy(arrays, "cpu"),
                                    _port_feats(f))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert got[0].sum() > 0


def _jax_ok(ms, f):
    """The match mask `jtrk.relocalize` hands to RANSAC."""
    pt_mask, _, _ = jtrk.reloc_candidate_mask(ms, f)
    D = jham.distance_matrix(f.desc, ms.pt_desc)
    idx, best, second = jham.masked_best2(D, f.valid[:, None]
                                          & pt_mask[None, :])
    ok = (best <= 50) & (best.astype(jnp.float32)
                         < 0.75 * second.astype(jnp.float32))
    return jham.dedup_by_target(idx, ok, best, ms.pt_xyz.shape[0])


@pytest.mark.parametrize("query", QUERIES)
def test_relocalize_matches_jax(built, query):
    slam, feats = built
    f = feats[query]
    key = jax.random.PRNGKey(7 + query)
    ok_j, T_j, n_j, anchor_j = slam._relocalize(slam.ms, f, key=key)
    sets = _gumbel_sets(key, np.asarray(_jax_ok(slam.ms, f)), 256, 4)
    sf, s2 = text.scale_factors(text.ExtractorConfig(n_features=512,
                                                     n_levels=3))
    ok_t, T_t, n_t, anchor_t = ttrk.relocalize(
        TCAM, _port_map(slam.ms), _port_feats(f), s2, None, sf, n_levels=3,
        scale=1.2, min_inliers=50, sets=sets)
    assert bool(ok_t) == bool(ok_j) is True
    assert int(anchor_t) == int(anchor_j)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-4)
    assert abs(int(n_t) - int(n_j)) <= 2


def test_relocalize_draws_its_own_sets(built):
    """Sets from a seeded CPU generator: the same pose as the JAX package's
    draw within 1e-2 (another draw, the same staged refinement)."""
    slam, feats = built
    f = feats[QUERIES[1]]
    ok_j, T_j, _, _ = slam._relocalize(slam.ms, f,
                                       key=jax.random.PRNGKey(0))
    sf, s2 = text.scale_factors(text.ExtractorConfig(n_features=512,
                                                     n_levels=3))
    ok_t, T_t, _, _ = ttrk.relocalize(
        TCAM, _port_map(slam.ms), _port_feats(f), s2,
        torch.Generator().manual_seed(0), sf, n_levels=3, scale=1.2)
    assert bool(ok_t) and bool(ok_j)
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=1e-2)


@pytest.mark.slow
def test_kidnap_recovery_both_packages():
    """tests/test_reloc_e2e.py's kidnap through both packages' Systems:
    both recover and hold the test's bars."""
    import chip_smoke
    Ts, frames = chip_smoke.render_reloc_sequence()
    small = dict(CFG, use_loop_closing=True, grow_map=True)
    xi = np.array(chip_smoke.KIDNAP_XI, np.float32)

    def kidnap_jax(slam):
        slam.velocity = jnp.eye(4)
        slam.T_last = jse3.se3_exp(jnp.asarray(xi))

    def kidnap_port(slam):
        from plslam_tpu_torch.geometry import se3
        slam.velocity = torch.eye(4)
        slam.T_last = se3.se3_exp(torch.from_numpy(xi))

    for make, kidnap in (
            (lambda: jsys.System(jsys.SLAMConfig(**small)), kidnap_jax),
            (lambda: tsys.System(tsys.SLAMConfig(**small), device="cpu"),
             kidnap_port)):
        r = chip_smoke.run_kidnap(make(), frames, Ts, kidnap)
        assert not chip_smoke.reloc_failures(r), r

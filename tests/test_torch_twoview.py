"""Parity of the PyTorch port's monocular bootstrap against plslam_tpu:
`match_frames` (through K1's plain version on the CPU), the rotation
histogram, and the two-view H/F initializer fed the JAX package's own
minimal sets, on two rendered 640x480 frames of the system sequence
(`make_scene(seed=1)`, orbit) at 512 features and 3 levels.

Tolerances: integer outputs (match indices and flags, histogram masks)
exact. Two-view: `success` and the model choice equal, R and t within 1e-4,
the per-match triangulation verdicts `good` equal in >= 99% of slots (the
reprojection and parallax gates are float compares; SVD and eigenvector
signs differ between LAPACK builds, so raw H and F are not compared), and
the median depth of the good points, which sets the map's scale, within
1e-3 relative (it lies ~47 baselines deep, where the float32 DLT of both
packages carries ~1e-4)."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plslam_tpu.models import tracking as jtrk
from plslam_tpu.ops import extract as jext, hamming as jham
from plslam_tpu.solvers import twoview as jtv
from plslam_tpu_torch.datasets import synthetic
from plslam_tpu_torch.models import tracking as ttrk
from plslam_tpu_torch.ops import extract as text, hamming as tham
from plslam_tpu_torch.solvers import twoview as ttv
from torch_threads import one_thread  # noqa: F401

NF, LEVELS = 512, 3
K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def pair():
    """JAX features of frames 0 and 6 of the system sequence, and the JAX
    package's frame matching between them."""
    scene = synthetic.make_scene(seed=1)
    Ts = synthetic.trajectory(60, "orbit")
    cfg = jext.ExtractorConfig(n_features=NF, n_levels=LEVELS)
    ext = jax.jit(lambda im: jext.extract_points(im, cfg))
    f1, f2 = (ext(jnp.asarray(synthetic.render(scene, Ts[i]).astype(np.uint8)
                              .astype(np.float32))) for i in (0, 6))
    idx, ok = jtrk.match_frames(f1, f2)
    return f1, f2, np.asarray(idx), np.asarray(ok)


@pytest.fixture(scope="module")
def jax_init(pair):
    """The JAX package's two-view result on the pair, with PRNGKey(0) as its
    System uses, and the minimal sets that key draws."""
    f1, f2, idx2, ok = pair
    uv1 = jnp.asarray(f1.uv_un)
    uv2 = jnp.asarray(np.asarray(f2.uv_un)[idx2])
    key = jax.random.PRNGKey(0)
    sets = jtv.sample_minimal_sets(key, uv1.shape[0], jnp.asarray(ok), 200)
    res = jax.jit(jtv.initialize_two_view)(key, uv1, uv2, jnp.asarray(ok),
                                           jnp.asarray(K))
    return res, np.array(sets)


def _feats(f):
    return text.PointFeatures(*[_t(getattr(f, k)) for k in f._fields])


def test_match_frames_matches_jax(pair):
    f1, f2, idx_j, ok_j = pair
    before = ttrk.gated_match.gated_hamming_best2.launches
    idx, ok = ttrk.match_frames(_feats(f1), _feats(f2))
    assert ttrk.gated_match.gated_hamming_best2.launches == before  # CPU
    np.testing.assert_array_equal(idx.numpy(), idx_j)
    np.testing.assert_array_equal(ok.numpy(), ok_j)
    assert ok_j.sum() >= 100


@pytest.mark.parametrize("seed,n_matched", [(0, 400), (1, 40), (2, 0)])
def test_rotation_histogram_mask_matches_jax(seed, n_matched):
    """Random angle differences around a few dominant rotations, including
    empty and tied histograms."""
    rng = np.random.default_rng(seed)
    n = 512
    dangle = np.concatenate([
        rng.normal(0.1, 0.05, n // 2), rng.normal(-2.0, 0.05, n // 4),
        rng.uniform(-7, 7, n - n // 2 - n // 4)]).astype(np.float32)
    matched = np.zeros(n, bool)
    matched[rng.choice(n, n_matched, replace=False)] = True
    got = tham.rotation_histogram_mask(_t(dangle), _t(matched)).numpy()
    want = np.asarray(jham.rotation_histogram_mask(jnp.asarray(dangle),
                                                   jnp.asarray(matched)))
    np.testing.assert_array_equal(got, want)
    # ties: two bins of equal count keep the lower one first
    d = np.repeat(np.array([0.5, 1.5, 2.5, 3.5], np.float32), [5, 5, 5, 1])
    m = np.ones(d.shape, bool)
    np.testing.assert_array_equal(
        tham.rotation_histogram_mask(_t(d), _t(m)).numpy(),
        np.asarray(jham.rotation_histogram_mask(jnp.asarray(d),
                                                jnp.asarray(m))))


def test_initialize_two_view_on_jax_minimal_sets(pair, jax_init):
    f1, f2, idx2, ok = pair
    uv1 = np.asarray(f1.uv_un)
    uv2 = np.asarray(f2.uv_un)[idx2]
    rj, sets = jax_init
    rt = ttv.initialize_two_view(None, _t(uv1), _t(uv2), _t(ok), _t(K),
                                 idx=torch.from_numpy(sets).long())
    assert bool(rt.success) == bool(rj.success) is True
    assert bool(rt.used_homography) == bool(rj.used_homography)
    np.testing.assert_allclose(rt.R.numpy(), np.asarray(rj.R), atol=1e-4)
    np.testing.assert_allclose(rt.t.numpy(), np.asarray(rj.t), atol=1e-4)
    good_t, good_j = rt.good.numpy(), np.asarray(rj.good)
    assert (good_t == good_j).mean() >= 0.99 and good_j.sum() >= 100
    assert abs(int(rt.n_good) - int(rj.n_good)) <= 0.01 * int(rj.n_good)
    np.testing.assert_array_equal(rt.inliers.numpy(), np.asarray(rj.inliers))
    # the median depth of the good points sets the map's scale; it is ~47
    # translation units here, where float32 DLT carries ~1e-4 (see
    # test_torch_geometry.test_triangulation_matches_jax)
    med = lambda X, g: np.median(np.asarray(X)[g][:, 2])
    np.testing.assert_allclose(med(rt.X.numpy(), good_t), med(rj.X, good_j),
                               rtol=1e-3)


def test_check_rt_and_decompositions_match_jax(pair, jax_init):
    """check_rt on the ground-truth-like motion of both decompositions:
    n_good within 1%, parallax within 1e-3 degrees; decompose_essential's
    four motions agree as a set up to the sign of E."""
    f1, f2, idx2, ok = pair
    uv1, uv2 = np.asarray(f1.uv_un), np.asarray(f2.uv_un)[idx2]
    rj, _ = jax_init
    R, t = np.asarray(rj.R), np.asarray(rj.t)
    nj, pj, _, gj = jtv.check_rt(jnp.asarray(R), jnp.asarray(t),
                                 jnp.asarray(uv1), jnp.asarray(uv2),
                                 jnp.asarray(ok), jnp.asarray(K))
    nt, pt, _, gt = ttv.check_rt(_t(R), _t(t), _t(uv1), _t(uv2), _t(ok),
                                 _t(K))
    assert abs(int(nt) - int(nj)) <= 0.01 * int(nj) and int(nj) > 100
    np.testing.assert_allclose(float(pt), float(pj), atol=1e-3)
    E = (np.cross(np.eye(3), t) @ R).T.astype(np.float32)   # [t]x R
    Rs_t, ts_t = ttv.decompose_essential(_t(E))
    Rs_j, ts_j = jtv.decompose_essential(jnp.asarray(E))
    for Rt_, tt_ in zip(Rs_t.numpy(), ts_t.numpy()):
        assert min(np.abs(Rt_ - Rj).max() + np.abs(tt_ - tj).max()
                   for Rj, tj in zip(np.asarray(Rs_j), np.asarray(ts_j))) < 1e-4


def test_sample_minimal_sets_draws_valid_distinct_matches():
    """The port's own sampler: only valid matches, 8 distinct per set, the
    same sets for the same seed, others for another."""
    mask = torch.from_numpy(np.random.default_rng(0).random(300) > 0.5)
    draw = lambda s: ttv.sample_minimal_sets(
        torch.Generator().manual_seed(s), mask, 200)
    a, b, c = draw(0), draw(0), draw(1)
    assert a.shape == (200, 8) and mask[a].all()
    assert all(len(set(r.tolist())) == 8 for r in a)
    assert torch.equal(a, b) and not torch.equal(a, c)

"""Parity of the PyTorch port's point extraction against plslam_tpu on a
rendered 240x320 uint8 frame (3 levels, 512 features).

Tolerances and why:
- level 0 is the uint8 image itself, so its FAST scores, selection, IC-angle
  moments (integer sums below 2^24) and descriptors are bit-equal;
- levels >= 1 come from float32 resize products that sum in another order
  than XLA's (levels agree within 1e-3 grey levels), so over all slots >= 99%
  must agree in uv and octave, <= 0.1% of descriptor bits may differ on the
  agreeing slots, and angles agree within 1e-4 rad.
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plslam_tpu.ops import extract as jext, fast as jfast, orb as jorb
from plslam_tpu.ops import pyramid as jpyr, select as jsel
from plslam_tpu_torch.datasets import synthetic
from plslam_tpu_torch.ops import extract as text, fast as tfast, orb as torb
from plslam_tpu_torch.ops import pyramid as tpyr, select as tsel
from torch_threads import one_thread  # noqa: F401

H, W, LEVELS, NF = 240, 320, 3, 512
JCFG = jext.ExtractorConfig(n_features=NF, n_levels=LEVELS)
TCFG = text.ExtractorConfig(n_features=NF, n_levels=LEVELS)


@pytest.fixture(scope="module")
def frame():
    scene = synthetic.make_scene(seed=0, width=W, height=H, fx=250.0, fy=250.0)
    T = synthetic.trajectory(6, "orbit")[1]
    return synthetic.render(scene, T).astype(np.uint8).astype(np.float32)


@pytest.fixture(scope="module")
def features(frame):
    fj = jax.jit(lambda im: jext.extract_points(im, JCFG))(jnp.asarray(frame))
    ft = text.PointExtractor(TCFG, H, W)(torch.from_numpy(frame))
    return ({k: np.asarray(v) for k, v in fj._asdict().items()},
            {k: v.numpy() for k, v in ft._asdict().items()})


@pytest.fixture(scope="module")
def levels(frame):
    lj = jax.jit(lambda im: jpyr.build_pyramid(im, LEVELS, 1.2))(
        jnp.asarray(frame))
    return [np.array(l) for l in lj]


def test_pyramid(frame, levels):
    weights = [(torch.from_numpy(wy), torch.from_numpy(wx)) for wy, wx in
               tpyr.pyramid_weights(H, W, LEVELS, 1.2)]
    lt = tpyr.build_pyramid(torch.from_numpy(frame), weights)
    assert [tuple(l.shape) for l in lt] == tpyr.level_shapes(H, W, LEVELS, 1.2)
    np.testing.assert_array_equal(lt[0].numpy(), levels[0])
    for l in range(1, LEVELS):
        np.testing.assert_allclose(lt[l].numpy(), levels[l], atol=1e-3)


def test_blur(levels):
    taps = torch.from_numpy(tpyr.gaussian_kernel1d(7, 2.0))
    for im in levels:
        bt = tpyr.blur(torch.from_numpy(im), taps).numpy()
        bj = np.asarray(jax.jit(jpyr.blur)(jnp.asarray(im)))
        np.testing.assert_allclose(bt, bj, atol=1e-4)


@pytest.mark.parametrize("order", ["uniform", "response"])
def test_fast_and_select_level0(levels, order):
    im = levels[0]
    sj = np.asarray(jax.jit(lambda x: jfast.fast_dual_threshold(
        x, 20.0, 7.0, 20))(jnp.asarray(im)))
    st = tfast.fast_dual_threshold(torch.from_numpy(im), 20.0, 7.0, 20)
    np.testing.assert_array_equal(st.numpy(), sj)
    n = text.level_budgets(TCFG)[0]
    outj = jax.jit(lambda s: jsel.select_grid_topk(s, n, order=order))(
        jnp.asarray(sj))
    outt = tsel.select_grid_topk(st, n, order=order)
    for a, b in zip(outt, outj):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_angle_and_descriptor_level0(levels):
    im = levels[0]
    rng = np.random.default_rng(3)
    uv = np.stack([rng.integers(20, W - 20, 400), rng.integers(20, H - 20, 400)],
                  -1).astype(np.float32)
    # the edge of the image, where the JAX tile arithmetic clamps the window
    uv[:4] = [[0, 0], [W - 1, H - 1], [3, H - 2], [W - 5, 1]]
    aj = np.array(jax.jit(jorb.ic_angle)(jnp.asarray(im), jnp.asarray(uv)))
    at = torb.ic_angle(torch.from_numpy(im), torch.from_numpy(uv)).numpy()
    np.testing.assert_allclose(at, aj, atol=1e-6)
    blurred = np.array(jax.jit(jpyr.blur)(jnp.asarray(im)))
    dj = np.asarray(jax.jit(lambda b, u, a: jorb.steered_descriptor(
        b, u, a, pattern="learned"))(jnp.asarray(blurred), jnp.asarray(uv),
                                     jnp.asarray(aj)))
    offsets = torch.from_numpy(torb.binned_offsets(torb.load_pattern("learned")))
    dt = torb.steered_descriptor(torch.from_numpy(blurred),
                                 torch.from_numpy(uv), torch.from_numpy(aj),
                                 offsets).numpy()
    np.testing.assert_array_equal(dt, dj)


def test_patterns_match_jax():
    for name in ("gauss", "learned"):
        np.testing.assert_array_equal(torb.load_pattern(name),
                                      jorb.PATTERNS[name])
        # each bin's column of the JAX +-1 test matrix holds -1 at A, +1 at B
        off = torb.binned_offsets(torb.load_pattern(name))
        M = jorb._binned_test_matrix(jorb.PATTERNS[name])
        flat = (off[..., 0] + 15) * 31 + (off[..., 1] + 15)   # (30, 256, 2)
        cols = np.arange(30 * 256).reshape(30, 256)
        rebuilt = np.zeros_like(M)
        np.add.at(rebuilt, (flat[..., 0], cols), -1.0)
        np.add.at(rebuilt, (flat[..., 1], cols), 1.0)
        np.testing.assert_array_equal(rebuilt, M)


def test_extract_points(features):
    fj, ft = features
    for key in ("uv", "uv_un", "response", "octave", "angle", "desc", "valid"):
        assert ft[key].shape == fj[key].shape and ft[key].dtype == fj[key].dtype
    same = ((ft["uv"] == fj["uv"]).all(1) & (ft["octave"] == fj["octave"])
            & (ft["valid"] == fj["valid"]))
    l0 = fj["octave"] == 0
    agree = same & fj["valid"]
    bits = ft["desc"][agree] != fj["desc"][agree]
    dang = np.abs(ft["angle"][agree] - fj["angle"][agree])
    dang = np.minimum(dang, 2 * np.pi - dang)
    print(f"slots {same.size}: level-0 equal {same[l0].sum()}/{l0.sum()}, "
          f"all equal {same.sum()}, valid {fj['valid'].sum()}; differing "
          f"descriptor bits {bits.sum()}/{bits.size}; max angle diff "
          f"{dang.max():.3g}")
    assert same[l0].all()
    np.testing.assert_array_equal(ft["desc"][l0 & agree], fj["desc"][l0 & agree])
    assert same.mean() >= 0.99
    assert bits.mean() <= 1e-3
    assert dang.max() <= 1e-4


def test_extract_points_functional_and_shape_check(frame, features):
    _, ft = features
    out = text.extract_points(torch.from_numpy(frame), TCFG)
    np.testing.assert_array_equal(out.uv.numpy(), ft["uv"])
    np.testing.assert_array_equal(out.desc.numpy(), ft["desc"])
    with pytest.raises(ValueError):
        text.PointExtractor(TCFG, H, W)(torch.zeros(H + 1, W))


# subpixel refinement: on level 0 the pre-NMS score map is bit-equal, so the
# refined keypoints agree to float32 rounding of the parabola's offset
SUBPIX_TOL_PX = 1e-5


def test_refine_subpixel_level0(levels):
    im = levels[0]
    sj, rj = jax.jit(lambda x: jfast.fast_dual_threshold(
        x, 20.0, 7.0, 20, return_raw=True))(jnp.asarray(im))
    st, rt = tfast.fast_dual_threshold(torch.from_numpy(im), 20.0, 7.0, 20,
                                       return_raw=True)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
    np.testing.assert_array_equal(rt.numpy(), np.asarray(rj))
    uv, _, valid = tsel.select_grid_topk(st, text.level_budgets(TCFG)[0])
    # the image edge too, where the neighbours are clamped
    uv = torch.cat([uv, torch.tensor([[0.0, 0.0], [W - 1.0, H - 1.0]])])
    rj_uv = np.asarray(jax.jit(jext.refine_subpixel)(rj, jnp.asarray(uv.numpy())))
    rt_uv = text.refine_subpixel(rt, uv).numpy()
    moved = np.abs(rt_uv - uv.numpy()).max(1) > 0
    assert moved[:-2][valid.numpy()].mean() > 0.5   # the refinement acts
    np.testing.assert_allclose(rt_uv, rj_uv, atol=SUBPIX_TOL_PX, rtol=0)


def test_extract_points_subpixel(frame):
    cj, ct = JCFG._replace(subpixel=True), TCFG._replace(subpixel=True)
    fj = jax.jit(lambda im: jext.extract_points(im, cj))(jnp.asarray(frame))
    ft = text.PointExtractor(ct, H, W)(torch.from_numpy(frame))
    fj = {k: np.asarray(v) for k, v in fj._asdict().items()}
    ft = {k: v.numpy() for k, v in ft._asdict().items()}
    # keypoints (integer parts, octaves, validity) as test_extract_points;
    # refined uv within SUBPIX_TOL_PX on level 0 and within the levels'
    # resize tolerance (1e-3) elsewhere
    same = ((np.abs(ft["uv"] - fj["uv"]).max(1) <= 1e-3)
            & (ft["octave"] == fj["octave"]) & (ft["valid"] == fj["valid"]))
    l0 = fj["octave"] == 0
    assert same[l0].all() and same.mean() >= 0.99
    np.testing.assert_allclose(ft["uv"][l0], fj["uv"][l0], atol=SUBPIX_TOL_PX,
                               rtol=0)
    np.testing.assert_array_equal(ft["desc"][l0], fj["desc"][l0])
    assert (np.round(ft["uv"]) != ft["uv"]).any(1)[ft["valid"]].mean() > 0.5

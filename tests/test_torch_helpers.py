"""Public helpers of the port against the JAX package's: `camera.in_image`
and `undistorted_bounds`, `se3.quat_to_rot` and `vee`,
`hamming.hamming_nn_match`, `fast.fast_score_map`, `orb.pack_bits` and
`unpack_bits`.

Tolerances: integer and boolean outputs bit-equal; float32 elementwise
arithmetic within 1e-6 (the undistortion's 10 fixed-point steps within
1e-4 px, as tests/test_torch_geometry.py holds them).
"""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plslam_tpu.geometry import camera as jcam, se3 as jse3
from plslam_tpu.ops import fast as jfast, hamming as jham, orb as jorb
from plslam_tpu_torch.geometry import camera as tcam, se3 as tse3
from plslam_tpu_torch.ops import fast as tfast, hamming as tham, orb as torb
from torch_threads import one_thread  # noqa: F401

TUM1 = (517.306408, 516.469215, 318.643040, 255.313989, 0.262383,
        -0.953104, -0.005358, 0.002628, 1.163314)


@pytest.mark.parametrize("margin", [0.0, 19.5])
def test_in_image_and_undistorted_bounds(margin):
    rng = np.random.default_rng(0)
    uv = rng.uniform(-40, 700, (500, 2)).astype(np.float32)
    uv[:4] = [[0, 0], [639.999, 479.999], [640, 10], [margin, margin]]
    ct, cj = tcam.Camera.create(*TUM1), jcam.Camera.create(*TUM1)
    np.testing.assert_array_equal(
        tcam.in_image(ct, torch.from_numpy(uv), margin).numpy(),
        np.asarray(jcam.in_image(cj, jnp.asarray(uv), margin)))
    bt = [float(b) for b in tcam.undistorted_bounds(ct)]
    bj = [float(b) for b in jcam.undistorted_bounds(cj)]
    np.testing.assert_allclose(bt, bj, atol=1e-4)
    assert abs(bt[0]) > 1 and abs(bt[1] - 640) > 1   # distortion moves them


def test_quat_to_rot_and_vee():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(64, 4)).astype(np.float32)
    Rt = tse3.quat_to_rot(torch.from_numpy(q)).numpy()
    Rj = np.asarray(jse3.quat_to_rot(jnp.asarray(q)))
    np.testing.assert_allclose(Rt, Rj, atol=1e-6)
    np.testing.assert_allclose(Rt @ Rt.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), Rt.shape), atol=1e-5)
    w = rng.normal(size=(64, 3)).astype(np.float32)
    W = tse3.hat(torch.from_numpy(w))
    np.testing.assert_array_equal(tse3.vee(W).numpy(), w)
    np.testing.assert_array_equal(
        tse3.vee(W).numpy(), np.asarray(jse3.vee(jnp.asarray(W.numpy()))))


@pytest.mark.parametrize("with_mask", [False, True])
def test_hamming_nn_match(with_mask):
    rng = np.random.default_rng(2)
    d = (rng.random((300, 256)) < 0.5).astype(np.uint8)
    q = d[rng.integers(0, 300, 120)].copy()
    flips = rng.random(q.shape) < rng.uniform(0, 0.3, (120, 1))
    q[flips] ^= 1
    q[:5] = d[:5]
    d[5] = d[4]                            # a tie: the lower index wins
    mask = rng.random((120, 300)) < 0.7 if with_mask else None
    kw = dict(max_dist=60, nn_ratio=0.9)
    out_t = tham.hamming_nn_match(
        torch.from_numpy(q), torch.from_numpy(d),
        None if mask is None else torch.from_numpy(mask), **kw)
    out_j = jham.hamming_nn_match(
        jnp.asarray(q), jnp.asarray(d),
        None if mask is None else jnp.asarray(mask), **kw)
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    assert 0 < int(out_t[1].sum()) < 120


@pytest.mark.parametrize("threshold", [7.0, 20.0])
def test_fast_score_map(threshold):
    from plslam_tpu_torch.datasets import synthetic
    scene = synthetic.make_scene(seed=4, width=160, height=120, fx=125.0,
                                 fy=125.0)
    img = synthetic.render(scene, synthetic.trajectory(3, "orbit")[1])
    img = img.astype(np.uint8).astype(np.float32)
    st = tfast.fast_score_map(torch.from_numpy(img), threshold).numpy()
    sj = np.asarray(jax.jit(lambda x: jfast.fast_score_map(x, threshold))(
        jnp.asarray(img)))
    np.testing.assert_array_equal(st, sj)
    assert (st > 0).sum() > 50


def test_pack_and_unpack_bits():
    rng = np.random.default_rng(3)
    bits = (rng.random((7, 5, 256)) < 0.5).astype(np.uint8)
    pt = torb.pack_bits(torch.from_numpy(bits))
    pj = np.asarray(jorb.pack_bits(jnp.asarray(bits)))
    assert pt.dtype == torch.uint8 and pt.shape == (7, 5, 32)
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(pt.numpy(),
                                  np.packbits(bits, -1, bitorder="little"))
    ut = torb.unpack_bits(pt)
    np.testing.assert_array_equal(ut.numpy(),
                                  np.asarray(jorb.unpack_bits(jnp.asarray(pj))))
    np.testing.assert_array_equal(ut.numpy(), bits)

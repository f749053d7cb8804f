"""The port's `entry()` against the JAX package's `__graft_entry__.entry()`:
the flagship per-frame program (extraction at 240x320, 512 features, 3
levels -> undistortion -> `track_local_map` against a 2048-point map).

On the example arguments no map descriptor passes the Hamming gate, so both
steps return their prediction with no inlier; the steps are also held
against each other on a rendered frame and a map of points from rendered
depth (tests/test_torch_tracking.py's fixture at these widths), where the
JAX step matches. Tolerances are tests/test_torch_tracking.py's: T within
1e-4 (float32 6x6 solves summed in another order), inliers within 2."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
from plslam_tpu.mapstate import state as jstate
from plslam_tpu.models import mapping as jmap
from plslam_tpu.ops import extract as jext, stereo as jstereo
from plslam_tpu_torch import entry as tentry
from plslam_tpu_torch.datasets import synthetic
from plslam_tpu_torch.mapstate import checkpoint as tckpt, state as tstate
from torch_threads import one_thread  # noqa: F401

T_TOL, INLIER_TOL = 1e-4, 2
MIN_JAX_INLIERS = 30


@pytest.fixture(scope="module")
def jax_entry():
    fn, args = graft.entry()
    return jax.jit(fn), args


@pytest.fixture(scope="module")
def port_entry():
    return tentry.entry(device="cpu")


@pytest.fixture(scope="module")
def rendered():
    """Frame 1 of tests/test_torch_tracking.py's orbit and the JAX map of
    points from frame 0's rendered depth (keyframe 0 at the origin)."""
    cam, ext_cfg, map_cfg, sf, _ = graft._build()
    scene = synthetic.make_scene(seed=0, width=320, height=240, fx=250.0,
                                 fy=250.0)
    Ts = synthetic.trajectory(24, "orbit")
    img0, depth0 = synthetic.render_rgbd(scene, Ts[0])
    img1 = synthetic.render(scene, Ts[1])
    img0, img1 = (x.astype(np.uint8).astype(np.float32) for x in (img0, img1))
    n = ext_cfg.n_features

    @jax.jit
    def boot(img, depth):
        f = jext.extract_points(img, ext_cfg)
        ms = jmap.insert_keyframe(cam, jstate.allocate(map_cfg), f,
                                  jnp.eye(4), jnp.full((n,), -1, jnp.int32),
                                  jnp.int32(0), sf)
        return jmap.create_points_from_depth(
            cam, ms, jnp.int32(0), jstereo.depth_at(depth, f.uv), sf)
    return img1, boot(jnp.asarray(img0), jnp.asarray(depth0))


def _port_map(ms_jax):
    return tckpt.from_numpy({k: np.array(v) for k, v in
                             ms_jax._asdict().items()}, "cpu")


def test_example_arguments_are_the_jax_entrys(jax_entry, port_entry):
    (img_j, ms_j, T_j), (img_t, ms_t, T_t) = jax_entry[1], port_entry[1]
    np.testing.assert_array_equal(img_t.numpy(), np.asarray(img_j))
    np.testing.assert_array_equal(T_t.numpy(), np.asarray(T_j))
    for name in tstate.FIELDS:
        a, b = getattr(ms_t, name).numpy(), np.asarray(getattr(ms_j, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)


def test_step_on_the_example_arguments(jax_entry, port_entry):
    """Zero descriptors: no match on either side, T is the prediction."""
    fn_j, args_j = jax_entry
    T_j, n_j = fn_j(*args_j)
    step, args_t = port_entry
    T_t, n_t = step(*args_t)
    np.testing.assert_array_equal(np.asarray(T_j), np.eye(4, dtype=np.float32))
    np.testing.assert_array_equal(T_t.numpy(), np.eye(4, dtype=np.float32))
    assert int(n_j) == int(n_t) == 0


def test_step_on_a_rendered_frame(jax_entry, port_entry, rendered):
    fn_j, _ = jax_entry
    step, _ = port_entry
    img, ms_j = rendered
    assert int(ms_j.n_pt) > 300
    T_j, n_j = fn_j(jnp.asarray(img), ms_j, jnp.eye(4))
    T_t, n_t = step(torch.from_numpy(img), _port_map(ms_j), torch.eye(4))
    assert int(n_j) >= MIN_JAX_INLIERS, int(n_j)
    assert abs(int(n_t) - int(n_j)) <= INLIER_TOL, (int(n_t), int(n_j))
    np.testing.assert_allclose(T_t.numpy(), np.asarray(T_j), atol=T_TOL)
    assert not np.allclose(np.asarray(T_j), np.eye(4), atol=1e-4)


def test_entry_needs_a_card_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.entry()
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.entry("cuda")


def test_python_m_entry_on_the_cpu(capsys):
    assert tentry.main(["--device", "cpu"]) == 0
    assert "T (4, 4), n_inliers ()" in capsys.readouterr().out

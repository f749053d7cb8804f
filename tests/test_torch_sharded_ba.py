"""The port's one-card forms of the JAX package's sharded solvers.

`sharded_pose_normal_equations` (the edge axis reduced in 1, 3 and 8
ranges) against the single-device H and b of a pose-only Gauss-Newton step
(tests/test_parallel.py's edges), within 1e-4 x the largest entry: the
ranges sum in another float32 order. `sharded_bundle_adjust` at 1, 3 and
8 landmark shards against the JAX `bundle_adjust` on
tests/test_sharded_ba.py's window (4 cameras, 120 points, 10 lines; its
two oldest cameras fixed at their true poses, which pins the monocular
scale that the file's single fixed camera leaves free), and against the
port's unsharded solver, with that file's bars: the reduced camera system
is summed range by range in another order, and 15 LM accept / reject
decisions amplify float32 noise, so the poses, points, line residuals,
cost and inlier verdicts agree at solution level. At 1 shard
`local_ba.bundle_adjust(n_shards=1)` is the unsharded solver, bit for
bit. On the file's own window (one fixed camera) the packages agree up to
the free scale, which a test pins (ROADMAP Queue 3)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plslam_tpu.geometry import camera as jcam, se3 as jse3
from plslam_tpu.optim import local_ba as jba, residuals as jres
from plslam_tpu_torch.geometry import camera as tcam
from plslam_tpu_torch.optim import local_ba as tba, residuals as tres
from plslam_tpu_torch.parallel import sharded_ba, streams

from test_sharded_ba import _window
from torch_threads import one_thread  # noqa: F401

JCAM = jcam.Camera.create(fx=300.0, fy=300.0, cx=160.0, cy=120.0,
                          width=320, height=240)
TCAM = tcam.Camera.create(fx=300.0, fy=300.0, cx=160.0, cy=120.0,
                          width=320, height=240)
JCAM_BA = jcam.Camera.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                             width=640, height=480)
TCAM_BA = tcam.Camera.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                             width=640, height=480)


def _t(x):
    return None if x is None else torch.from_numpy(np.array(x))


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_sharded_pose_system_matches_single_device(n_shards):
    rng = np.random.default_rng(0)
    E = 256
    xyz = np.stack([rng.uniform(-1, 1, E), rng.uniform(-1, 1, E),
                    rng.uniform(3, 6, E)], -1).astype(np.float32)
    uv = np.asarray(jcam.project(JCAM, jnp.asarray(xyz)))
    uv = (uv + rng.normal(0, 1, uv.shape)).astype(np.float32)
    w = np.ones(E, np.float32)
    w[::7] = 0.0
    T = np.eye(4, dtype=np.float32)
    T[:3, 3] = [0.05, -0.02, 0.1]
    r, J, _, z = jres.point_residual(JCAM, jnp.asarray(T), jnp.asarray(xyz),
                                     jnp.asarray(uv))
    m = jnp.asarray(w) * (z > 0)
    H_ref = np.asarray(jnp.einsum("nij,nik,n->jk", J, J, m))
    b_ref = np.asarray(-jnp.einsum("nij,ni,n->j", J, r, m))
    H, b = streams.sharded_pose_normal_equations(
        TCAM, _t(T), _t(xyz), _t(uv), _t(w), n_shards)
    np.testing.assert_allclose(H.numpy(), H_ref,
                               atol=1e-4 * np.abs(H_ref).max())
    np.testing.assert_allclose(b.numpy(), b_ref,
                               atol=1e-4 * (np.abs(b_ref).max() + 1e-6))


def _torch_problem(prob):
    return tba.BAProblem(**{k: (_t(v) if k != "bf" else float(v))
                            for k, v in prob._asdict().items()})


@pytest.fixture(scope="module")
def window():
    prob, Ts, X = _window(K=4, P=120, L=10)
    # the two oldest cameras fixed at their true poses, as `ba_select` fixes
    # two: with one, the monocular scale is free and two float32 solvers
    # settle up to ~1% apart along it, whatever the sharding
    prob = prob._replace(kf_T=prob.kf_T.at[1].set(jnp.asarray(Ts[1])),
                         kf_fixed=jnp.asarray([True, True, False, False]))
    tp = _torch_problem(prob)
    return prob, tp, Ts, jba.bundle_adjust(prob, JCAM_BA), \
        tba.bundle_adjust(tp, TCAM_BA)


def test_one_shard_is_the_unsharded_solver(window):
    _, tp, _, _, single = window
    res = sharded_ba.sharded_bundle_adjust(
        1, sharded_ba.prepare_problem(tp, 1), TCAM_BA)
    for x, y in zip(single, res):
        assert torch.equal(x, y)


def _agree(prob, res, ref, Ts_true):
    """tests/test_sharded_ba.py's bars between `res` (the port, padded
    landmark axes) and `ref` (numpy-able)."""
    np.testing.assert_allclose(res.kf_T.numpy(), np.asarray(ref.kf_T),
                               atol=5e-3)
    P = prob.pt_mask.shape[0]
    L = prob.ln_mask.shape[0]
    np.testing.assert_allclose(res.pt_xyz.numpy()[:P], np.asarray(ref.pt_xyz),
                               rtol=6e-3, atol=6e-3)
    ref_T = jnp.asarray(np.asarray(ref.kf_T))

    def ln_res(ln_xyz):
        r, _, _, _ = jres.line_endpoint_residual(
            JCAM_BA, jnp.broadcast_to(ref_T[:, None, None], (4, L, 2, 4, 4)),
            jnp.broadcast_to(jnp.asarray(ln_xyz)[None, :L], (4, L, 2, 3)),
            jnp.broadcast_to(prob.ln_obs_l2d[:, :, None, :], (4, L, 2, 3)))
        return np.asarray(r)
    m = (np.asarray(ref.ln_obs_inlier)
         & res.ln_obs_inlier.numpy()[:, :L])[:, :, None]
    np.testing.assert_allclose(ln_res(res.ln_xyz.numpy()) * m,
                               ln_res(np.asarray(ref.ln_xyz)) * m, atol=0.5)
    c_ref, c_sh = float(ref.cost), float(res.cost)
    assert abs(c_sh - c_ref) <= 0.05 * max(c_ref, 1.0), (c_sh, c_ref)
    agree = (res.obs_inlier.numpy()[:, :P]
             == np.asarray(ref.obs_inlier)).mean()
    assert agree > 0.99, f"inlier verdicts agree only {agree:.3f}"
    for k in range(1, 4):
        d = np.asarray(jse3.se3_log(jnp.asarray(
            res.kf_T.numpy()[k] @ np.linalg.inv(Ts_true[k]))))
        assert np.linalg.norm(d[:3]) < 6e-3, (k, d)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_sharded_bundle_adjust_matches_jax(window, n_shards):
    """Against the JAX `bundle_adjust`, and against the port's unsharded
    solver (the JAX file's own comparison: sharded against single
    device), at tests/test_sharded_ba.py's bars."""
    prob, tp, Ts_true, ref, single = window
    sp = sharded_ba.prepare_problem(tp, n_shards)
    assert sp.pt_mask.shape[0] % n_shards == 0
    assert sp.ln_mask.shape[0] % n_shards == 0
    res = sharded_ba.sharded_bundle_adjust(n_shards, sp, TCAM_BA)
    _agree(prob, res, single, Ts_true)
    _agree(prob, res, ref, Ts_true)


def _centres(T):
    return np.stack([-R.T @ t for R, t in zip(T[:, :3, :3], T[:, :3, 3])])


@pytest.fixture(scope="module")
def window_one_fixed():
    prob, Ts, _ = _window(K=4, P=120, L=10)
    return prob, _torch_problem(prob), jba.bundle_adjust(prob, JCAM_BA)


@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_one_fixed_camera_window_agrees_up_to_scale(window_one_fixed,
                                                    n_shards):
    """tests/test_sharded_ba.py's window as it is, one camera fixed: the
    monocular scale is free, and the port settles along it away from the
    JAX solution (seen: 0.991 at 1 shard, 1.0018 at 3, 0.9988 at 8; at 1
    shard one pose entry 5.95e-3 off, past the file's 5e-3; ROADMAP Queue
    3). Pinned: the scale fitted about the fixed camera's centre within 2%
    of 1, and with it removed the file's bars: camera centres within
    5e-3, points within rtol = atol = 6e-3; rotations within 5e-3, the
    cost within 5%, the inlier verdicts >= 99% equal."""
    prob, tp, ref = window_one_fixed
    res = sharded_ba.sharded_bundle_adjust(
        n_shards, sharded_ba.prepare_problem(tp, n_shards), TCAM_BA)
    P = prob.pt_mask.shape[0]
    T, T_ref = res.kf_T.numpy(), np.asarray(ref.kf_T)
    X, X_ref = res.pt_xyz.numpy()[:P], np.asarray(ref.pt_xyz)
    c, c_ref = _centres(T), _centres(T_ref)
    o = c_ref[0]
    a = np.concatenate([c_ref[1:] - o, X_ref - o]).ravel()
    b = np.concatenate([c[1:] - o, X - o]).ravel()
    scale = float(a @ b / (a @ a))
    assert abs(scale - 1) < 0.02, scale
    np.testing.assert_allclose(c, o + scale * (c_ref - o), atol=5e-3)
    np.testing.assert_allclose(X, o + scale * (X_ref - o), rtol=6e-3,
                               atol=6e-3)
    np.testing.assert_allclose(T[:, :3, :3], T_ref[:, :3, :3], atol=5e-3)
    c_ref, c_sh = float(ref.cost), float(res.cost)
    assert abs(c_sh - c_ref) <= 0.05 * max(c_ref, 1.0), (c_sh, c_ref)
    agree = (res.obs_inlier.numpy()[:, :P]
             == np.asarray(ref.obs_inlier)).mean()
    assert agree > 0.99, f"inlier verdicts agree only {agree:.3f}"

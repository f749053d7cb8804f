"""Parity of the PyTorch port's geometry against plslam_tpu: SE3 algebra and
the pinhole/radtan camera. Tolerance: atol 1e-5 (float32 transcendental and
summation order differ between XLA and PyTorch on the CPU)."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plslam_tpu.geometry import camera as jcam, se3 as jse3
from plslam_tpu_torch.geometry import camera as tcam, se3 as tse3
from torch_threads import one_thread  # noqa: F401

ATOL = 1e-5


def _tangents():
    """Random tangents plus the corners: zero, theta^2 below the 1e-8 Taylor
    switch, just above it, and rotations near pi."""
    rng = np.random.default_rng(0)
    xi = rng.normal(0, 0.6, (32, 6))
    corners = [np.zeros(6), [3e-5, -2e-5, 1e-5, 0.1, -0.2, 0.3],
               [1e-4, 0, 0, 0.5, 0, 0], [2e-9, 1e-9, -3e-9, 1.0, 2.0, -1.0]]
    for axis in np.eye(3):
        corners.append(np.concatenate([(np.pi - 1e-3) * axis, [0.2, -0.1, 0.4]]))
    corners.append(np.concatenate(
        [(np.pi - 2e-3) * np.array([1.0, 2.0, -2.0]) / 3.0, [0.0, 0.0, 1.0]]))
    return np.concatenate([xi, np.asarray(corners)]).astype(np.float32)


def _both(fn_name, *arrays):
    t = getattr(tse3, fn_name)(*[torch.from_numpy(a.copy()) for a in arrays])
    j = getattr(jse3, fn_name)(*[jnp.asarray(a) for a in arrays])
    return np.asarray(t), np.asarray(j)


@pytest.mark.parametrize("fn_name", ["se3_exp", "so3_exp", "left_jacobian",
                                     "left_jacobian_inv", "hat"])
def test_tangent_functions(fn_name):
    xi = _tangents()
    arg = xi if fn_name == "se3_exp" else xi[:, :3].copy()
    t, j = _both(fn_name, arg)
    np.testing.assert_allclose(t, j, atol=ATOL)


def test_se3_log_and_roundtrip():
    T = np.asarray(jse3.se3_exp(jnp.asarray(_tangents())))
    t, j = _both("se3_log", T)
    np.testing.assert_allclose(t, j, atol=ATOL)
    back = np.asarray(tse3.se3_exp(torch.from_numpy(t)))
    np.testing.assert_allclose(back, T, atol=ATOL)


def test_se3_inv_and_transform():
    rng = np.random.default_rng(1)
    T = np.asarray(jse3.se3_exp(jnp.asarray(_tangents())))
    t, j = _both("se3_inv", T)
    np.testing.assert_allclose(t, j, atol=ATOL)
    pts = rng.uniform(-3, 3, (T.shape[0], 50, 3)).astype(np.float32)
    t, j = _both("transform", T, pts)
    np.testing.assert_allclose(t, j, atol=ATOL)
    t, j = _both("transform", T, pts[:, 0])
    np.testing.assert_allclose(t, j, atol=ATOL)


# TUM freiburg1 calibration (examples/TUM1.yaml)
TUM1 = dict(fx=517.306408, fy=516.469215, cx=318.643040, cy=255.313989,
            k1=0.262383, k2=-0.953104, p1=-0.005358, p2=0.002628, k3=1.163314)


def test_undistort_and_project_tum1():
    rng = np.random.default_rng(2)
    uv = np.stack([rng.uniform(0, 640, 500), rng.uniform(0, 480, 500)],
                  -1).astype(np.float32)
    ct, cj = tcam.Camera.create(**TUM1), jcam.Camera.create(**TUM1)
    np.testing.assert_allclose(
        np.asarray(tcam.undistort_pixels(ct, torch.from_numpy(uv))),
        np.asarray(jcam.undistort_pixels(cj, jnp.asarray(uv))), atol=ATOL)
    xn = ((uv - [320.0, 240.0]) / 600.0).astype(np.float32)
    np.testing.assert_allclose(
        np.asarray(tcam.distort_normalized(ct, torch.from_numpy(xn))),
        np.asarray(jcam.distort_normalized(cj, jnp.asarray(xn))), atol=ATOL)
    Xc = np.concatenate([xn * 3.0, np.full((500, 1), 3.0)], -1).astype(np.float32)
    for distort in (False, True):
        np.testing.assert_allclose(
            np.asarray(tcam.project(ct, torch.from_numpy(Xc), distort)),
            np.asarray(jcam.project(cj, jnp.asarray(Xc), distort)),
            atol=ATOL)


@pytest.mark.parametrize("layout,kind", [("room", "orbit"), ("box", "circle"),
                                         ("wall", "forward")])
def test_synthetic_scene_trajectory_and_render(layout, kind):
    """The port's renderer is the JAX package's numpy code; only the
    trajectory's SE3 exponential is the port's (atol 1e-6). Rendering one pose
    gives the same image and depth."""
    from plslam_tpu.datasets import synthetic as jsyn
    from plslam_tpu_torch.datasets import synthetic as tsyn

    kw = dict(seed=3, width=160, height=120, fx=125.0, fy=125.0, layout=layout)
    st, sj = tsyn.make_scene(**kw), jsyn.make_scene(**kw)
    for pt, pj in zip(st.planes, sj.planes):
        for a, b in zip(pt, pj):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(st[1:], sj[1:]):
        np.testing.assert_array_equal(a, b)
    Tt, Tj = tsyn.trajectory(9, kind), jsyn.trajectory(9, kind)
    assert Tt.dtype == Tj.dtype == np.float32
    np.testing.assert_allclose(Tt, Tj, atol=1e-6)
    for a, b in zip(tsyn.render_rgbd(st, Tj[4]), jsyn.render_rgbd(sj, Tj[4])):
        np.testing.assert_array_equal(a, b)



def _two_views(baseline, depth, n=400):
    """Two world->camera poses `baseline` m apart, points at `depth` (lo,
    hi) in front of both, their noisy pixels and the JAX projections."""
    from plslam_tpu.geometry import triangulation as jtri
    rng = np.random.default_rng(3)
    T1 = np.asarray(jse3.se3_exp(jnp.asarray([0.01, -0.02, 0.0, 0.0, 0.0, 0.0])))
    T2 = np.asarray(jse3.se3_exp(jnp.asarray(
        [0.03, 0.05, -0.01, -baseline, 0.02, 0.05])))
    X = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(*depth, n)], -1).astype(np.float32)
    uv = []
    for T in (T1, T2):
        Xc = X @ T[:3, :3].T + T[:3, 3]
        uv.append((Xc[:, :2] / Xc[:, 2:] * 500.0 + [320.0, 240.0]
                   + rng.normal(0, 0.5, (n, 2))).astype(np.float32))
    cam = jcam.Camera.create(500.0, 500.0, 320.0, 240.0)
    P1, P2 = (np.asarray(jtri.projection_matrix(cam, jnp.asarray(T)))
              for T in (T1, T2))
    return T1, T2, uv[0], uv[1], P1, P2


@pytest.mark.parametrize("baseline,depth", [(2.0, (1.5, 3.0)),
                                            (0.3, (3.0, 8.0))])
def test_triangulation_matches_jax(baseline, depth):
    """projection_matrix, triangulate_dlt, solve3x3, inv3x3 and parallax_cos
    on the same float32 inputs. Tolerance: 1e-5 relative. Exception, for
    what it is: the DLT normal equations amplify one-ulp summation
    differences by their condition number, ~(depth / baseline)^2, so on the
    narrow-baseline case (a SLAM keyframe pair) both packages are ~5e-5
    from the float64 solution; there the port must be as close to it as the
    JAX package (within 1.25x), not to the JAX package."""
    from plslam_tpu.geometry import triangulation as jtri
    from plslam_tpu_torch.geometry import triangulation as ttri
    T1, T2, uv1, uv2, P1j, P2j = _two_views(baseline, depth)
    t = lambda a: torch.from_numpy(np.array(a))
    K = np.array([[500.0, 0, 320], [0, 500.0, 240], [0, 0, 1]], np.float32)
    cam = tcam.Camera.create(500.0, 500.0, 320.0, 240.0)
    np.testing.assert_array_equal(tcam.intrinsics(cam).numpy(), K)
    for T, Pj in ((T1, P1j), (T2, P2j)):
        np.testing.assert_allclose(ttri.projection_matrix(t(K), t(T)).numpy(),
                                   Pj, rtol=1e-5, atol=1e-5)
    args = (P1j, P2j, uv1, uv2)
    X_t = ttri.triangulate_dlt(*map(t, args)).numpy()
    X_j = np.asarray(jtri.triangulate_dlt(*map(jnp.asarray, args)))
    rel = lambda a, b: (np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max()
    if baseline >= 1.0:
        assert rel(X_t, X_j) < 1e-5
    else:
        X64 = ttri.triangulate_dlt(*[t(a).double() for a in args]).numpy()
        assert rel(X_t, X64) <= 1.25 * rel(X_j, X64) < 1e-4
    rng = np.random.default_rng(4)
    N = (rng.normal(0, 1, (64, 3, 3)) + 3 * np.eye(3)).astype(np.float32)
    g = rng.normal(0, 1, (64, 3)).astype(np.float32)
    np.testing.assert_allclose(
        ttri.solve3x3(t(N), t(g)).numpy(),
        np.asarray(jtri.solve3x3(jnp.asarray(N), jnp.asarray(g))),
        rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(ttri.inv3x3(t(N)).numpy(),
                               np.asarray(jtri.inv3x3(jnp.asarray(N))),
                               rtol=1e-5, atol=1e-5)
    c1, c2 = np.zeros(3, np.float32), np.array([0.3, 0.0, 0.1], np.float32)
    np.testing.assert_allclose(
        ttri.parallax_cos(t(c1), t(c2), t(X_j)).numpy(),
        np.asarray(jtri.parallax_cos(jnp.asarray(c1), jnp.asarray(c2),
                                     jnp.asarray(X_j))),
        rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("baseline,depth", [(2.0, (1.5, 3.0)),
                                            (0.3, (3.0, 8.0))])
def test_line_triangulation_matches_jax(baseline, depth):
    """unproject, line_from_endpoints_2d, backproject_plane,
    intersect_ray_plane and triangulate_line_two_view on the same float32
    inputs. Tolerance: 1e-5 relative on the wide baseline (a plane's
    coefficients sum terms of ~1e3 that cancel, so they are compared
    relative to the plane's norm). On the narrow one (a keyframe pair) a
    ray's intersection with a nearly parallel plane amplifies one-ulp
    differences, and both packages are up to ~3e-4 from the float64
    solution: there the port must be as close to it as the JAX package
    (within 1.25x), as for the DLT above."""
    from plslam_tpu.geometry import triangulation as jtri
    from plslam_tpu_torch.geometry import triangulation as ttri
    rng = np.random.default_rng(5)
    n = 200
    A = np.stack([rng.uniform(-2, 2, n), rng.uniform(-1.5, 1.5, n),
                  rng.uniform(*depth, n)], -1)
    B = A + rng.normal(0, 0.5, (n, 3))
    T1 = np.asarray(jse3.se3_exp(jnp.asarray([0.01, -0.02, 0.0, 0.0, 0.0,
                                              0.0])))
    T2 = np.asarray(jse3.se3_exp(jnp.asarray([0.03, 0.05, -0.01, -baseline,
                                              0.02, 0.05])))
    uv = []
    for T in (T1, T2):
        for X in (A, B):
            Xc = X @ T[:3, :3].T + T[:3, 3]
            uv.append((Xc[:, :2] / Xc[:, 2:] * 500.0 + [320.0, 240.0]
                       + rng.normal(0, 0.3, (n, 2))).astype(np.float32))
    jc = jcam.Camera.create(500.0, 500.0, 320.0, 240.0)
    tc = tcam.Camera.create(500.0, 500.0, 320.0, 240.0)
    t = lambda a: torch.from_numpy(np.array(a, np.float32))
    rel = lambda a, b: (np.abs(np.asarray(a) - np.asarray(b))
                        / np.maximum(np.abs(np.asarray(b)), 1.0)).max()
    assert rel(tcam.unproject(tc, t(uv[0])), jcam.unproject(
        jc, jnp.asarray(uv[0]))) < 1e-6
    l_t = ttri.line_from_endpoints_2d(t(uv[2]), t(uv[3]))
    l_j = jtri.line_from_endpoints_2d(jnp.asarray(uv[2]), jnp.asarray(uv[3]))
    assert rel(l_t, l_j) < 1e-5
    plane_t = ttri.backproject_plane(tcam.intrinsics(tc), t(T2), l_t)
    plane_j = np.asarray(jtri.backproject_plane(jc, jnp.asarray(T2), l_j))
    assert (np.abs(plane_t.numpy() - plane_j).max(-1)
            / np.linalg.norm(plane_j, axis=-1)).max() < 1e-5
    ray = np.asarray(jcam.unproject(jc, jnp.asarray(uv[0])))
    origin = np.zeros((n, 3), np.float32)
    got = list(ttri.intersect_ray_plane(t(origin), t(ray), plane_t)) + list(
        ttri.triangulate_line_two_view(tc, t(T1), t(T2), *map(t, uv)))
    want = list(jtri.intersect_ray_plane(
        jnp.asarray(origin), jnp.asarray(ray), jnp.asarray(plane_j))) + list(
        jtri.triangulate_line_two_view(jc, jnp.asarray(T1), jnp.asarray(T2),
                                       *map(jnp.asarray, uv)))
    if baseline >= 1.0:
        for a, b in zip(got, want):
            assert rel(a, b) < 1e-5
    else:
        d = lambda a: t(a).double()
        ref = list(ttri.intersect_ray_plane(
            d(origin), d(ray), ttri.backproject_plane(
                tcam.intrinsics(tc).double(), d(T2),
                ttri.line_from_endpoints_2d(d(uv[2]), d(uv[3]))))) + list(
            ttri.triangulate_line_two_view(tc, d(T1), d(T2), *map(d, uv)))
        for a, b, c in zip(got, want, ref):
            assert rel(a, c) <= 1.25 * rel(b, c) < 1e-3
    # the rays have unit z: the ray parameter is the depth in view 1
    Xa_c1 = got[2].numpy() @ T1[:3, :3].T + T1[:3, 3]
    np.testing.assert_allclose(Xa_c1[:, 2], got[4].numpy(), rtol=1e-4)

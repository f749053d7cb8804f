"""The port's data path against the JAX package's: trajectory metrics,
the native loader (and cv2 where it is not built), the TUM / KITTI / EuRoC index parsers, photo-textured scenes and the
TUM sequence writer.

Tolerances and why:
- the metrics are the same numpy code: bit-equal;
- both native loaders compile the same decoders: frames bit-equal, and the
  cv2 path bit-equal to cv2's own reads;
- scenes, textures and renders are the same numpy code on the same photo
  bits: bit-equal; trajectories within the port's SE3 exponential (1e-6,
  as tests/test_torch_geometry.py holds them).
"""
import os

import numpy as np
import pytest

from torch_threads import one_thread  # noqa: F401

cv2 = pytest.importorskip("cv2")


def _poses(rng, n):
    from plslam_tpu_torch.geometry import se3
    import torch
    xi = rng.normal(0, [0.2, 0.2, 0.2, 1.0, 1.0, 1.0], (n, 6)).astype(np.float32)
    return se3.se3_exp(torch.from_numpy(xi)).numpy().astype(np.float64)


@pytest.mark.parametrize("with_scale", [True, False])
def test_metrics_match_jax(with_scale):
    from plslam_tpu.utils import metrics as jm
    from plslam_tpu_torch.utils import metrics as tm
    rng = np.random.default_rng(7)
    T_gt = _poses(rng, 40)
    T_est = T_gt.copy()
    T_est[:, :3, 3] = 0.8 * T_est[:, :3, 3] + rng.normal(0, 0.05, (40, 3))
    np.testing.assert_array_equal(tm.centers_of(T_est), jm.centers_of(T_est))
    for a, b in zip(tm.umeyama_align(tm.centers_of(T_est),
                                     tm.centers_of(T_gt), with_scale),
                    jm.umeyama_align(jm.centers_of(T_est),
                                     jm.centers_of(T_gt), with_scale)):
        np.testing.assert_array_equal(a, b)
    assert tm.ate_rmse(T_est, T_gt, with_scale) == \
        jm.ate_rmse(T_est, T_gt, with_scale)
    assert tm.rpe_rmse(T_est, T_gt, 3) == jm.rpe_rmse(T_est, T_gt, 3)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """Gray PNG (8-bit, from a colour image too), JPEG and 16-bit PNG files
    written by cv2."""
    d = tmp_path_factory.mktemp("imgs")
    rng = np.random.default_rng(0)
    gray = [rng.integers(0, 256, (37 + i, 53), dtype=np.uint8)
            for i in range(4)]
    paths = []
    for i, g in enumerate(gray):
        paths.append(str(d / f"g{i}.png"))
        cv2.imwrite(paths[-1], g)
    colour = rng.integers(0, 256, (24, 31, 3), dtype=np.uint8)
    cv2.imwrite(str(d / "c.png"), colour)
    cv2.imwrite(str(d / "j.jpg"), cv2.GaussianBlur(
        rng.integers(0, 256, (48, 64, 3), dtype=np.uint8), (5, 5), 0))
    return dict(dir=d, gray=gray, paths=paths,
                extra=[str(d / "c.png"), str(d / "j.jpg")])


def test_loaders_decode_and_prefetch_alike(images):
    from plslam_tpu.utils import native_loader as jl
    from plslam_tpu_torch.utils import native_loader as tl
    assert tl.native_available(), tl.build_error()
    assert str(tl.BUILD_DIR).endswith(os.path.join("build", "plslam_tpu_torch"))
    paths = images["paths"] + images["extra"]
    for p in paths:
        np.testing.assert_array_equal(tl.decode_gray(p), jl.decode_gray(p))
    for g, p in zip(images["gray"], images["paths"]):
        np.testing.assert_array_equal(tl.decode_gray(p), g)
    lt, lj = tl.PrefetchLoader(paths, queue_depth=2), jl.PrefetchLoader(paths)
    assert lt.native
    got = list(lt)
    assert len(got) == len(paths)
    for a, b in zip(got, lj):
        np.testing.assert_array_equal(a, b)
    lt.close()
    lj.close()


def test_cv2_prefetch_without_the_native_loader(images, monkeypatch):
    """Where the native loader cannot be built, frames decode through cv2,
    ahead of the caller on threads, in order."""
    from plslam_tpu_torch.utils import native_loader as tl
    monkeypatch.setattr(tl, "_lib", lambda: None)
    paths = images["paths"] + images["extra"]
    loader = tl.PrefetchLoader(paths, queue_depth=2, n_threads=2)
    assert not loader.native
    got = list(loader)
    loader.close()
    assert len(got) == len(paths)
    for img, p in zip(got, paths):
        np.testing.assert_array_equal(img, cv2.imread(p, cv2.IMREAD_GRAYSCALE))
    np.testing.assert_array_equal(tl.decode_gray(paths[0]), images["gray"][0])


def test_index_parsers_match_jax(tmp_path):
    from plslam_tpu.datasets import euroc as je, kitti as jk, tum as jt
    from plslam_tpu_torch.datasets import euroc as te, kitti as tk, tum as tt
    (tmp_path / "rgb.txt").write_text(
        "# color images\n# timestamp filename\n"
        "1305031102.175304 rgb/1305031102.175304.png\n\n"
        "1305031102.211214 rgb/1305031102.211214.png extra\n")
    (tmp_path / "assoc.txt").write_text(
        "# t_rgb rgb t_depth depth\n"
        "1.0 rgb/1.png 1.01 depth/1.png\n2.0 rgb/2.png 2.02 depth/2.png\n")
    (tmp_path / "times.txt").write_text("0.000000e+00\n1.036000e-01\n\n")
    (tmp_path / "ts.txt").write_text(
        "#timestamp [ns]\n1403636579763555584\n1403636579813555456\n")
    for a, b in zip(tt.load_rgb_index(str(tmp_path)),
                    jt.load_rgb_index(str(tmp_path))):
        np.testing.assert_array_equal(a, b)
    assert tt.load_associations(str(tmp_path / "assoc.txt"), "/s") == \
        jt.load_associations(str(tmp_path / "assoc.txt"), "/s")
    for a, b in zip(tk.load_index(str(tmp_path), "image_1"),
                    jk.load_index(str(tmp_path), "image_1")):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(te.load_index("/cam0", str(tmp_path / "ts.txt")),
                    je.load_index("/cam0", str(tmp_path / "ts.txt"))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("seed,layout", [(5, "open"), (3, "room")])
def test_photo_scene_matches_jax(seed, layout):
    from plslam_tpu.datasets import textured as jtex
    from plslam_tpu_torch.datasets import textured as ttex
    st = ttex.make_photo_scene(seed=seed, layout=layout)
    sj = jtex.make_photo_scene(seed=seed, layout=layout)
    assert len(st.planes) == len(sj.planes) == (6 if layout == "room" else 3)
    for pt, pj in zip(st.planes, sj.planes):
        for a, b in zip(pt, pj):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(st[1:], sj[1:]):
        np.testing.assert_array_equal(a, b)


def test_photo_file_is_the_matplotlib_sample():
    matplotlib = pytest.importorskip("matplotlib")
    Image = pytest.importorskip("PIL.Image")
    from plslam_tpu_torch.datasets import textured as ttex
    path = os.path.join(matplotlib.get_data_path(), "sample_data",
                        "grace_hopper.jpg")
    ref = np.asarray(Image.open(path).convert("L"))
    with np.load(ttex.PHOTO_PATH) as f:
        photo = f["photo"]
    assert photo.shape == (600, 512) and photo.dtype == np.uint8
    np.testing.assert_array_equal(photo, ref)


def test_photo_render_and_sequence_round_trip(tmp_path):
    from plslam_tpu.datasets import synthetic as jsyn, textured as jtex
    from plslam_tpu.datasets import tum as jt
    from plslam_tpu_torch.datasets import synthetic as tsyn, textured as ttex
    from plslam_tpu_torch.datasets import tum as tt
    kw = dict(seed=5, width=320, height=240, fx=250.0, fy=250.0)
    st, sj = ttex.make_photo_scene(**kw), jtex.make_photo_scene(**kw)
    Tt, Tj = tsyn.trajectory(20, "orbit"), jsyn.trajectory(20, "orbit")
    np.testing.assert_allclose(Tt, Tj, atol=1e-6)
    ft = tsyn.render_sequence(st, Tj[:3])
    np.testing.assert_array_equal(ft, jsyn.render_sequence(sj, Tj[:3]))
    np.testing.assert_array_equal(tsyn.render(st, Tj[7]), jsyn.render(sj, Tj[7]))
    tss = [i / 30.0 for i in range(3)]
    ttex.write_tum_sequence(str(tmp_path / "t"), ft, tss)
    jtex.write_tum_sequence(str(tmp_path / "j"), ft, tss)
    assert (tmp_path / "t" / "rgb.txt").read_text() == \
        (tmp_path / "j" / "rgb.txt").read_text()
    ts_j, paths_j = jt.load_rgb_index(str(tmp_path / "t"))
    np.testing.assert_allclose(ts_j, tss, atol=1e-6)   # written as %.6f
    got = list(tt.frames(str(tmp_path / "t")))
    assert [t for t, _ in got] == [float(t) for t in ts_j]
    for (_, img), f, p in zip(got, ft, paths_j):
        expect = np.clip(f, 0, 255).astype(np.uint8)
        np.testing.assert_array_equal(img, expect)
        np.testing.assert_array_equal(tt.read_gray(p), expect.astype(np.float32))
    with pytest.raises(FileNotFoundError):
        tt.read_gray(str(tmp_path / "missing.png"))


def test_viz_draws_as_jax():
    """`draw_frame` and `draw_map_topdown` on the port's tensors draw the
    JAX package's images from the same values."""
    from types import SimpleNamespace
    import torch
    from plslam_tpu.utils import viz as jviz
    from plslam_tpu_torch.utils import viz as tviz
    rng = np.random.default_rng(4)
    img = rng.integers(0, 256, (120, 160)).astype(np.float32)
    uv = rng.uniform(0, [160, 120], (40, 2)).astype(np.float32)
    valid, matched = rng.random(40) < 0.8, rng.random(40) < 0.5
    ua, ub = (rng.uniform(0, [160, 120], (6, 2)).astype(np.float32)
              for _ in range(2))
    lvalid = np.array([1, 1, 0, 1, 1, 1], bool)
    T = lambda x: torch.tensor(np.array(x))
    args_t = (T(img), SimpleNamespace(uv=T(uv), valid=T(valid)),
              SimpleNamespace(uv_a=T(ua), uv_b=T(ub), valid=T(lvalid)),
              T(matched), T(lvalid[::-1]))
    args_j = (img, SimpleNamespace(uv=uv, valid=valid),
              SimpleNamespace(uv_a=ua, uv_b=ub, valid=lvalid), matched,
              lvalid[::-1])
    np.testing.assert_array_equal(tviz.draw_frame(*args_t),
                                  jviz.draw_frame(*args_j))
    kf_T = np.tile(np.eye(4, dtype=np.float32), (4, 1, 1))
    kf_T[:, :3, 3] = rng.normal(0, 1, (4, 3))
    ms = dict(pt_xyz=rng.normal(0, 2, (50, 3)).astype(np.float32),
              pt_valid=rng.random(50) < 0.7, n_kf=np.int32(3), kf_T=kf_T,
              ln_xyz=rng.normal(0, 2, (5, 2, 3)).astype(np.float32),
              ln_valid=np.array([1, 0, 1, 1, 0], bool))
    traj = [(0.1 * i, kf_T[i % 4]) for i in range(6)]
    np.testing.assert_array_equal(
        tviz.draw_map_topdown(SimpleNamespace(**{k: T(v) for k, v in
                                                 ms.items()}),
                              [(t, T(M)) for t, M in traj], size=200),
        jviz.draw_map_topdown(SimpleNamespace(**ms), traj, size=200))

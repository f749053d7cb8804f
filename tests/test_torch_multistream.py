"""The port's `BatchedTracker` against the JAX package's, on the CPU.

S = 3 streams at 320x240 (256 features, 3 levels, lines on, 6 keyframes x
1024 points), each rendering its own scene (`make_scene(seed=100 + s)`,
orbit) and bootstrapped with a keyframe and points from frame 0's rendered
depth (the port's `insert_keyframe` + `create_points_from_depth`; the same
numpy maps go to both packages), then 4 lockstep frames, the first of them
a keyframe step (`kf_interval` 5, the JAX tracker's cadence). The port's
own multi-stream tests are in tests/test_torch_multistream_port.py, the
round-robin tracker's in tests/test_torch_roundrobin.py; they share this
file's scenes and maps.

Bars and why: poses within 2e-4, inliers within 2 (the tracking bars:
6x6 float32 solves summed in another order, the chi2 gate flipping at its
border, and an LM step accepted in one package and refused in the other;
on stream 2's first frame the port's unbatched step alone is 1.5e-4 from
JAX's, so the 1e-4 of a single optimization is out of reach there; the
pose solve in the JAX package's einsum form comes to 7.2e-5 but parts the
batched step from the single one, and over the port's parity tests it is
the farther from JAX: scripts/pose_solve_forms.py), the
keyframe's point bindings (its `matched_pt`) >= 99% equal and the keyframe
step's map counts equal."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plslam_tpu.mapstate import state as jstate
from plslam_tpu.models import system as jsys
from plslam_tpu.parallel import multistream as jms
from plslam_tpu_torch.datasets import synthetic
from plslam_tpu_torch.geometry import camera as tcam
from plslam_tpu_torch.mapstate import checkpoint as tckpt, state as tstate
from plslam_tpu_torch.models import mapping as tmap
from plslam_tpu_torch.models import system as tsys
from plslam_tpu_torch.ops import extract as text, stereo
from plslam_tpu_torch.parallel import multistream as tms
from torch_threads import one_thread  # noqa: F401

H, W, FX, S, N_STEPS = 240, 320, 250.0, 3, 4
CFG = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, k1=0, k2=0, p1=0, p2=0, k3=0,
           width=W, height=H, n_features=256, n_levels=3, max_kf=6,
           max_pt=1024, max_ln=64, n_lf=32, ba_window=4, ba_points=512,
           ba_lines=32, use_loop_closing=False, grow_map=False)


def _render(n_frames=N_STEPS + 1, streams=S):
    """Per stream: the frames and frame 0's depth."""
    Ts = synthetic.trajectory(24, "orbit")
    out = []
    for s in range(streams):
        scene = synthetic.make_scene(seed=100 + s, width=W, height=H, fx=FX,
                                     fy=FX)
        img0, depth0 = synthetic.render_rgbd(scene, Ts[0])
        frames = [img0] + [synthetic.render(scene, T)
                           for T in Ts[1:n_frames]]
        out.append((np.stack(frames).astype(np.uint8), depth0))
    return Ts[:n_frames], out


def depth_map(cfg, img, depth):
    """The port's map of one frame: a keyframe at the origin and points
    from its depth (as chip_smoke's slice bootstraps its map)."""
    c = tsys.SLAMConfig(**cfg)
    ext_cfg = text.ExtractorConfig(n_features=c.n_features,
                                   n_levels=c.n_levels)
    sf, _ = text.scale_factors(ext_cfg)
    cam = tcam.Camera.create(c.fx, c.fy, c.cx, c.cy, width=c.width,
                             height=c.height)
    f = text.PointExtractor(ext_cfg, c.height, c.width)(
        torch.from_numpy(img).to(torch.float32))
    f = f._replace(uv_un=tcam.undistort_pixels(cam, f.uv))
    ms = tstate.allocate(tstate.MapConfig(
        max_kf=c.max_kf, max_pt=c.max_pt, max_ln=c.max_ln,
        n_kp=c.n_features, n_lf=c.n_lf, n_levels=c.n_levels), "cpu")
    tmap.insert_keyframe(cam, ms, f, torch.eye(4),
                         torch.full((c.n_features,), -1, dtype=torch.int32),
                         0, sf)
    tmap.create_points_from_depth(
        cam, ms, ms.n_kf - 1,
        stereo.depth_at(torch.from_numpy(depth), f.uv), sf)
    return ms


def _jax_map(ms):
    return jstate.MapState(**{k: jnp.asarray(v)
                              for k, v in tckpt.to_numpy(ms).items()})


def _jax_stack(maps):
    return jax.tree_util.tree_map(lambda *x: jnp.stack(x),
                                  *[_jax_map(m) for m in maps])


@pytest.fixture(scope="module", autouse=True)
def vmap_setup():
    """vmap's per-example fallback off, so that an op of the step without a
    batching rule fails the test."""
    functorch = torch._C._functorch
    fallback = functorch._is_vmap_fallback_enabled()
    functorch._set_vmap_fallback_enabled(False)
    yield
    functorch._set_vmap_fallback_enabled(fallback)


@pytest.fixture(scope="module")
def streams():
    Ts, data = _render()
    maps = [depth_map(CFG, frames[0], depth) for frames, depth in data]
    return Ts, [frames for frames, _ in data], maps


def _run_port(maps, frames, n_steps=N_STEPS, **kw):
    bt = tms.BatchedTracker(tsys.SLAMConfig(**CFG), len(maps),
                            device="cpu", **kw)
    bt.bootstrap(tstate.stack(maps))
    Ts, sc = [], []
    for j in range(n_steps):
        T, scalars = bt.step(np.stack([f[1 + j] for f in frames]))
        Ts.append(T.numpy())
        sc.append(scalars.numpy())
    return bt, np.stack(Ts), np.stack(sc)


@pytest.fixture(scope="module")
def runs(streams):
    _, frames, maps = streams
    port = _run_port(maps, frames)
    jt = jms.BatchedTracker(jsys.SLAMConfig(**CFG), S, mesh=None)
    jt.bootstrap(_jax_stack(maps))
    Ts, sc = [], []
    for j in range(N_STEPS):
        T, scalars = jt.step(np.stack([f[1 + j] for f in frames]))
        Ts.append(np.asarray(T))
        sc.append(np.asarray(scalars))
    return port, (jt, np.stack(Ts), np.stack(sc))


def test_batched_tracker_matches_jax(runs):
    (bt, Tp, sp), (jt, Tj, sj) = runs
    np.testing.assert_allclose(Tp, Tj, atol=2e-4)
    assert np.abs(sp[..., 0].astype(int) - sj[..., 0]).max() <= 2
    assert (sp[..., 0] >= 30).all(), sp[..., 0]
    # the keyframe step's map counts, and the keyframe's bindings
    for name in ("n_kf", "n_pt", "n_ln"):
        np.testing.assert_array_equal(getattr(bt.ms, name).numpy(),
                                      np.asarray(getattr(jt.ms, name)))
    rows_p = bt.ms.kf_pt_idx[:, 1].numpy()
    rows_j = np.asarray(jt.ms.kf_pt_idx[:, 1])
    assert (rows_p == rows_j).mean() >= 0.99
    for s, one in enumerate(tstate.unstack(bt.ms, S)):   # the stream views
        assert torch.equal(one.kf_T, bt.ms.kf_T[s])

"""The port's stream-sharded tracking on two gloo ranks on the CPU.

One world-2 spawn (one torch thread per rank, no jax in the ranks:
tests/torch_mesh_ranks.py) runs:
- tests/test_parallel.py's scenario (8 streams of random 320x240 images
  and maps of 256 random points, 128 features, 2 levels, tracking from the
  identity) through `shard_streams`, the vmapped step on each rank's 4
  streams and `gather_streams`: bit-equal to the port's unsharded batched
  step in this process (on the CPU the batched step is bit-equal to each
  stream alone: tests/test_torch_multistream_port.py), and within 1e-4
  (poses) and 2 (inliers) of the JAX package's step on its 8-device mesh
  (tests/test_torch_multistream.py's tracking bars, a float32 6x6 solve
  summed in another order);
- `BatchedTracker(mesh=)` over 4 rendered streams (tests/
  test_torch_multistream.py's widths, maps from frame 0's depth) for 2
  lockstep frames, the first a keyframe step: poses and scalars bit-equal
  to the unsharded tracker's, on every rank.
`dryrun_multichip` runs at world 2 at the JAX dry run's widths."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from plslam_tpu.mapstate import state as jstate
from plslam_tpu.models import tracking as jtrk
from plslam_tpu.ops import extract as jext
from plslam_tpu.parallel import streams as jstreams
from plslam_tpu_torch.datasets import synthetic
from plslam_tpu_torch.mapstate import state as tstate
from plslam_tpu_torch.models import system as tsys
from plslam_tpu_torch.ops import extract as text
from plslam_tpu_torch.parallel import multichip, multistream, streams

from test_parallel import CAM as JCAM
import torch_mesh_ranks as ranks
from torch_threads import one_thread  # noqa: F401

S, WORLD = 8, 2
TRACK_STREAMS, TRACK_FRAMES = 4, 2
H, W, FX = 240, 320, 250.0
CFG = dict(fx=FX, fy=FX, cx=W / 2, cy=H / 2, k1=0, k2=0, p1=0, p2=0, k3=0,
           width=W, height=H, n_features=256, n_levels=3, max_kf=6,
           max_pt=1024, max_ln=64, n_lf=32, ba_window=4, ba_points=512,
           ba_lines=32, use_loop_closing=False, grow_map=False)


@pytest.fixture(scope="module")
def scene():
    """tests/test_parallel.py's images and map points."""
    rng = np.random.default_rng(1)
    pts = []
    for seed in range(S):
        r = np.random.default_rng(seed)
        pts.append(np.stack([r.uniform(-1, 1, 256), r.uniform(-1, 1, 256),
                             r.uniform(2, 5, 256)], -1).astype(np.float32))
    imgs = np.stack([rng.uniform(0, 255, (240, 320)).astype(np.float32)
                     for _ in range(S)])
    return imgs, np.stack(pts)


@pytest.fixture(scope="module")
def tracker_streams(tmp_path_factory):
    """4 rendered streams' maps and frames written as `lockstep_rank`
    reads them, and the unsharded tracker's poses and scalars."""
    cfg = tsys.SLAMConfig(**CFG)
    Ts = synthetic.trajectory(24, "orbit")
    maps, frames = [], []
    for s in range(TRACK_STREAMS):
        sc = synthetic.make_scene(seed=100 + s, width=W, height=H, fx=FX,
                                  fy=FX)
        img0, depth0 = synthetic.render_rgbd(sc, Ts[0])
        frames.append([img0] + [synthetic.render(sc, T)
                                for T in Ts[1:TRACK_FRAMES + 1]])
        maps.append(multichip.depth_map(cfg, img0, depth0, "cpu"))
    frames = np.asarray(frames, np.uint8)
    paths = multichip.save_streams(str(tmp_path_factory.mktemp("streams")),
                                   maps, frames)
    bt = multistream.BatchedTracker(cfg, TRACK_STREAMS, device="cpu")
    bt.bootstrap(tstate.stack(maps))
    out = [bt.step(frames[:, 1 + j]) for j in range(TRACK_FRAMES)]
    return cfg, paths, (np.stack([T.numpy() for T, _ in out]),
                        np.stack([s.numpy() for _, s in out]))


@pytest.fixture(scope="module")
def ranks_out(scene, tracker_streams):
    imgs, pts = scene
    cfg, paths, _ = tracker_streams
    return streams.spawn(ranks.streams_and_tracker, WORLD, "gloo",
                         device="cpu", threads=1, timeout=300,
                         args=(imgs, pts, (cfg, *paths, TRACK_FRAMES)))


def test_sharded_step_matches_unsharded(scene, ranks_out):
    imgs, pts = scene
    sf, s2 = text.scale_factors(ranks.SCENE_CFG)
    T, sc = torch.func.vmap(ranks.scene_step(ranks.CAM, sf, s2))(
        torch.from_numpy(imgs), ranks.scene_maps(pts))
    for o in ranks_out:
        assert np.array_equal(o["T"], T.numpy())
        assert np.array_equal(o["scalars"], sc.numpy())


def test_sharded_step_matches_jax_mesh(scene, ranks_out):
    imgs, pts = scene
    cfg = jext.ExtractorConfig(n_features=128, n_levels=2)
    map_cfg = jstate.MapConfig(max_kf=4, max_pt=256, max_ln=16, n_kp=128,
                               n_lf=8, n_levels=2)
    sf, s2 = jext.scale_factors(cfg)

    def make_ms(p):
        return jstate.allocate(map_cfg)._replace(
            pt_xyz=jnp.asarray(p), pt_valid=jnp.ones(256, bool),
            pt_max_dist=jnp.full((256,), 10.0),
            pt_min_dist=jnp.full((256,), 0.1),
            pt_normal=jnp.asarray(-p / np.linalg.norm(p, axis=-1,
                                                      keepdims=True)))

    def one(img, ms):
        feats = jext.extract_points(img, cfg)
        feats = feats._replace(uv_un=feats.uv)
        r = jtrk.track_local_map(JCAM, ms, feats, jnp.eye(4),
                                 scale_factors=sf, sigma2_levels=s2,
                                 n_levels=2, scale=1.2)
        return r.T, r.scalars

    mesh = jstreams.make_mesh()
    ms_b = jstreams.shard_streams(mesh, jax.tree_util.tree_map(
        lambda *xs: jnp.stack(xs), *[make_ms(p) for p in pts]))
    img_b = jax.device_put(jnp.asarray(imgs),
                           NamedSharding(mesh, P("stream")))
    with mesh:
        Tj, sj = jax.jit(jax.vmap(one))(img_b, ms_b)
    o = ranks_out[0]
    np.testing.assert_allclose(o["T"], np.asarray(Tj), atol=1e-4)
    assert np.abs(o["scalars"][:, 0].astype(int)
                  - np.asarray(sj)[:, 0]).max() <= 2


def test_mesh_tracker_matches_unsharded(tracker_streams, ranks_out):
    _, _, (T, sc) = tracker_streams
    for o in ranks_out:
        t = o["tracker"]
        assert t["poses"].shape == (TRACK_FRAMES, TRACK_STREAMS, 4, 4)
        assert np.array_equal(t["poses"], T)
        assert np.array_equal(t["scalars"], sc)
    assert (sc[..., 0] >= 30).all(), sc[..., 0]


def test_dryrun_multichip_world2():
    out = multichip.dryrun_multichip(WORLD, "gloo", "cpu", threads=1)
    assert len(out) == WORLD
    assert out[0]["T"].shape == (WORLD, 4, 4)
    assert (out[0]["n_kf"] == 3).all()


"""The PyTorch port's dispatch paths against the JAX package's:
`System.track_chunked`, `track_synced` and `async_pipeline`, at
tests/test_bench_paths.py's tiny configuration (384 features, 3 levels,
8 keyframes x 2048 points, lines on, loop closing and growth off).

Both Systems start each phase from the same state: the JAX System's (after
its two-view initialization, then after each phase), carried to the port
with `mapstate/checkpoint.from_numpy` together with T_last, the velocity
and the frame and keyframe counters (a keyframe's local BA moves the two
maps apart by more than the tracking step's tolerance, so the state is
carried again before every phase; the port keeps its own trajectory and
stats). Both take the same frames of
`make_scene(seed=7)` along an orbit: two chunks of 4 frames, two synced
frames, a chunk whose second frame is blank (LOST inside a chunk) and four
frames through the asynchronous pipeline at depth 2.

Bounds (the tracking step's, ROADMAP item 7): per-frame poses within 1e-4,
inliers within 2, the same keyframe and LOST decision on every frame, the
same keyframe count, and the same trajectory entries marked lost. On the
CPU the steps run eagerly; the CUDA graphs of the same steps are held
against the eager steps in tests/test_torch_cuda.py."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from plslam_tpu.datasets import synthetic as jsyn
from plslam_tpu.models import system as jsys
from plslam_tpu_torch.mapstate import checkpoint
from plslam_tpu_torch.models import step_graph, system as tsys
from torch_threads import one_thread  # noqa: F401

CFG = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, k1=0, k2=0, p1=0, p2=0,
           k3=0, n_features=384, n_levels=3, max_kf=8, max_pt=2048, n_lf=32,
           ba_window=3, ba_points=512, ba_lines=32, kf_max_interval=5,
           use_loop_closing=False, grow_map=False, min_init_matches=60)
B = 4
POSE_TOL = 1e-4
INLIER_TOL = 2


def _frames(n=24):
    scene = jsyn.make_scene(seed=7)
    Ts = jsyn.trajectory(n, "orbit", amplitude=1.0)
    return [np.asarray(jsyn.render(scene, T)).astype(np.uint8) for T in Ts]


def _carry_over(j, t):
    """The JAX System's map and tracking state into the port's System `t`
    (its own trajectory and stats stay)."""
    t.ms = checkpoint.from_numpy(
        {k: np.array(v) for k, v in j.ms._asdict().items()}, "cpu")
    t.state = j.state
    t.T_last = torch.from_numpy(np.array(j.T_last))
    t.velocity = torch.from_numpy(np.array(j.velocity))
    for name in ("frame_id", "n_kf_host", "last_kf_frame",
                 "last_reloc_frame", "ref_kf_matches", "_occupancy"):
        setattr(t, name, getattr(j, name))
    t.kf_timestamps = list(j.kf_timestamps)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.fixture(scope="module")
def runs():
    """Both Systems through the four phases; per phase, each package's
    per-frame poses, the stats entries the phase added and the keyframe
    count after it."""
    frames = _frames()
    j = jsys.System(jsys.SLAMConfig(**CFG))
    i = 0
    while j.state != "OK" and i < 6:
        j.track_monocular(frames[i], i / 30.0)
        i += 1
    assert j.state == "OK", "two-view init failed on the fixture"
    t = tsys.System(tsys.SLAMConfig(**CFG), device="cpu")
    t._traj = [(ts, None if T is None else np.array(T, np.float32), ref,
                lost) for ts, T, ref, lost in j._traj]
    traj0 = len(j._traj)
    blank = np.full_like(frames[0], 128)
    out = {"start": i, "traj0": traj0}

    def phase(name, drive):
        # each phase from the same state: a keyframe's local BA moves the
        # two maps apart by more than the tracking step's tolerance
        _carry_over(j, t)
        res = {}
        for pkg, slam in (("jax", j), ("port", t)):
            n0 = len(slam.stats)
            poses = drive(slam)
            slam.flush()
            res[pkg] = dict(poses=[_np(T) for T in poses],
                            stats=slam.stats[n0:], n_kf=slam.n_kf_host)
        out[name] = res

    def chunks(slam, first, imgs_of):
        poses = []
        for c in range(2 if imgs_of is None else 1):
            c0 = first + c * B
            imgs = np.stack([frames[c0 + k] for k in range(B)]) \
                if imgs_of is None else imgs_of
            stack = jnp.asarray(imgs) if slam is j else torch.from_numpy(imgs)
            Ts = slam.track_chunked(stack, [(c0 + k) / 30.0
                                            for k in range(B)])
            poses += list(_np(Ts))
        return poses

    phase("chunked", lambda s: chunks(s, i, None))
    i += 2 * B
    phase("synced", lambda s: [s.track_synced(
        frames[i + k] if s is t else jnp.asarray(frames[i + k]),
        (i + k) / 30.0) for k in range(2)])
    i += 2
    lost_imgs = np.stack([frames[i], blank, frames[i + 2], frames[i + 3]])
    lost_at = len(j._traj) + 1
    phase("lost", lambda s: chunks(s, i, lost_imgs))
    out["lost_entry"] = {"jax": j._traj[lost_at], "port": t._traj[lost_at],
                         "before": (j._traj[lost_at - 1],
                                    t._traj[lost_at - 1])}
    i += B
    for s in (j, t):
        s.cfg.async_pipeline, s.cfg.async_depth = True, 2
    pending = []

    def async_run(s):
        poses = []
        for k in range(4):
            poses.append(s.track_monocular(frames[i + k], (i + k) / 30.0))
            if s is t:
                pending.append(len(t._pending))
        return poses
    phase("async", async_run)
    out["pending"] = pending
    out["trajectories"] = (j.trajectory, t.trajectory)
    out["systems"] = (j, t)
    return out


def _assert_phase(r, name):
    jx, pt = r[name]["jax"], r[name]["port"]
    assert len(pt["poses"]) == len(jx["poses"]) > 0
    for k, (a, b) in enumerate(zip(pt["poses"], jx["poses"])):
        np.testing.assert_allclose(a, b, atol=POSE_TOL,
                                   err_msg=f"{name}: frame {k}")
    assert len(pt["stats"]) == len(jx["stats"]) == len(jx["poses"])
    for k, (a, b) in enumerate(zip(pt["stats"], jx["stats"])):
        assert abs(a["inliers"] - b["inliers"]) <= INLIER_TOL, (name, k)
        assert (a["kf"], a["lost"]) == (b["kf"], b["lost"]), (name, k, a, b)
    assert pt["n_kf"] == jx["n_kf"]


def test_track_chunked_matches_jax(runs):
    """Two chunks of 4: poses, inliers, per-frame decisions, keyframes."""
    _assert_phase(runs, "chunked")
    assert not any(s["lost"] for s in runs["chunked"]["port"]["stats"])


def test_track_chunked_makes_keyframes_one_chunk_late(runs):
    """The chunks cross the keyframe cadence: a keyframe is made from a
    frame's stacked features, in both packages on the same frame."""
    kf = [s["kf"] for s in runs["chunked"]["port"]["stats"]]
    assert any(kf)
    assert kf == [s["kf"] for s in runs["chunked"]["jax"]["stats"]]


def test_track_synced_matches_jax(runs):
    _assert_phase(runs, "synced")


def test_lost_inside_a_chunk_retro_marks_the_trajectory(runs):
    """The blank second frame of a chunk is LOST in both packages; its
    trajectory entry is marked lost after the fact (no pose) and the
    export repeats the previous frame's pose there; the frames after it
    track again."""
    _assert_phase(runs, "lost")
    lost = [s["lost"] for s in runs["lost"]["port"]["stats"]]
    assert lost == [False, True, False, False]
    for pkg in ("jax", "port"):
        ts, T_rel, _, is_lost = runs["lost_entry"][pkg]
        assert T_rel is None and is_lost
    tj, tt = runs["trajectories"]
    k = runs["lost_entry"]["before"][1][0]
    at = [n for n, (ts, _) in enumerate(tt) if ts == k][0]
    np.testing.assert_array_equal(tt[at + 1][1], tt[at][1])
    np.testing.assert_allclose(tt[at + 1][1], tj[at + 1][1], atol=POSE_TOL)


def test_async_pipeline_matches_jax(runs):
    """`async_pipeline` at depth 2: the decisions resolve in batches as the
    JAX package's (a queue of at most depth + 1 frames), to the same
    outcome; `flush` resolves the rest."""
    _assert_phase(runs, "async")
    assert runs["pending"] == [1, 2, 1, 2]
    assert runs["systems"][1]._pending == []


def test_trajectories_match_jax(runs):
    """The exported trajectories over every phase, re-anchored on the
    keyframe poses: the same timestamps, poses within 1e-4."""
    tj, tt = runs["trajectories"]
    assert [ts for ts, _ in tt] == [ts for ts, _ in tj]
    for (ts, a), (_, b) in zip(tt, tj):
        np.testing.assert_allclose(a, b, atol=POSE_TOL, err_msg=str(ts))


def test_track_chunked_falls_back_before_initialization():
    """While not initialized a chunk goes through `track_monocular` frame
    by frame and returns a list; `track_synced` does the same (blank
    frames: no keypoints, so no initialization attempt)."""
    t = tsys.System(tsys.SLAMConfig(**CFG), device="cpu")
    blank = np.full((3, 480, 640), 128, np.uint8)
    out = t.track_chunked(blank[:2], [0.0, 1 / 30.0])
    assert out == [None, None]
    assert t.track_synced(blank[2], 2 / 30.0) is None
    assert t.frame_id == 2 and len(t.timings) == 3
    assert t.state == tsys.NOT_INITIALIZED and t._init_feats is None


def test_step_graph_key_and_cpu_path():
    """The graph cache's key: the structure (None against a tensor, the
    values of static arguments), shapes and dtypes, and the map's storage
    identity, which `grow` changes; K1's wrapper is a counted one; off CUDA
    a step calls its function."""
    from plslam_tpu_torch.mapstate import state as mstate
    key = lambda *a, **k: step_graph.signature(a, k)[0]
    x = torch.zeros(3)
    assert key(x, v=None) != key(x, v=x)
    assert key(x, flag=True) != key(x, flag=False)
    assert key(x) != key(torch.zeros(4)) != key(torch.zeros(4, dtype=int))
    assert key(x, v=x) == key(torch.ones(3), v=torch.ones(3))
    _, leaves, spec, tensors = step_graph.signature((x, None),
                                                    {"k": (x, 2.0)})
    assert len(tensors) == 2
    args, kwargs = step_graph.rebuild(leaves, spec, [x + 1, x + 2])
    assert args[1] is None and kwargs["k"][1] == 2.0
    assert torch.equal(args[0], x + 1) and torch.equal(kwargs["k"][0], x + 2)
    from plslam_tpu_torch.ops import gated_match
    assert gated_match.gated_hamming_best2 in step_graph.COUNTED
    cfg = mstate.MapConfig(max_kf=4, max_pt=64, max_ln=16, n_kp=32, n_lf=8)
    ms = mstate.allocate(cfg, "cpu")
    grown = mstate.grow(ms, cfg._replace(max_pt=128))
    assert step_graph.identity(ms) == step_graph.identity(ms)
    assert step_graph.identity(grown) != step_graph.identity(ms)
    graphs = step_graph.StepGraphs("cpu")
    step = graphs.step(lambda m, a: (m.n_pt + 1, a * 2), bound=0)
    n, y = step(ms, x + 1)
    assert int(n) == 1 and torch.equal(y, 2 * (x + 1))
    assert not graphs.enabled and graphs.captures == graphs.replays == 0

"""Tests of the port that need a CUDA device: the hand-written kernels have
no CPU mode, so these skip without one. They import neither jax nor
plslam_tpu, so they also run where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""
from functools import partial

import numpy as np
import pytest
import torch

from chip_smoke import random_search_inputs
from plslam_tpu_torch.ops import gated_match


def _card_inputs(seed, n, p):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return {k: torch.from_numpy(v).cuda() for k, v in
            random_search_inputs(np.random.default_rng(seed), n, p).items()}


def _assert_matches_plain(a, gated):
    before = gated_match.gated_hamming_best2.launches
    got = gated_match.gated_hamming_best2(**a, gated=gated)
    assert gated_match.gated_hamming_best2.launches == before + 1
    want = gated_match.gated_hamming_best2_reference(**a, gated=gated)
    for x, y in zip(got, want):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())
    return got


# Edge shapes around the kernel's tiles (80 queries per block, 64-point map
# tiles split over a cluster of up to 8 blocks): a single pair, one past a
# query tile and a map tile, ragged tails, and one past the tracking step's
# map. chip_smoke.py checks the tracking step's own shapes.
@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(1, 1), (81, 65), (130, 257), (65, 129),
                                 (1024, 12288 + 1)])
def test_kernel_matches_plain_on_card(n, p):
    a = _card_inputs(n + p, n, p)
    for gated in (True, False):
        _assert_matches_plain(a, gated)


@pytest.mark.cuda
def test_kernel_ties_across_tiles_and_cluster_ranks():
    """Every descriptor equal, windows covering the image: every pair ties,
    so each row's winner is its lowest passing index, which the merge of
    lanes, warps, tiles and cluster ranks must keep."""
    a = _card_inputs(5, 300, 3000)
    a["q_bits"][:] = a["q_bits"][0]
    a["d_bits"][:] = a["q_bits"][0]
    a["d_radius"][:] = 1e4
    for gated in (True, False):
        idx, best, second = _assert_matches_plain(a, gated)
        assert (best[a["q_valid"]] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("dead", ["queries", "points"])
def test_kernel_with_nothing_to_match(dead):
    """All queries invalid, or all points invisible: INVALID, index 0."""
    a = _card_inputs(11, 200, 700)
    a["q_valid" if dead == "queries" else "d_visible"][:] = False
    for gated in (True, False):
        idx, best, second = _assert_matches_plain(a, gated)
        assert (best == gated_match.hamming.INVALID).all()
        assert (second == gated_match.hamming.INVALID).all()
        assert (idx == 0).all()


@pytest.mark.cuda
def test_kernel_call_never_waits_for_the_device():
    a = _card_inputs(3, 1024, 12288)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = gated_match.gated_hamming_best2(**a)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    want = gated_match.gated_hamming_best2_reference(**a)
    for x, y in zip(out, want):
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())


@pytest.mark.cuda
def test_kernel_matches_plain_at_match_frames_shape():
    """K1 as `match_frames` calls it: 1024 x 1024 features of two frames,
    a 100 px window, octaves within 1."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from chip_smoke import match_frames_inputs
    a = {k: torch.from_numpy(v).cuda() for k, v in
         match_frames_inputs(np.random.default_rng(7)).items()}
    _assert_matches_plain(a, True)


@pytest.mark.cuda
@pytest.mark.parametrize("use_lines,sensor", [
    pytest.param(False, "mono", id="False"),
    pytest.param(True, "mono", id="True"),
    pytest.param(True, "rgbd", id="rgbd"),
    pytest.param(True, "stereo", id="stereo")])
def test_tracking_and_keyframe_chain_never_wait_for_the_device(use_lines,
                                                               sensor):
    """The System's extraction (with line detection), tracking step and
    keyframe chain, eager, at the smoke run's configuration with lines off
    and on, and with lines on through `track_rgbd` and `track_stereo` (the
    keypoint depth, the stereo search, tracking on stereo edges, the depth
    chain), under torch's sync debug mode: any op that waits for the device
    raises (the precondition of capturing the per-frame steps). Runs until
    the first keyframe of the chain (monocular) or the second keyframe
    after the depth initialization."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import dataclasses
    import chip_smoke
    from chip_smoke import render_system_sequence, system_config
    from plslam_tpu_torch.models.system import System

    if sensor == "mono":
        cfg = dataclasses.replace(system_config(), use_lines=use_lines)
    else:
        cfg = chip_smoke.depth_config(sensor)
    slam = System(cfg, device=torch.device("cuda", 0), use_graphs=False)

    def no_sync(fn):
        def wrapper(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return wrapper

    for attr in ("_extract", "_track_update", "_process_kf", "_detect_lines",
                 "_depth_at", "_stereo_match", "_set_depth"):
        setattr(slam, attr, no_sync(getattr(slam, attr)))
    if sensor == "mono":
        _, frames = render_system_sequence()
        frames = [(img,) for img in frames]
    elif sensor == "rgbd":
        _, frames = chip_smoke.render_rgbd_sequence()
    else:
        _, frames, _ = chip_smoke.render_stereo_sequence()
    track = getattr(slam, "track_" + ("monocular" if sensor == "mono"
                                      else sensor))
    for i, args in enumerate(frames):
        track(*args, i / 30.0)
        if slam.n_kf_host > 2:
            break
    assert slam.state == "OK" and slam.n_kf_host == 3
    assert bool(slam.ms.kf_ln_valid[:3].any()) == use_lines
    assert (sensor == "mono") == (slam._kp_ur is None)


@pytest.mark.cuda
@pytest.mark.parametrize("empty", [False, True])
def test_kernel_forward_and_reverse_at_match_pairs_shape(empty):
    """K1 as the loop closer's `_match_pairs` calls it: 1024 x 1024
    keypoints of two keyframes, gates off, valid = the bound keypoints of
    one and visible = those of the other, then the roles swapped; repeated
    descriptor rows (ties), and with `empty` a keyframe with no bound
    keypoint. Both passes match the plain version, and the reverse pass is
    the column argmin of the masked distance matrix (the lowest index on
    ties, 0 for an empty column)."""
    a = _card_inputs(13, 1024, 1024)
    rng = np.random.default_rng(13)
    a["d_bits"][10:20] = a["d_bits"][0]
    a["q_bits"][5] = a["q_bits"][6]
    a["q_bits"][7] = a["d_bits"][0]
    bound1 = torch.from_numpy(rng.random(1024) < 0.7).cuda()
    bound2 = torch.from_numpy(rng.random(1024) < 0.6).cuda()
    if empty:
        bound2[:] = False
    zuv = torch.zeros((1024, 2), device="cuda")
    zi = torch.zeros(1024, dtype=torch.int32, device="cuda")
    zr = torch.zeros(1024, device="cuda")
    side = lambda bits, bound: dict(bits=bits, uv=zuv, oct=zi, bound=bound)
    k, c = side(a["q_bits"], bound1), side(a["d_bits"], bound2)

    def search(q, d):
        return _assert_matches_plain(dict(
            q_bits=q["bits"], q_uv=q["uv"], q_oct=q["oct"],
            q_valid=q["bound"], d_bits=d["bits"], d_uv=zuv, d_radius=zr,
            d_level=zi, d_visible=d["bound"]), gated=False)

    _, best, _ = search(k, c)
    rev, _, _ = search(c, k)
    D = gated_match.hamming.distance_matrix(a["q_bits"], a["d_bits"])
    Dm = torch.where(bound1[:, None] & bound2[None, :], D,
                     gated_match.hamming.INVALID)
    np.testing.assert_array_equal(rev.cpu().numpy(),
                                  Dm.argmin(0).cpu().numpy())
    if empty:
        assert (best == gated_match.hamming.INVALID).all()
        assert (rev == 0).all()


@pytest.mark.cuda
def test_loop_closing_and_global_ba_never_wait_for_the_device():
    """The System with loop closing on (the smoke run's system
    configuration, a keyframe every frame, a periodic global BA every 4th
    keyframe) under torch's sync debug mode: tracking, the keyframe chain,
    the loop closer's per-keyframe detection (its copy to pinned memory
    and the previous keyframe's readback included), and the global BA's
    start and rounds; any op that waits for the device raises. Runs until
    the first global-BA round."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import dataclasses
    from chip_smoke import render_system_sequence, system_config
    from plslam_tpu_torch.models.system import System

    slam = System(dataclasses.replace(
        system_config(), kf_max_interval=2, kf_min_interval=1,
        kf_ref_ratio=2.0, periodic_gba_every_kf=4),
        device=torch.device("cuda", 0), use_graphs=False)

    def no_sync(fn):
        def wrapper(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return wrapper

    for obj, attr in ((slam, "_track_update"), (slam, "_process_kf"),
                      (slam, "_start_gba"), (slam, "_step_gba"),
                      (slam.loop_closer, "detect")):
        setattr(obj, attr, no_sync(getattr(obj, attr)))
    _, frames = render_system_sequence()
    for i, img in enumerate(frames):
        slam.track_monocular(img, i / 30.0)
        if slam._gba is not None and slam._gba["round"] >= 1:
            break
    assert slam.state == "OK" and slam.n_kf_host >= 12
    assert slam._gba is not None and slam._gba["round"] == 1
    assert slam.loop_closer._pending_detect is not None


def _system_frames():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernel")
    from chip_smoke import render_system_sequence
    return render_system_sequence(12)[1]


@pytest.mark.cuda
def test_graphed_tracking_step_matches_eager_and_recaptures_after_growth():
    """The tracking graph against the eager step on the same frame, pose,
    velocity and map (a copy each), ROADMAP item 7's bars: T within 1e-4,
    inliers within 2, matched_pt >= 99% equal; one capture, three replays,
    then a growth event and a second capture on the grown map, still
    within the bars (`chip_smoke.check_graphed_step`)."""
    import chip_smoke
    frames = _system_frames()
    got = chip_smoke.check_graphed_step(frames, chip_smoke.system_config())
    assert (got["captures"], got["replays"]) == (2, 3)
    assert got["T"] <= 1e-4 and got["inliers"] <= 2
    assert got["matched"] >= 0.99


@pytest.mark.cuda
def test_chunk_frames_do_not_alias():
    """One graphed chunk of 6 against the eager chunk from the same state:
    every frame keeps its own pose and the poses agree within 1e-4, with
    the same decisions (`chip_smoke.check_chunk_frames`)."""
    import chip_smoke
    frames = _system_frames()
    got = chip_smoke.check_chunk_frames(frames, chip_smoke.system_config())
    assert got["T"] <= 1e-4 and got["captures"] >= 1


@pytest.mark.cuda
def test_graphed_system_counts_k1_replays():
    """A graphed System over 10 frames: one capture each of the extraction
    and the tracking graph, one more of the tracking graph after each
    growth event (at the defaults the line capacity grows on the first
    decision), a replay on every other call, and K1's count as in an eager
    run: 3 launches per tracked frame (as the capture recorded them) and
    one per initialization match."""
    from chip_smoke import system_config
    from plslam_tpu_torch.models.system import System
    frames = _system_frames()
    slam = System(system_config(), device=torch.device("cuda", 0))
    matches, match = [], slam._match_frames
    slam._match_frames = lambda *a: (matches.append(1), match(*a))[1]
    before = gated_match.gated_hamming_best2.launches
    tracked = 0
    for i, img in enumerate(frames[:10]):
        was = slam.state
        slam.track_monocular(img, i / 30.0)
        tracked += was == "OK"
    assert tracked >= 3 and slam.n_growths == 1
    assert slam.graphs.captures == 2 + slam.n_growths
    assert slam.graphs.replays == (10 - 1) + (tracked - 1 - slam.n_growths)
    assert gated_match.gated_hamming_best2.launches - before \
        == 3 * tracked + len(matches)


@pytest.mark.cuda
def test_entry_step_never_waits_and_its_graph_matches_eager():
    """`entry()`'s step on its example arguments: eager under sync debug
    mode "error" (no op waits for the device), then graphed: one capture
    and one replay, each bit-equal to the eager step, 3 K1 launches per
    call (the capture's warm-up counts, the capture does not)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernel")
    from plslam_tpu_torch import entry
    step, args = entry.entry()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        T_e, n_e = step.fn(*args)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    before = gated_match.gated_hamming_best2.launches
    outs = [step(*args) for _ in range(2)]
    assert gated_match.gated_hamming_best2.launches - before == 6
    assert (step.graphs.captures, step.graphs.replays) == (1, 1)
    for T, n in outs:
        assert torch.equal(T, T_e) and torch.equal(n, n_e)


@pytest.mark.cuda
def test_a_capture_survives_a_collection_of_dead_graphs():
    """An earlier `StepGraphs`' graphs, held in a reference cycle (a step
    and its `StepGraphs` point at each other, as a System's bound methods
    point at it), are freed only by the cyclic collector. A collection
    during another step's capture would destroy them mid-capture and
    invalidate it: the capture holds automatic collection off. Here the
    captured step allocates enough cyclic garbage to start automatic
    collections, and none may run while the stream captures."""
    import gc
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs")
    from plslam_tpu_torch.models.step_graph import StepGraphs
    x = torch.ones(8, device="cuda")
    old = StepGraphs("cuda").step(lambda t: t * 2)
    old(x), old(x)                       # a capture and a replay
    assert old.graphs.captures == 1
    del old                              # left to the cyclic collector
    during = []

    def seen(phase, info):
        if phase == "start" and torch.cuda.is_current_stream_capturing():
            during.append(info["generation"])

    def fn(t):
        if torch.cuda.is_current_stream_capturing():
            for _ in range(20 * gc.get_threshold()[0]):
                a = []
                a.append(a)
        return t + 1
    gc.callbacks.append(seen)
    try:
        step = StepGraphs("cuda").step(fn)
        for _ in range(2):               # the capture, then a replay
            assert torch.equal(step(x), x + 1)
    finally:
        gc.callbacks.remove(seen)
    assert (step.graphs.captures, step.graphs.replays) == (1, 1)
    assert during == [], f"collections during the capture: {during}"
    assert gc.isenabled()


@pytest.mark.cuda
def test_a_failed_capture_raises():
    """A step that waits for the device cannot be captured: the capture
    raises, and nothing falls back to eager execution."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs")
    from plslam_tpu_torch.models import step_graph
    graphs = step_graph.StepGraphs(torch.device("cuda", 0))
    step = graphs.step(lambda x: x * int(x.sum().item()))
    with pytest.raises(RuntimeError):
        step(torch.ones(4, device="cuda"))
    assert graphs.captures == 0


def _stacked_inputs(seed, S, n, p):
    """S streams' random search inputs, stacked on a leading axis."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    rng = np.random.default_rng(seed)
    one = [random_search_inputs(rng, n, p) for _ in range(S)]
    return [torch.from_numpy(np.stack([o[k] for o in one])).cuda()
            for k in one[0]]


def _assert_batched_matches_singles(a, in_dims, gated):
    """One batched launch under vmap against S single launches and the
    batched plain version, bit for bit."""
    S = next(t.shape[d] for t, d in zip(a, in_dims) if d is not None)
    before = gated_match.gated_hamming_best2.launches
    got = torch.func.vmap(
        lambda *x: gated_match.gated_hamming_best2(*x, gated=gated),
        in_dims=in_dims)(*a)
    assert gated_match.gated_hamming_best2.launches == before + 1
    # each stream's inputs as one search takes them (fresh, so aligned)
    per = lambda s: [t if d is None else t.select(d, s).clone()
                     for t, d in zip(a, in_dims)]
    singles = [gated_match.gated_hamming_best2(*per(s), gated=gated)
               for s in range(S)]
    full = [t.expand((S,) + t.shape) if d is None else t.movedim(d, 0)
            for t, d in zip(a, in_dims)]
    plain = gated_match.gated_hamming_best2_reference(*full, gated=gated)
    for k in range(3):
        one = torch.stack([x[k] for x in singles])
        assert got[k].dtype == one.dtype == plain[k].dtype
        np.testing.assert_array_equal(got[k].cpu().numpy(),
                                      one.cpu().numpy())
        np.testing.assert_array_equal(got[k].cpu().numpy(),
                                      plain[k].cpu().numpy())


# The stream axis at the kernel's edge shapes: one stream with one pair, a
# ragged query tile and map tile, and a map one past the tracking step's
# (12289 points: a stream's rows start off 16-byte alignment).
@pytest.mark.cuda
@pytest.mark.parametrize("S,n,p", [(1, 1, 1), (3, 81, 65), (2, 130, 257),
                                   (2, 1024, 12289)])
def test_batched_kernel_matches_single_launches(S, n, p):
    a = _stacked_inputs(S + n + p, S, n, p)
    for gated in (True, False):
        _assert_batched_matches_singles(a, (0,) * 9, gated)


@pytest.mark.cuda
def test_batched_kernel_with_shared_inputs_and_a_dead_stream():
    """A map shared by every stream (not batched), the gate fields of the
    gates-off search shared too, and a stream whose queries are all
    invalid."""
    a = _stacked_inputs(7, 3, 200, 700)
    a[3][1] = False
    _assert_batched_matches_singles(
        a[:4] + [t[0] for t in a[4:]], (0,) * 4 + (None,) * 5, True)
    _assert_batched_matches_singles(
        a[:5] + [t[0] for t in a[5:8]] + a[8:],
        (0,) * 5 + (None,) * 3 + (0,), False)


def _stream_setup(S=2, n_frames=8):
    """S streams of the multistream phase's scenes at its configuration,
    their depth maps on the card and their frames."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs and the kernel")
    import chip_smoke
    cfg = chip_smoke.multistream_config()
    out = [chip_smoke._render_stream((100 + s, n_frames, chip_smoke.WIDTH,
                                      chip_smoke.HEIGHT, chip_smoke.FX))
           for s in range(S)]
    frames = np.stack([f for f, _ in out])
    maps = chip_smoke.stream_maps(cfg, frames, np.stack([d for _, d in out]))
    return cfg, maps, frames


@pytest.mark.cuda
def test_batched_steps_never_wait_for_the_device():
    """The vmapped tracking step and the keyframe steps (every stream with
    a free keyframe slot, and one without), eager, under torch's sync debug
    mode "error": no op waits for the device (the precondition of
    capturing them)."""
    from plslam_tpu_torch.mapstate import state as mstate
    from plslam_tpu_torch.parallel import multistream
    cfg, maps, frames = _stream_setup(n_frames=6)
    bt = multistream.BatchedTracker(cfg, 2, kf_interval=2,
                                    device=torch.device("cuda", 0),
                                    use_graphs=False)
    bt.bootstrap(mstate.stack(maps))
    step = bt._batched_step

    def no_sync(*args, **kwargs):
        torch.cuda.set_sync_debug_mode("error")
        try:
            return step(*args, **kwargs)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    bt._batched_step = no_sync
    bt._steps = {kind: partial(no_sync, with_kf=kind != "track")
                 for kind in ("track", "kf", "kf_masked")}
    for j in range(5):              # keyframe, track, keyframe, track, and
        if j == 4:                  # a keyframe with stream 1 counted full
            bt.n_kf_host[1] = cfg.max_kf - 1
        bt.step(frames[:, 1 + j])
    assert bt.ms.n_kf.tolist() == [4, 3]


@pytest.mark.cuda
def test_graphed_batched_step_matches_eager():
    """The graphed `BatchedTracker` against the eager one from the same
    maps over 7 frames (keyframe steps captured and replayed): poses,
    scalars and maps bit for bit."""
    import chip_smoke
    cfg, maps, frames = _stream_setup()
    runs = [chip_smoke.run_batched(cfg, maps, frames, 7, use_graphs=g)
            for g in (True, False)]
    np.testing.assert_array_equal(runs[0]["poses"], runs[1]["poses"])
    np.testing.assert_array_equal(runs[0]["scalars"], runs[1]["scalars"])
    for f in ("pt_xyz", "pt_found", "kf_pt_idx", "n_kf", "n_pt", "n_ln"):
        assert torch.equal(getattr(runs[0]["bt"].ms, f),
                           getattr(runs[1]["bt"].ms, f)), f
    assert (runs[0]["captures"], runs[0]["replays"]) == (2, 5)
    assert runs[0]["launches"] == runs[1]["launches"] == 3 * 7


@pytest.mark.cuda
def test_round_robin_captures_once_per_step_key():
    """`RoundRobinTracker`: every stream's chunk replays the System's one
    frame graph, through device-to-device copies of its map into the bound
    map, so nothing is captured after the first chunk, keyframe chunks
    included."""
    from plslam_tpu_torch.parallel import multistream
    cfg, maps, frames = _stream_setup(S=3, n_frames=9)
    rr = multistream.RoundRobinTracker(cfg, 3, kf_every_chunks=2,
                                       device=torch.device("cuda", 0))
    rr.bootstrap(maps)
    caps = []
    for c in range(4):
        rr.step_chunks([frames[s, 1 + 2 * c:3 + 2 * c] for s in range(3)])
        caps.append(rr.slam.graphs.captures)
    assert caps == [caps[0]] * 4 and caps[0] >= 1
    assert rr.slam.graphs.replays == 3 * 4 * 2 - caps[0]
    assert [st["n_kf"] for st in rr.streams] == [3, 3, 3]


def _mesh_ba(world, backend, device=None):
    """A small KITTI-like window (16 keyframes x 2048 landmarks) through
    `multichip.ba_rank` on `world` spawned ranks, and the one-process form
    in `world` ranges on card 0."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from plslam_tpu_torch.parallel import multichip, sharded_ba, streams
    K, P = 16, 2048
    out = streams.spawn(multichip.ba_rank, world, backend, device=device,
                        args=(K, P, 2, 3, 11, 1024), timeout=600)
    prob = sharded_ba.prepare_problem(multichip.kitti_like_problem(K, P),
                                      world)
    prob = prob._replace(**{k: v.cuda() for k, v in prob._asdict().items()
                            if torch.is_tensor(v)})
    return out, multichip.timed_bundle_adjust(None, prob, multichip.KITTI_CAM,
                                              2, 3, n_shards=world)


@pytest.mark.cuda
def test_nccl_world1_bundle_adjust_is_the_unsharded_solver():
    """One NCCL rank: the mesh BA bit for bit the one-process solver."""
    import chip_smoke
    (out,), one = _mesh_ba(1, "nccl")
    assert chip_smoke._ba_gaps("world 1", out, one, exact=True) == []


@pytest.mark.cuda
def test_gloo_world2_on_one_card():
    """Two gloo ranks sharing card 0: the one-process form's LM decisions,
    its cost within 1e-5 relative, poses within 1e-4, equal inlier
    verdicts; the replicated outputs equal across the ranks."""
    import chip_smoke
    out, one = _mesh_ba(2, "gloo", "cuda:0")
    assert chip_smoke._ba_gaps("world 2", out[0], one, exact=False) == []
    for k in ("kf_T", "pt_xyz", "obs_inlier", "H", "b"):
        assert np.array_equal(out[1][k], out[0][k]), k
    assert out[1]["cost"] == out[0]["cost"]

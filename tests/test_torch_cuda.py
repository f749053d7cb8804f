"""Tests of the port that need a CUDA device: the hand-written kernels have
no CPU mode, so these skip without one. They import neither jax nor
plslam_tpu, so they also run where only PyTorch is installed:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""
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
    """The System's tracking step and keyframe chain, at the smoke run's
    configuration with lines off and on (line detection too), and with
    lines on through `track_rgbd` and `track_stereo` (the keypoint depth,
    the stereo search, tracking on stereo edges, the depth chain), under
    torch's sync debug mode: any op that waits for the device raises. Runs
    until the first keyframe of the chain (monocular) or the second
    keyframe after the depth initialization."""
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
    slam = System(cfg, device=torch.device("cuda", 0))

    def no_sync(fn):
        def wrapper(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return wrapper

    for attr in ("_track_update", "_process_kf", "_detect_lines",
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
        device=torch.device("cuda", 0))

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

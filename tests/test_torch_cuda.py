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
@pytest.mark.parametrize("use_lines", [False, True])
def test_tracking_and_keyframe_chain_never_wait_for_the_device(use_lines):
    """The System's tracking step and keyframe chain, at the smoke run's
    configuration with lines off and on (line detection too), under
    torch's sync debug mode: any op that waits for the device raises. Runs
    until the first keyframe of the chain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    import dataclasses
    from chip_smoke import render_system_sequence, system_config
    from plslam_tpu_torch.models.system import System

    slam = System(dataclasses.replace(system_config(), use_lines=use_lines),
                  device=torch.device("cuda", 0))

    def no_sync(fn):
        def wrapper(*args, **kwargs):
            torch.cuda.set_sync_debug_mode("error")
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.set_sync_debug_mode("default")
        return wrapper

    slam._track_update = no_sync(slam._track_update)
    slam._process_kf = no_sync(slam._process_kf)
    slam._detect_lines = no_sync(slam._detect_lines)
    _, frames = render_system_sequence()
    for i, img in enumerate(frames):
        slam.track_monocular(img, i / 30.0)
        if slam.n_kf_host > 2:
            break
    assert slam.state == "OK" and slam.n_kf_host == 3
    assert bool(slam.ms.kf_ln_valid[:3].any()) == use_lines

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


# Edge shapes: a single pair, and sizes one past a block of queries and a
# chunk of points. chip_smoke.py checks the tracking step's own shapes.
@pytest.mark.cuda
@pytest.mark.parametrize("n,p", [(1, 1), (130, 257)])
def test_kernel_matches_plain_on_card(n, p):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    a = {k: torch.from_numpy(v).cuda() for k, v in
         random_search_inputs(np.random.default_rng(n + p), n, p).items()}
    for gated in (True, False):
        before = gated_match.gated_hamming_best2.launches
        got = gated_match.gated_hamming_best2(**a, gated=gated)
        assert gated_match.gated_hamming_best2.launches == before + 1
        want = gated_match.gated_hamming_best2_reference(**a, gated=gated)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype
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
    got = gated_match.gated_hamming_best2(**a)
    want = gated_match.gated_hamming_best2_reference(**a)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x.cpu().numpy(), y.cpu().numpy())


@pytest.mark.cuda
def test_tracking_and_keyframe_chain_never_wait_for_the_device():
    """The System's tracking step and keyframe chain, at the smoke run's
    configuration, under torch's sync debug mode: any op that waits for the
    device raises. Runs until the first keyframe of the chain."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    from chip_smoke import render_system_sequence, system_config
    from plslam_tpu_torch.models.system import System

    slam = System(system_config(), device=torch.device("cuda", 0))

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
    _, frames = render_system_sequence()
    for i, img in enumerate(frames):
        slam.track_monocular(img, i / 30.0)
        if slam.n_kf_host > 2:
            break
    assert slam.state == "OK" and slam.n_kf_host == 3

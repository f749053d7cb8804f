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

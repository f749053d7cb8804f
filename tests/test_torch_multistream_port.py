"""The port's `BatchedTracker` against itself, on the CPU, on the scenes and
maps of tests/test_torch_multistream.py (3 streams at 320x240, 4 lockstep
frames, the first a keyframe step).

Bars and why: the batched step against the same streams one at a time
(a tracker per stream): poses within 1e-5 and equal scalars (the pose
solve's [J | r] products sum in one order batched or not, so they are in
fact bit-equal). Identical streams: equal scalars and poses within 1e-5
(tests/test_multistream.py's bar). The batched K1 plain version under
vmap against the single plain version, stream by stream, with a map
shared by every stream too: exact. A stream without a free keyframe
slot keeps its map through a keyframe step (the JAX tracker's `lax.cond`):
bit-equal to its track-only step."""
import numpy as np
import pytest
import torch

from plslam_tpu_torch.mapstate import state as tstate
from plslam_tpu_torch.models import system as tsys
from plslam_tpu_torch.ops import gated_match
from plslam_tpu_torch.parallel import multistream as tms

from test_torch_multistream import (CFG, S, _run_port,  # noqa: F401
                                    vmap_setup, streams)
from torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def batched(streams):
    _, frames, maps = streams
    return _run_port(maps, frames)


def test_batched_step_matches_streams_one_at_a_time(streams, batched):
    _, frames, maps = streams
    _, Tp, sp = batched
    for s in range(S):
        _, T1, s1 = _run_port([maps[s]], [frames[s]])
        np.testing.assert_allclose(Tp[:, s], T1[:, 0], atol=1e-5)
        np.testing.assert_array_equal(sp[:, s], s1[:, 0])


def test_identical_streams_identical_trajectories(streams):
    _, frames, maps = streams
    _, T, sc = _run_port([maps[0]] * S, [frames[0]] * S)
    for s in range(1, S):
        np.testing.assert_array_equal(sc[:, s], sc[:, 0])
        np.testing.assert_allclose(T[:, s], T[:, 0], atol=1e-5)


def test_stream_without_a_free_keyframe_slot(streams):
    """Against the same two streams with room (stream 0) and their
    track-only step (stream 1), at the same batch size."""
    _, frames, maps = streams
    full = tstate.MapState(**{f: getattr(maps[1], f).clone()
                              for f in tstate.FIELDS})
    full.n_kf.fill_(CFG["max_kf"] - 1)
    bt, T, sc = _run_port([maps[0], full], frames[:2], n_steps=1)
    assert bt.n_kf_host.tolist() == [2, CFG["max_kf"] - 1]
    room, T0, s0 = _run_port(maps[:2], frames[:2], n_steps=1)
    track = tms.BatchedTracker(tsys.SLAMConfig(**CFG), 2, device="cpu")
    track.bootstrap(tstate.stack([maps[0], full]))
    track.frame_id = 0                    # its next step tracks frame 1 only
    T1, s1 = track.step(np.stack([f[1] for f in frames[:2]]))
    for f in tstate.FIELDS:
        assert torch.equal(getattr(bt.ms, f)[0], getattr(room.ms, f)[0]), f
        assert torch.equal(getattr(bt.ms, f)[1], getattr(track.ms, f)[1]), f
    assert np.array_equal(T[0, 0], T0[0, 0])
    assert np.array_equal(sc[0, 0], s0[0, 0])
    assert np.array_equal(T[0, 1], T1[1].numpy())
    assert np.array_equal(sc[0, 1], s1[1].numpy())


def test_batched_k1_plain_version_under_vmap():
    rng = np.random.default_rng(5)
    n, p = 50, 90

    def arr(shape, dtype, lo=0, hi=2):
        if dtype == np.bool_:
            return torch.from_numpy(rng.random(shape) < 0.85)
        if dtype == np.float32:
            return torch.from_numpy(rng.uniform(lo, hi, shape)
                                    .astype(np.float32))
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(dtype))
    a = [arr((S, n, 256), np.uint8), arr((S, n, 2), np.float32, 0, 60),
         arr((S, n), np.int32, 0, 3), arr((S, n), np.bool_),
         arr((S, p, 256), np.uint8), arr((S, p, 2), np.float32, 0, 60),
         arr((S, p), np.float32, 4, 25), arr((S, p), np.int32, 0, 3),
         arr((S, p), np.bool_)]
    a[0][1, :3] = a[4][1, :3]            # exact ties across points
    for gated in (True, False):
        out = torch.func.vmap(lambda *x: gated_match.gated_hamming_best2(
            *x, gated=gated))(*a)
        ref = gated_match.gated_hamming_best2_reference(*a, gated=gated)
        for s in range(S):
            one = gated_match.gated_hamming_best2_reference(
                *(t[s] for t in a), gated=gated)
            for k in range(3):
                assert torch.equal(out[k][s], one[k])
                assert torch.equal(ref[k][s], one[k])
        # a map shared by every stream (the map side not batched)
        shared = torch.func.vmap(
            lambda *x: gated_match.gated_hamming_best2(*x, *(t[0] for t in
                                                             a[4:]),
                                                       gated=gated))(*a[:4])
        for s in range(S):
            one = gated_match.gated_hamming_best2_reference(
                *(t[s] for t in a[:4]), *(t[0] for t in a[4:]), gated=gated)
            assert all(torch.equal(shared[k][s], one[k]) for k in range(3))

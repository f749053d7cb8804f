"""The port's `RoundRobinTracker` against the JAX package's, on the CPU, on
the scenes and maps of tests/test_torch_multistream.py: 2 streams x 2
chunks of B = 2 with `kf_every_chunks` = 2 (the second chunk makes a
keyframe). Bars: the batched tracker's (poses within 2e-4, the keyframe's
bindings >= 99% equal, the map counts equal), and the found counts within
one per frame and stream. Plus the bootstrap poses, which the JAX tracker
ignores (ROADMAP Queue 3)."""
import numpy as np
import jax.numpy as jnp
import torch

from plslam_tpu.models import system as jsys
from plslam_tpu.parallel import multistream as jms
from plslam_tpu_torch.models import system as tsys
from plslam_tpu_torch.parallel import multistream as tms

from test_torch_multistream import (CFG, _jax_map, vmap_setup,  # noqa: F401
                                    streams)
from torch_threads import one_thread  # noqa: F401


def test_round_robin_matches_jax(streams):
    _, frames, maps = streams
    B, n_chunks, n_streams = 2, 2, 2
    cfg = dict(CFG)
    port = tms.RoundRobinTracker(tsys.SLAMConfig(**cfg), n_streams,
                                 kf_every_chunks=2, device="cpu")
    port.bootstrap(maps[:n_streams])
    jt = jms.RoundRobinTracker(jsys.SLAMConfig(**cfg), n_streams,
                               kf_every_chunks=2)
    jt.bootstrap([_jax_map(m) for m in maps[:n_streams]])
    for c in range(n_chunks):
        chunk = [f[1 + B * c:1 + B * (c + 1)] for f in frames[:n_streams]]
        out_p = port.step_chunks(chunk)
        out_j = jt.step_chunks([jnp.asarray(x) for x in chunk])
        for tp, tj in zip(out_p, out_j):
            np.testing.assert_allclose(tp.numpy(), np.asarray(tj), atol=2e-4)
    for sp, sj in zip(port.streams, jt.streams):
        for name in ("n_kf", "n_pt", "n_ln"):
            assert int(getattr(sp["ms"], name)) == int(getattr(sj["ms"],
                                                               name))
        k = int(sp["ms"].n_kf) - 1
        rows_p = sp["ms"].kf_pt_idx[k].numpy()
        rows_j = np.asarray(sj["ms"].kf_pt_idx[k])
        assert (rows_p == rows_j).mean() >= 0.99
        found_p = sp["ms"].pt_found.numpy()
        found_j = np.asarray(sj["ms"].pt_found)
        assert np.abs(found_p - found_j).sum() <= 2 * n_chunks * B


def test_round_robin_bootstrap_poses(streams):
    """The port's `RoundRobinTracker.bootstrap` takes the streams' initial
    poses; the JAX package's ignores `T_list` and starts every stream at
    the identity (ROADMAP Queue 3)."""
    _, _, maps = streams
    T0 = np.eye(4, dtype=np.float32)
    T0[:3, 3] = [0.1, -0.2, 0.3]
    port = tms.RoundRobinTracker(tsys.SLAMConfig(**CFG), 2, device="cpu")
    port.bootstrap(maps[:2], [torch.from_numpy(T0)] * 2)
    jt = jms.RoundRobinTracker(jsys.SLAMConfig(**CFG), 2)
    jt.bootstrap([_jax_map(m) for m in maps[:2]], [jnp.asarray(T0)] * 2)
    for sp, sj in zip(port.streams, jt.streams):
        np.testing.assert_array_equal(sp["T"].numpy(), T0)
        np.testing.assert_array_equal(np.asarray(sj["T"]), np.eye(4))

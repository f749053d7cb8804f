"""The port's mesh forms of the sharded solvers, on gloo ranks on the CPU.

At world 2 and 4 (spawned processes, one torch thread each, importing no
jax: tests/torch_mesh_ranks.py), each rank runs:
- the mesh `sharded_pose_normal_equations` on tests/test_parallel.py's 256
  edges: against the JAX package's on its 8-device virtual mesh within
  1e-4 x the largest entry (another float32 summation order, the JAX
  file's own bar), and against the port's one-process form in W ranges:
  bit-equal at W = 2 (a two-term sum is exact in either order), within
  1e-5 x the largest entry at W = 4;
- `sharded_ba.sharded_bundle_adjust` on tests/test_torch_sharded_ba.py's
  window (4 cameras, 120 points, 10 lines, the two oldest cameras fixed):
  against JAX's `bundle_adjust` at that file's bars, and (slow tier:
  XLA's compile of it takes ~80 s) against JAX's `sharded_bundle_adjust`
  on its mesh at the same bars;
  against the one-process form in W ranges: bit-equal at W = 2, and at
  W = 4 the same 15 LM decisions, the cost within 1e-5 relative, the poses
  within 1e-4 and equal inlier verdicts;
- every replicated output (poses, cost, decisions, H, b) bit-equal across
  the ranks."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plslam_tpu.geometry import camera as jcam
from plslam_tpu.optim import local_ba as jba
from plslam_tpu.parallel import sharded_ba as jsba, streams as jstreams
from plslam_tpu_torch.optim import local_ba as tba
from plslam_tpu_torch.parallel import multichip, sharded_ba, streams

from test_sharded_ba import _window
from test_torch_sharded_ba import JCAM, JCAM_BA, _agree, _torch_problem
import torch_mesh_ranks as ranks
from torch_threads import one_thread  # noqa: F401

WORLDS = (2, 4)


@pytest.fixture(scope="module")
def window():
    """tests/test_torch_sharded_ba.py's window: (JAX problem, port problem,
    true poses)."""
    prob, Ts, _ = _window(K=4, P=120, L=10)
    prob = prob._replace(kf_T=prob.kf_T.at[1].set(jnp.asarray(Ts[1])),
                         kf_fixed=jnp.asarray([True, True, False, False]))
    return prob, _torch_problem(prob), Ts


@pytest.fixture(scope="module")
def edges():
    """tests/test_parallel.py's edges (T the identity)."""
    rng = np.random.default_rng(0)
    E = 256
    xyz = np.stack([rng.uniform(-1, 1, E), rng.uniform(-1, 1, E),
                    rng.uniform(3, 6, E)], -1).astype(np.float32)
    uv = np.asarray(jcam.project(JCAM, jnp.asarray(xyz)))
    uv = (uv + rng.normal(0, 1, uv.shape)).astype(np.float32)
    return np.eye(4, dtype=np.float32), xyz, uv, np.ones(E, np.float32)


@pytest.fixture(scope="module")
def jax_pose(edges):
    """JAX's pose system on its 8-device mesh."""
    T, xyz, uv, w = (jnp.asarray(x) for x in edges)
    H, b = jstreams.sharded_pose_normal_equations(
        jstreams.make_mesh(8, axis="edge"), JCAM, T, xyz, uv, w)
    return np.asarray(H), np.asarray(b)


def _jax_result(prob, res):
    """A JAX result as numpy, its landmark axes cut to the window's."""
    res = jax.tree_util.tree_map(np.asarray, res)
    P, L = prob.pt_mask.shape[0], prob.ln_mask.shape[0]
    return res._replace(pt_xyz=res.pt_xyz[:P], ln_xyz=res.ln_xyz[:L],
                        obs_inlier=res.obs_inlier[:, :P],
                        ln_obs_inlier=res.ln_obs_inlier[:, :L])


@pytest.fixture(scope="module", params=WORLDS, ids=lambda w: f"world{w}")
def run(request, window, edges):
    """(W, every rank's output, the one-process form in W ranges)."""
    W = request.param
    tp = window[1]
    prob = {k: v.numpy() if torch.is_tensor(v) else v
            for k, v in tp._asdict().items()}
    out = streams.spawn(ranks.ba_and_edges, W, "gloo", device="cpu",
                        threads=1, args=(prob, edges), timeout=300)
    sp = sharded_ba.prepare_problem(tp, W)
    one = multichip.timed_bundle_adjust(None, sp, ranks.CAM_BA, 5, 10,
                                        n_shards=W)
    T, *e = (torch.from_numpy(x) for x in edges)
    H, b = streams.sharded_pose_normal_equations(ranks.CAM, T, *e, W)
    one.update(H=H.numpy(), b=b.numpy())
    return W, out, one


def _result(o, K, P):
    """A rank's numpy BA output as a port `BAResult`."""
    return tba.BAResult(
        torch.from_numpy(o["kf_T"]), torch.from_numpy(o["pt_xyz"]),
        torch.from_numpy(o["ln_xyz"]),
        torch.from_numpy(np.unpackbits(o["obs_inlier"])[:K * P]
                         .reshape(K, P).astype(bool)),
        torch.from_numpy(o["ln_obs_inlier"]), torch.tensor(o["cost"]))


def test_mesh_pose_system(run, jax_pose):
    W, out, one = run
    H_j, b_j = jax_pose
    H, b = out[0]["H"], out[0]["b"]
    np.testing.assert_allclose(H, H_j, atol=1e-4 * np.abs(H_j).max())
    np.testing.assert_allclose(b, b_j, atol=1e-4 * (np.abs(b_j).max()
                                                    + 1e-6))
    if W == 2:
        assert np.array_equal(H, one["H"]) and np.array_equal(b, one["b"])
    else:
        np.testing.assert_allclose(H, one["H"], rtol=0,
                                   atol=1e-5 * np.abs(one["H"]).max())
        np.testing.assert_allclose(b, one["b"], rtol=0,
                                   atol=1e-5 * np.abs(one["b"]).max())


@pytest.mark.slow
def test_mesh_bundle_adjust_matches_jax_mesh(run, window):
    """Against JAX's `sharded_bundle_adjust` on its 8-device mesh (slow:
    XLA compiles that program in ~80 s on one CPU core)."""
    W, out, _ = run
    prob, _, Ts_true = window
    ref = jsba.sharded_bundle_adjust(jstreams.make_mesh(8, axis="lm"),
                                     jsba.prepare_problem(prob, 8), JCAM_BA)
    K, P = out[0]["kf_T"].shape[0], out[0]["pt_xyz"].shape[0]
    _agree(prob, _result(out[0], K, P), _jax_result(prob, ref), Ts_true)


def test_mesh_bundle_adjust_matches_jax(run, window):
    """Against JAX's single-device `bundle_adjust`, which
    tests/test_sharded_ba.py holds its sharded one to, at the same bars."""
    W, out, _ = run
    prob, _, Ts_true = window
    K, P = out[0]["kf_T"].shape[0], out[0]["pt_xyz"].shape[0]
    _agree(prob, _result(out[0], K, P),
           _jax_result(prob, jba.bundle_adjust(prob, JCAM_BA)), Ts_true)


def test_mesh_bundle_adjust_matches_one_process(run):
    W, out, one = run
    o = out[0]
    assert o["accepted"] == one["accepted"]               # the same LM decisions
    if W == 2:
        for k in ("kf_T", "pt_xyz", "ln_xyz", "obs_inlier", "ln_obs_inlier"):
            assert np.array_equal(o[k], one[k]), k
        assert o["cost"] == one["cost"]
        return
    assert abs(o["cost"] - one["cost"]) <= 1e-5 * abs(one["cost"])
    np.testing.assert_allclose(o["kf_T"], one["kf_T"], rtol=0, atol=1e-4)
    assert np.array_equal(o["obs_inlier"], one["obs_inlier"])
    assert np.array_equal(o["ln_obs_inlier"], one["ln_obs_inlier"])


def test_replicated_outputs_equal_across_ranks(run):
    W, out, _ = run
    assert len(out) == W
    for o in out[1:]:
        for k in ("kf_T", "H", "b", "pt_xyz", "obs_inlier"):
            assert np.array_equal(o[k], out[0][k]), k
        assert o["cost"] == out[0]["cost"] and o["accepted"] == out[0]["accepted"]

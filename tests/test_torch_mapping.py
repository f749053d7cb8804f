"""Parity of the PyTorch port's keyframe chain against plslam_tpu, on maps
the JAX `System` built: the sequence is the system slice's
(`make_scene(seed=1)`, orbit) at 640x480 with 512 features, 3 levels, 16
keyframes x 4096 points, 256 line slots and a 5 x 1024 BA window, lines on;
the JAX `System` runs until its second keyframe chain, whose input map and
output are recorded.

Tolerances: integer outputs exact (`covis_rows`, `observers_of_points`,
`project_and_bind` and `search_in_neighbors` bindings, duplicate fusion,
row dedup, culls); `create_new_points` exact in its bindings and counts,
points within 5e-4 relative (the float32 DLT of keyframe pairs some ten
baselines deep carries ~1e-4 in both packages, see test_torch_geometry);
`process_keyframe`: every point and line binding of the JAX package's
result is the port's, and the port's extra point bindings, each one a write the JAX package's
`.at[].set(where(a, new, old))` scatters lose (pinned below, ROADMAP
Queue 3), are at most 3% of the bound slots, so >= 97% of them agree;
created points within 1%, created lines equal, poses within 1e-3. The
line functions' own parity is in tests/test_torch_lines.py; here the
reference's duplicate-index writes on the line path are pinned on tiny
maps (ROADMAP Queue 3)."""
from functools import partial

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plslam_tpu.datasets import synthetic as jsyn
from plslam_tpu.mapstate import state as jstate
from plslam_tpu.models import mapping as jmap
from plslam_tpu.models.system import SLAMConfig, System
from plslam_tpu.ops.extract import PointFeatures as JFeats
from plslam_tpu_torch.geometry import camera as tcam
from plslam_tpu_torch.mapstate import checkpoint as tckpt, state as tstate
from plslam_tpu_torch.models import mapping as tmap
from plslam_tpu_torch.ops import extract as text, lines as tlines
from torch_threads import one_thread  # noqa: F401

CFG = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, n_features=512,
           n_levels=3, max_kf=16, max_pt=4096, ba_window=5, ba_points=1024,
           use_lines=True, use_loop_closing=False, grow_map=False)
TCAM = tcam.Camera.create(500.0, 500.0, 320.0, 240.0)


def _np_map(ms):
    return {k: np.array(v) for k, v in ms._asdict().items()}


def _jax_map(arrays):
    return jstate.MapState(**{k: jnp.asarray(v) for k, v in arrays.items()})


def _port(arrays):
    return tckpt.from_numpy(arrays, "cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def run():
    """The JAX System over the sequence until its second keyframe chain;
    returns (system, [(map before, arguments, map after), ...])."""
    slam = System(SLAMConfig(**CFG))
    calls, chain = [], slam._process_kf[False]

    def record(ms, feats, lfeats, T, matched_pt, matched_ln, frame_id,
               kp_depth, do_kf_cull):
        before = _np_map(ms)
        out = chain(ms, feats, lfeats, T, matched_pt, matched_ln, frame_id,
                    kp_depth, do_kf_cull=do_kf_cull)
        calls.append((before, dict(
            feats={k: np.array(getattr(feats, k)) for k in feats._fields},
            lfeats={k: np.array(getattr(lfeats, k)) for k in lfeats._fields},
            T=np.array(T), matched_pt=np.array(matched_pt),
            matched_ln=np.array(matched_ln),
            frame_id=int(frame_id), do_kf_cull=bool(do_kf_cull)),
            _np_map(out)))
        return out
    slam._process_kf[False] = record
    scene = jsyn.make_scene(seed=1)
    for i, T in enumerate(jsyn.trajectory(60, "orbit")):
        slam.track_monocular(jsyn.render(scene, T), i / 30.0)
        if len(calls) == 2:
            break
    assert len(calls) == 2, "the JAX System made fewer than 4 keyframes"
    return slam, calls


def _lines(args):
    return tlines.LineFeatures(**{k: _t(v) for k, v in args["lfeats"].items()})


def _process_port(before, args, sf, s2, tri_covis=True):
    ms = _port(before)
    feats = text.PointFeatures(**{k: _t(v) for k, v in args["feats"].items()})
    tmap.process_keyframe(
        TCAM, ms, feats, _lines(args), _t(args["T"]), _t(args["matched_pt"]),
        _t(args["matched_ln"]), args["frame_id"], None, s2, sf, window=5, p_ba=1024, l_ba=256,
        max_depth=40.0, do_kf_cull=args["do_kf_cull"], use_depth=False,
        tri_covis=tri_covis, tri_covis_k=3, sin_covis=True, sin_reverse_n=2)
    return ms


def _scales():
    sf, s2 = text.scale_factors(text.ExtractorConfig(n_features=512,
                                                     n_levels=3))
    return sf, s2


@pytest.mark.parametrize("call", [0, 1])
def test_process_keyframe_matches_jax(run, call):
    """The whole chain on the JAX System's own input maps: keyframe 2 (no
    keyframe cull) and keyframe 3 (with the cull)."""
    _, calls = run
    before, args, after = calls[call]
    ms = _process_port(before, args, *_scales())
    idx_t, idx_j = ms.kf_pt_idx.numpy(), after["kf_pt_idx"]
    bound = (idx_t >= 0) | (idx_j >= 0)
    np.testing.assert_array_equal(idx_t[idx_j >= 0], idx_j[idx_j >= 0])
    extra = (idx_t != idx_j).sum()
    n_new_t = int(ms.n_pt) - int(before["n_pt"])
    n_new_j = int(after["n_pt"]) - int(before["n_pt"])
    print(f"call {call}: {extra} extra port bindings of {bound.sum()}; "
          f"new points port {n_new_t} jax {n_new_j}")
    assert extra <= 0.03 * bound.sum() and bound.sum() > 300
    assert abs(n_new_t - n_new_j) <= 0.01 * n_new_j and n_new_j > 20
    assert int(ms.n_kf) == int(after["n_kf"]) == call + 3
    # lines: every JAX binding, the same lines created
    ln_t, ln_j = ms.kf_ln_idx.numpy(), after["kf_ln_idx"]
    np.testing.assert_array_equal(ln_t[ln_j >= 0], ln_j[ln_j >= 0])
    assert int(ms.n_ln) == int(after["n_ln"])
    np.testing.assert_array_equal(ms.ln_valid.numpy(), after["ln_valid"])
    print(f"call {call}: {(ln_j >= 0).sum()} line bindings, "
          f"{int(after['n_ln'])} lines")
    np.testing.assert_array_equal(ms.kf_valid.numpy(), after["kf_valid"])
    np.testing.assert_allclose(ms.kf_T.numpy(), after["kf_T"], atol=1e-3)
    assert abs(int(ms.pt_valid.sum()) - int(after["pt_valid"].sum())) \
        <= 0.01 * int(after["pt_valid"].sum())


def test_process_keyframe_masks_equal_skipping(run):
    """With the fixed {8, 4, 2}-back ladder (`tri_covis=False`), the chain
    masks the creation of partners that do not exist instead of skipping
    them; the map must come out bit for bit as the chain that skips them in
    Python. (Against the JAX package this path differs by more than the
    lost writes themselves: on keyframe 3 the reference loses 14 of 33
    reference-keyframe bindings of its first triangulation, and the
    neighbour search then binds other points into the freed keypoints.)"""
    _, calls = run
    before, args, _ = calls[1]
    sf, s2 = _scales()
    got = _process_port(before, args, sf, s2, tri_covis=False)
    ms = _port(before)
    k_new = int(before["n_kf"])
    tmap.insert_keyframe(TCAM, ms, text.PointFeatures(**{
        k: _t(v) for k, v in args["feats"].items()}), _t(args["T"]),
        _t(args["matched_pt"]), args["frame_id"], sf, lfeats=_lines(args),
        matched_ln=_t(args["matched_ln"]))
    for back in (8, 4, 2, 1):
        if k_new >= back:
            tmap.create_new_points(TCAM, ms, k_new, k_new - back, s2, sf)
    for back in (1, 2, 3):
        if k_new >= back + 1:
            tmap.create_new_lines(TCAM, ms, k_new, k_new - back,
                                  k_third=k_new - back - 1)
        elif k_new >= back:
            tmap.create_new_lines(TCAM, ms, k_new, k_new - back)
    tmap.fuse_duplicate_lines(ms)
    tmap.fuse_duplicate_points(ms)
    tmap.search_in_neighbors(TCAM, ms, k_new, covis_targets=True)
    tmap.dedup_kf_point_rows(TCAM, ms)
    ms.pt_n_obs.copy_(tstate.observers_of_points(ms).sum(0, dtype=torch.int32))
    tmap.run_local_ba(TCAM, ms, s2, window=5, p_ba=1024, l_ba=256, iters_a=4,
                      iters_b=8)
    tmap.cull_points(ms, k_new)
    if args["do_kf_cull"]:
        tmap.cull_keyframes(ms, k_new)
    for name in tstate.FIELDS:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      getattr(ms, name).numpy(), name)


def test_covisibility_and_observers_match_jax(run):
    _, calls = run
    after = calls[1][2]
    ms_j, ms_t = _jax_map(after), _port(after)
    K = after["kf_T"].shape[0]
    ks = np.arange(K, dtype=np.int32)
    np.testing.assert_array_equal(
        tstate.covis_rows(ms_t, _t(ks)).numpy(),
        np.asarray(jstate.covis_rows(ms_j, jnp.asarray(ks))))
    np.testing.assert_array_equal(tstate._primary_obs(ms_t).numpy(),
                                  np.asarray(jstate._primary_obs(ms_j)))
    inc = tstate.observers_of_points(ms_t).numpy()
    np.testing.assert_array_equal(inc,
                                  np.asarray(jstate.observers_of_points(ms_j)))
    assert np.asarray(jstate.covis_rows(ms_j, jnp.asarray(ks))).max() >= 30


def _inserted(run, call=1, triangulated=False):
    """The recorded pre-chain map with the new keyframe inserted by the JAX
    package (and, with `triangulated`, its points against the previous
    keyframe created), plus k_new."""
    slam, calls = run
    before, args, _ = calls[call]
    f = args["feats"]
    k_new = int(before["n_kf"])
    ms_j = jmap.insert_keyframe(slam.cam, _jax_map(before), JFeats(**{
        k: jnp.asarray(v) for k, v in f.items()}), jnp.asarray(args["T"]),
        jnp.asarray(args["matched_pt"]), jnp.int32(args["frame_id"]),
        slam.scale_factors)
    if triangulated:
        ms_j = jmap.create_new_points(slam.cam, ms_j, k_new, k_new - 1,
                                      slam.sigma2, slam.scale_factors)
    return _np_map(ms_j), k_new


def test_insert_keyframe_desc_majority_matches_jax(run):
    """The bitwise-majority representative descriptor (`desc_majority`) on
    the points the new keyframe observes a third time or more."""
    slam, calls = run
    before, args, _ = calls[1]
    f = args["feats"]
    ms_j = jmap.insert_keyframe(slam.cam, _jax_map(before), JFeats(**{
        k: jnp.asarray(v) for k, v in f.items()}), jnp.asarray(args["T"]),
        jnp.asarray(args["matched_pt"]), jnp.int32(args["frame_id"]),
        slam.scale_factors, desc_majority=True)
    ms_t = tmap.insert_keyframe(
        TCAM, _port(before), text.PointFeatures(**{
            k: _t(v) for k, v in f.items()}), _t(args["T"]),
        _t(args["matched_pt"]), args["frame_id"], _scales()[0],
        desc_majority=True)
    for name in ("pt_desc", "pt_desc_acc", "pt_desc_cnt", "pt_n_obs"):
        np.testing.assert_array_equal(getattr(ms_t, name).numpy(),
                                      np.asarray(getattr(ms_j, name)), name)
    m = args["matched_pt"]
    assert (np.asarray(ms_j.pt_desc_cnt)[m[m >= 0]] >= 3).sum() > 10


def test_create_new_points_matches_jax(run):
    slam, _ = run
    arrays, k_new = _inserted(run)
    sf, s2 = _scales()
    for k_ref in (k_new - 1, k_new - 2):
        ms_j = jmap.create_new_points(slam.cam, _jax_map(arrays), k_new, k_ref,
                                      slam.sigma2, slam.scale_factors)
        ms_t = tmap.create_new_points(TCAM, _port(arrays), k_new, k_ref, s2, sf)
        n0, n1 = int(arrays["n_pt"]), int(ms_j.n_pt)
        assert int(ms_t.n_pt) == n1 > n0 + 20
        np.testing.assert_array_equal(ms_t.kf_pt_idx[k_new].numpy(),
                                      np.asarray(ms_j.kf_pt_idx)[k_new])
        # the reference row: every JAX binding is the port's; the port may
        # hold more (test_create_new_points_keeps_colliding_bindings)
        ref_t = ms_t.kf_pt_idx[k_ref].numpy()
        ref_j = np.asarray(ms_j.kf_pt_idx)[k_ref]
        np.testing.assert_array_equal(ref_t[ref_j >= 0], ref_j[ref_j >= 0])
        new = ms_t.kf_pt_idx[k_new].numpy()
        assert (ref_t >= n0).sum() == (new >= n0).sum() == n1 - n0
        sl = slice(n0, n1)
        for name in ("pt_valid", "pt_first_kf", "pt_n_obs", "pt_desc",
                     "pt_desc_acc", "pt_desc_cnt", "pt_visible", "pt_found"):
            np.testing.assert_array_equal(getattr(ms_t, name).numpy()[sl],
                                          np.asarray(getattr(ms_j, name))[sl],
                                          name)
        for name in ("pt_xyz", "pt_normal", "pt_min_dist", "pt_max_dist"):
            a, b = getattr(ms_t, name).numpy()[sl], np.asarray(
                getattr(ms_j, name))[sl]
            assert (np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max() < 5e-4, name


def test_create_new_points_disabled_changes_nothing(run):
    arrays, k_new = _inserted(run)
    sf, s2 = _scales()
    ms = tmap.create_new_points(TCAM, _port(arrays), k_new, k_new - 1, s2, sf,
                                enabled=torch.tensor(False))
    for name in tstate.FIELDS:
        np.testing.assert_array_equal(getattr(ms, name).numpy(), arrays[name],
                                      name)


@pytest.mark.parametrize("target", ["new", "older"])
def test_project_and_bind_matches_jax(run, target):
    """The neighbourhood's points into the new keyframe, and the points
    just triangulated into an older one (the two directions of
    SearchInNeighbors)."""
    slam, calls = run
    arrays, k_new = _inserted(run, triangulated=True)
    n0 = int(calls[1][0]["n_pt"])
    if target == "new":
        kf, cand = k_new, np.asarray(arrays["pt_valid"])
    else:
        kf, cand = k_new - 2, np.arange(arrays["pt_valid"].shape[0]) >= n0
    ms_j = jmap.project_and_bind(slam.cam, _jax_map(arrays), jnp.int32(kf),
                                 jnp.asarray(cand))
    ms_t = tmap.project_and_bind(TCAM, _port(arrays), kf, _t(cand))
    np.testing.assert_array_equal(ms_t.kf_pt_idx.numpy(),
                                  np.asarray(ms_j.kf_pt_idx))
    np.testing.assert_array_equal(ms_t.pt_n_obs.numpy(),
                                  np.asarray(ms_j.pt_n_obs))
    if target == "older":
        assert (ms_t.kf_pt_idx[kf].numpy()
                != arrays["kf_pt_idx"][kf]).sum() > 0


@pytest.mark.parametrize("covis_targets,whole_map", [(True, False),
                                                     (False, False),
                                                     (True, True)])
def test_search_in_neighbors_matches_jax(run, covis_targets, whole_map):
    slam, _ = run
    arrays, k_new = _inserted(run, triangulated=True)
    ms_j = jmap.search_in_neighbors(slam.cam, _jax_map(arrays),
                                    jnp.int32(k_new), covis_targets,
                                    whole_map)
    ms_t = tmap.search_in_neighbors(TCAM, _port(arrays), k_new, covis_targets,
                                    whole_map)
    np.testing.assert_array_equal(ms_t.kf_pt_idx.numpy(),
                                  np.asarray(ms_j.kf_pt_idx))
    np.testing.assert_array_equal(ms_t.pt_n_obs.numpy(),
                                  np.asarray(ms_j.pt_n_obs))
    assert (ms_t.kf_pt_idx.numpy() != arrays["kf_pt_idx"]).sum() > 0


def test_fuse_and_dedup_match_jax(run):
    """Recent points duplicated (same descriptor, 1 cm away) are fused into
    the older ones, and the keyframe rows that then bind one point twice
    keep the better-reprojecting keypoint."""
    slam, calls = run
    arrays = dict(calls[1][2])
    n_pt = int(arrays["n_pt"])
    rng = np.random.default_rng(0)
    idx = arrays["kf_pt_idx"] = arrays["kf_pt_idx"].copy()
    seen = np.zeros(arrays["pt_valid"].shape, bool)
    seen[idx[idx >= 0]] = True
    src = rng.choice(np.nonzero(arrays["pt_valid"] & seen)[0], 40,
                     replace=False)
    dst = n_pt + np.arange(40)
    for name in ("pt_xyz", "pt_desc", "pt_valid", "pt_normal", "pt_min_dist",
                 "pt_max_dist", "pt_first_kf"):
        arrays[name] = arrays[name].copy()
        arrays[name][dst] = arrays[name][src]
    arrays["pt_xyz"][dst] += 0.01
    arrays["n_pt"] = np.int32(n_pt + 40)
    # bind each copy in place of a free keypoint of a keyframe that already
    # observes its source point: a same-point pair after fusion
    for s, d in zip(src, dst):
        k = np.nonzero((idx == s).any(1))[0][0]
        idx[k, np.nonzero(idx[k] < 0)[0][0]] = d
    ms_j = jmap.fuse_duplicate_points(_jax_map(arrays), n_recent=256)
    ms_t = tmap.fuse_duplicate_points(_port(arrays), n_recent=256)
    for name in ("kf_pt_idx", "pt_valid", "pt_n_obs"):
        np.testing.assert_array_equal(getattr(ms_t, name).numpy(),
                                      np.asarray(getattr(ms_j, name)), name)
    assert not ms_t.pt_valid[dst].any()
    ms_j = jmap.dedup_kf_point_rows(slam.cam, ms_j)
    ms_t = tmap.dedup_kf_point_rows(TCAM, ms_t)
    np.testing.assert_array_equal(ms_t.kf_pt_idx.numpy(),
                                  np.asarray(ms_j.kf_pt_idx))
    rows = ms_t.kf_pt_idx.numpy()
    assert all(len(set(r[r >= 0])) == (r >= 0).sum() for r in rows)


@pytest.mark.parametrize("enabled", [True, False])
def test_culls_match_jax(run, enabled):
    """Point culling, then keyframe culling on a map where keyframe 1's
    points are all seen by 3 other keyframes (so it is redundant)."""
    _, calls = run
    arrays = dict(calls[1][2])
    k_now = int(arrays["n_kf"]) - 1
    ms_j = jmap.cull_points(_jax_map(arrays), jnp.int32(k_now))
    ms_t = tmap.cull_points(_port(arrays), k_now)
    for name in ("pt_valid", "kf_pt_idx", "ln_valid", "kf_ln_idx"):
        np.testing.assert_array_equal(getattr(ms_t, name).numpy(),
                                      np.asarray(getattr(ms_j, name)), name)
    arrays = _np_map(ms_j)
    idx = arrays["kf_pt_idx"] = arrays["kf_pt_idx"].copy()
    kv = arrays["kf_kp_valid"] = arrays["kf_kp_valid"].copy()
    for k in (0, 2, 3):
        idx[k], kv[k] = idx[1], kv[1]
    arrays["kf_octave"] = np.broadcast_to(arrays["kf_octave"][1],
                                          arrays["kf_octave"].shape).copy()
    ms_j = _jax_map(arrays)
    if enabled:
        ms_j = jmap.cull_keyframes(ms_j, jnp.int32(k_now + 3))
    ms_t = tmap.cull_keyframes(_port(arrays), k_now + 3,
                               enabled=torch.tensor(enabled))
    for name in ("kf_valid", "kf_pt_idx", "kf_ln_idx", "pt_n_obs"):
        np.testing.assert_array_equal(getattr(ms_t, name).numpy(),
                                      np.asarray(getattr(ms_j, name)), name)
    assert bool(ms_t.kf_valid[1]) != enabled


def _pair(X, desc0, desc1, max_pt=8):
    """A map of two keyframes 0.3 m apart, each with one keypoint per point
    of X (n, 3) at its exact projection, unbound."""
    from plslam_tpu.geometry import se3 as jse3
    n = X.shape[0]
    arrays = _np_map(jstate.allocate(jstate.MapConfig(
        max_kf=2, max_pt=max_pt, max_ln=2, n_kp=n, n_lf=2, n_levels=3)))
    T1 = np.asarray(jse3.se3_exp(jnp.asarray([0, 0, 0, -0.3, 0, 0.0],
                                             jnp.float32)))
    for k, T in enumerate((np.eye(4, dtype=np.float32), T1)):
        Xc = X @ T[:3, :3].T + T[:3, 3]
        arrays["kf_T"][k] = T
        arrays["kf_uv"][k] = Xc[:, :2] / Xc[:, 2:] * 500.0 + [320.0, 240.0]
    arrays["kf_desc"][0], arrays["kf_desc"][1] = desc0, desc1
    arrays["kf_kp_valid"][:] = True
    arrays["kf_valid"][:] = True
    arrays["n_kf"] = np.int32(2)
    return arrays


S2 = np.array([1.0, 1.44, 2.0736], np.float32)
SF = np.array([1.0, 1.2, 1.44], np.float32)


def _create_both(arrays):
    from plslam_tpu.geometry import camera as jcam
    jc = jcam.Camera.create(500.0, 500.0, 320.0, 240.0)
    ms_j = jmap.create_new_points(jc, _jax_map(arrays), 1, 0,
                                  jnp.asarray(S2), jnp.asarray(SF))
    ms_t = tmap.create_new_points(TCAM, _port(arrays), 1, 0, _t(S2), _t(SF))
    return ms_j, ms_t


def test_create_new_points_at_capacity_keeps_the_last_slot():
    """Fault in the reference, pinned (the same as create_points_from_depth's
    in tests/test_torch_tracking.py): 6 points triangulate but 3 slots are
    left; the JAX package's `.at[slots].set(where(a, new, old))` lets every
    dropped lane (sent to slot P-1 by `append_slots`) write slot P-1's stale
    values, so the point created there stays invalid. The port writes the
    accepted lanes only. Every other field and slot agrees."""
    rng = np.random.default_rng(1)
    X = np.stack([rng.uniform(-1, 1, 6), rng.uniform(-0.7, 0.7, 6),
                  rng.uniform(2.5, 3.5, 6)], -1).astype(np.float32)
    desc = rng.integers(0, 2, (6, 256)).astype(np.uint8)
    arrays = _pair(X, desc, desc)
    arrays["n_pt"] = np.int32(5)
    ms_j, ms_t = _create_both(arrays)
    assert int(ms_t.n_pt) == int(ms_j.n_pt) == 8
    np.testing.assert_array_equal(ms_t.kf_pt_idx.numpy()[:, :4],
                                  [[5, 6, 7, -1]] * 2)
    assert ms_t.pt_valid[5:].all()
    assert not bool(np.asarray(ms_j.pt_valid)[7])       # the reference's loss
    np.testing.assert_allclose(ms_t.pt_xyz[7].numpy(), X[2], atol=1e-3)
    for name in tstate.FIELDS:
        a, b = getattr(ms_t, name).numpy(), np.asarray(getattr(ms_j, name))
        if a.ndim and a.shape[0] == 8:
            a, b = a[:7], b[:7]
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)


def test_create_new_points_keeps_colliding_bindings():
    """Fault in the reference, pinned: `create_new_points` binds the new
    points in the reference keyframe with `.at[idx2].set(where(a, pid,
    old))`. A lane that was not accepted but whose best match is the same
    keypoint as an accepted lane's writes the old -1 back over the binding
    when it comes later (XLA's CPU scatter keeps the last write), so the
    point is created with 2 observations but bound only in the new
    keyframe. The port writes the accepted lanes only. Inputs: two
    keyframes of 3 keypoints; lanes 0 and 2 of keyframe 1 both match
    keypoint 0 of keyframe 0 best, lane 0 is accepted, lane 2 fails the
    Hamming bound."""
    X = np.array([[0.2, 0.1, 3.0], [-0.5, 0.3, 4.0], [0.21, 0.1, 3.0]],
                 np.float32)
    base = np.random.default_rng(0).integers(0, 2, (3, 256)).astype(np.uint8)
    desc1 = base.copy()
    desc1[1] = 1 - base[1]                 # lane 1 matches nothing
    desc1[2] = base[0]
    desc1[2, :60] = 1 - desc1[2, :60]      # lane 2: best is kp 0, too far
    arrays = _pair(X, base, desc1)
    arrays["kf_uv"][0, 2] = arrays["kf_uv"][0, 1]   # kp 2 of kf 0: elsewhere
    ms_j, ms_t = _create_both(arrays)
    assert int(ms_t.n_pt) == int(ms_j.n_pt) == 1
    np.testing.assert_array_equal(ms_t.kf_pt_idx[1].numpy(), [0, -1, -1])
    np.testing.assert_array_equal(np.asarray(ms_j.kf_pt_idx)[1], [0, -1, -1])
    assert ms_t.kf_pt_idx[0, 0] == 0                   # the port binds it
    assert np.asarray(ms_j.kf_pt_idx)[0, 0] == -1      # the reference lost it


# --- the reference's duplicate-index writes on the line path (Queue 3) ---

def _line_pair(A, B, desc0, desc1, max_ln=16, max_pt=8):
    """A map of two keyframes 0.3 m apart observing the 3-D segments
    (A, B) (n, 3) each, exactly projected, one per line slot, unbound."""
    from plslam_tpu.geometry import se3 as jse3
    n = A.shape[0]
    arrays = _np_map(jstate.allocate(jstate.MapConfig(
        max_kf=2, max_pt=max_pt, max_ln=max_ln, n_kp=4, n_lf=n,
        n_levels=3)))
    T1 = np.asarray(jse3.se3_exp(jnp.asarray([0, 0, 0, -0.3, 0, 0.0],
                                             jnp.float32)))
    for k, T in enumerate((np.eye(4, dtype=np.float32), T1)):
        uv = [(X @ T[:3, :3].T + T[:3, 3]) for X in (A, B)]
        uv = [Xc[:, :2] / Xc[:, 2:] * 500.0 + [320.0, 240.0] for Xc in uv]
        arrays["kf_T"][k] = T
        arrays["kf_ln_uv"][k] = np.stack(uv, 1)
        l = np.cross(np.c_[uv[0], np.ones(n)], np.c_[uv[1], np.ones(n)])
        arrays["kf_ln_l2d"][k] = l / np.linalg.norm(l[:, :2], axis=-1,
                                                    keepdims=True)
    arrays["kf_ln_desc"][0], arrays["kf_ln_desc"][1] = desc0, desc1
    arrays["kf_ln_valid"][:] = True
    arrays["kf_valid"][:] = True
    arrays["n_kf"] = np.int32(2)
    return arrays


def _segments(n, seed=1, length=1.0):
    rng = np.random.default_rng(seed)
    A = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                  rng.uniform(3, 4, n)], -1)
    d = rng.normal(0, 1, (n, 3)) * [1, 1, 0.2]
    B = A + length * d / np.linalg.norm(d, axis=-1, keepdims=True)
    return A.astype(np.float32), B.astype(np.float32)


def _create_lines_both(arrays):
    from plslam_tpu.geometry import camera as jcam
    jc = jcam.Camera.create(500.0, 500.0, 320.0, 240.0)
    ms_j = jax.jit(partial(jmap.create_new_lines, jc))(
        _jax_map(arrays), jnp.int32(1), jnp.int32(0))
    return ms_j, tmap.create_new_lines(TCAM, _port(arrays), 1, 0)


def test_create_new_lines_at_capacity_keeps_the_last_slot():
    """Fault in the reference, pinned: 6 lines triangulate but 3 slots are
    left; `append_slots` sends the dropped lanes to slot L-1 and the JAX
    package's `.at[slots].set(where(a, new, old))` lets them write slot
    L-1's stale values after the line created there, which stays invalid
    at the origin. The port writes the accepted lanes only; every other
    field and slot agrees."""
    A, B = _segments(6)
    desc = np.random.default_rng(2).integers(0, 2, (6, 256)).astype(np.uint8)
    arrays = _line_pair(A, B, desc, desc, max_ln=8)
    arrays["n_ln"] = np.int32(5)
    ms_j, ms_t = _create_lines_both(arrays)
    assert int(ms_t.n_ln) == int(ms_j.n_ln) == 8
    np.testing.assert_array_equal(ms_t.kf_ln_idx.numpy()[:, :4],
                                  [[5, 6, 7, -1]] * 2)
    assert ms_t.ln_valid[5:].all()
    assert not bool(np.asarray(ms_j.ln_valid)[7])        # the reference's loss
    np.testing.assert_allclose(ms_t.ln_xyz[7].numpy(), np.stack([A[2], B[2]]),
                               atol=1e-3)
    for name in tstate.FIELDS:
        a, b = getattr(ms_t, name).numpy(), np.asarray(getattr(ms_j, name))
        if a.ndim and a.shape[0] == 8 and name.startswith("ln_"):
            a, b = a[:7], b[:7]
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5, err_msg=name)


def test_create_new_lines_keeps_colliding_bindings():
    """Fault in the reference, pinned: the new line's binding in the
    reference keyframe, `.at[idx2].set(where(a, lid, old))`, is written
    back to -1 by a later lane that was not accepted but whose best match
    is the same segment (XLA's CPU scatter keeps the last write). Inputs:
    segment 2 of keyframe 1 is segment 0 shifted 2 cm, with segment 0's
    descriptor 60 bits away (past the Hamming bound 50), so lanes 0 and 2
    both best-match segment 0 of keyframe 0 and lane 0 alone is accepted."""
    A, B = _segments(3, seed=4)
    A[2], B[2] = A[0] + 0.02, B[0] + 0.02
    base = np.random.default_rng(0).integers(0, 2, (3, 256)).astype(np.uint8)
    desc1 = base.copy()
    desc1[1] = 1 - base[1]                   # lane 1 matches nothing
    desc1[2] = base[0]
    desc1[2, :60] = 1 - desc1[2, :60]
    arrays = _line_pair(A, B, base, desc1)
    arrays["kf_ln_valid"][0, 2] = False      # keyframe 0's segment 2: absent
    ms_j, ms_t = _create_lines_both(arrays)
    assert int(ms_t.n_ln) == int(ms_j.n_ln) == 1
    np.testing.assert_array_equal(ms_t.kf_ln_idx[1].numpy(), [0, -1, -1])
    np.testing.assert_array_equal(np.asarray(ms_j.kf_ln_idx)[1], [0, -1, -1])
    assert ms_t.kf_ln_idx[0, 0] == 0                    # the port binds it
    assert np.asarray(ms_j.kf_ln_idx)[0, 0] == -1       # the reference lost it


@pytest.mark.parametrize("all_valid", [True, False])
def test_create_new_lines_scene_depth_is_nan_below_capacity(all_valid):
    """Kept as in the reference (Queue 3): the extent gate compares against
    the median distance of the map's points over all slots, NaN where a slot
    is invalid, and a NaN median becomes 1.0. So with the points 100 m away
    the 4 m segments pass only when every point slot is valid; with one
    invalid slot the scene depth is 1.0 and 4 m > 3 x 1.0 rejects them."""
    A, B = _segments(4, seed=6, length=4.0)
    desc = np.random.default_rng(3).integers(0, 2, (4, 256)).astype(np.uint8)
    arrays = _line_pair(A, B, desc, desc)
    arrays["pt_xyz"][:] = [0.0, 0.0, 100.0]
    arrays["pt_valid"][:] = True
    arrays["pt_valid"][-1] = all_valid
    ms_j, ms_t = _create_lines_both(arrays)
    assert int(ms_t.n_ln) == int(ms_j.n_ln) == (4 if all_valid else 0)
    np.testing.assert_array_equal(ms_t.kf_ln_idx.numpy(),
                                  np.asarray(ms_j.kf_ln_idx))


def test_insert_keyframe_keeps_line_zero_descriptor_update():
    """Fault in the reference, pinned: `insert_keyframe` writes the bound
    lines' descriptors with `.at[lid].set(where(has, desc, old))`, and the
    unbound lanes, clipped to line 0, write line 0's old descriptor after
    the lane that bound it. The port writes the bound lanes only. Every
    other field agrees."""
    from plslam_tpu.ops.lines import LineFeatures as JLines
    A, B = _segments(4)
    rng = np.random.default_rng(7)
    old = rng.integers(0, 2, (4, 256)).astype(np.uint8)
    arrays = _line_pair(A, B, old, old)
    arrays["ln_desc"][:4] = old
    arrays["ln_valid"][:4] = True
    arrays["n_ln"] = np.int32(4)
    arrays["n_kf"] = np.int32(1)
    new = rng.integers(0, 2, (4, 256)).astype(np.uint8)
    uv = arrays["kf_ln_uv"][1]
    lf = dict(uv_a=uv[:, 0], uv_b=uv[:, 1], l2d=arrays["kf_ln_l2d"][1],
              angle=np.zeros(4, np.float32), length=np.full(4, 50, np.float32),
              response=np.zeros(4, np.float32), desc=new,
              valid=np.ones(4, bool))
    matched_ln = np.array([0, -1, 2, -1], np.int32)
    feats = {k: np.zeros(s, dt) for k, s, dt in (
        ("uv", (4, 2), np.float32), ("uv_un", (4, 2), np.float32),
        ("response", 4, np.float32), ("octave", 4, np.int32),
        ("angle", 4, np.float32), ("desc", (4, 256), np.uint8),
        ("valid", 4, bool))}
    T = arrays["kf_T"][1]
    ms_j = jmap.insert_keyframe(
        None, _jax_map(arrays), JFeats(**{k: jnp.asarray(v) for k, v in
                                          feats.items()}),
        jnp.asarray(T), jnp.full((4,), -1, jnp.int32), jnp.int32(1),
        jnp.ones(3), lfeats=JLines(**{k: jnp.asarray(v) for k, v in
                                      lf.items()}),
        matched_ln=jnp.asarray(matched_ln))
    ms_t = tmap.insert_keyframe(
        TCAM, _port(arrays), text.PointFeatures(**{k: _t(v) for k, v in
                                                   feats.items()}),
        _t(T), torch.full((4,), -1, dtype=torch.int32), 1, _t(np.ones(3)),
        lfeats=tlines.LineFeatures(**{k: _t(v) for k, v in lf.items()}),
        matched_ln=_t(matched_ln))
    np.testing.assert_array_equal(ms_t.ln_desc.numpy()[[0, 2]], new[[0, 2]])
    np.testing.assert_array_equal(np.asarray(ms_j.ln_desc)[0], old[0])
    np.testing.assert_array_equal(np.asarray(ms_j.ln_desc)[2], new[2])
    for name in tstate.FIELDS:
        a, b = getattr(ms_t, name).numpy(), np.asarray(getattr(ms_j, name))
        if name == "ln_desc":
            a, b = a[1:], b[1:]
        np.testing.assert_array_equal(a, b, name)


def test_ba_select_keeps_line_slot_zero_observations():
    """Fault in the reference, pinned (the line form of
    tests/test_torch_local_ba.py's slot-0 case): `ba_select` scatters the
    observed lines into the BA grid with `.at[slot].set(where(has, l2d,
    old))`, and every lane without a BA slot writes slot 0's placeholder
    [1, 0, -1e9] after the real observer of BA slot 0 (the newest observed
    line). The port keeps the observation; the rest of the problem
    agrees."""
    A, B = _segments(6)
    desc = np.zeros((6, 256), np.uint8)
    arrays = _line_pair(A, B, desc, desc)
    arrays["ln_valid"][:6] = True
    arrays["n_ln"] = np.int32(6)
    arrays["kf_ln_idx"][0] = [5, -1, 3, -1, 1, -1]
    arrays["kf_ln_idx"][1] = [4, 5, -1, 2, -1, 0]
    s2 = np.array([1.0, 1.44, 2.0736], np.float32)
    sel_j = jmap.ba_select(_jax_map(arrays), jnp.asarray(s2), window=2,
                           p_ba=8, l_ba=8)
    sel_t = tmap.ba_select(_port(arrays), _t(s2), window=2, p_ba=8, l_ba=8)
    l2d_t = sel_t.prob.ln_obs_l2d.numpy()
    l2d_j = np.asarray(sel_j.prob.ln_obs_l2d)
    # line 5 is BA slot 0: keyframe 0 sees it in lane 0 (unbound lanes
    # follow), keyframe 1 in lane 1 (an unbound lane follows)
    for k, lane in ((0, 0), (1, 1)):
        np.testing.assert_array_equal(l2d_t[k, 0], arrays["kf_ln_l2d"][k, lane])
        np.testing.assert_array_equal(l2d_j[k, 0], [1.0, 0.0, -1e9])
    np.testing.assert_array_equal(l2d_t[:, 1:], l2d_j[:, 1:])
    np.testing.assert_array_equal(sel_t.prob.ln_obs_mask.numpy(),
                                  np.asarray(sel_j.prob.ln_obs_mask))
    np.testing.assert_array_equal(sel_t.lsel.numpy(), np.asarray(sel_j.lsel))


def test_fuse_duplicate_lines_below_n_recent_matches_jax():
    """With fewer line slots (16) than `n_recent` (256) the recent ids
    repeat the last slot; every repeat writes what the first wrote, so the
    reference and the port agree exactly."""
    A, B = _segments(8)
    desc = np.random.default_rng(8).integers(0, 2, (8, 256)).astype(np.uint8)
    arrays = _line_pair(A, B, desc, desc)
    arrays["ln_xyz"][:8] = np.stack([A, B], 1)
    arrays["ln_xyz"][8:16] = np.stack([A, B], 1) + 0.01
    arrays["ln_desc"][:8] = arrays["ln_desc"][8:16] = desc
    arrays["ln_valid"][:16] = True
    arrays["ln_cond"][:8] = 0.5
    arrays["n_ln"] = np.int32(16)
    arrays["kf_ln_idx"][0] = np.arange(8)
    arrays["kf_ln_idx"][1] = np.arange(8, 16)
    ms_j = jax.jit(jmap.fuse_duplicate_lines)(_jax_map(arrays))
    ms_t = tmap.fuse_duplicate_lines(_port(arrays))
    for name in ("kf_ln_idx", "ln_valid", "ln_n_obs", "ln_cond"):
        np.testing.assert_array_equal(getattr(ms_t, name).numpy(),
                                      np.asarray(getattr(ms_j, name)), name)
    np.testing.assert_array_equal(ms_t.kf_ln_idx[1].numpy(), np.arange(8))
    assert not ms_t.ln_valid[8:].any()

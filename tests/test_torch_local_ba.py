"""Parity of the PyTorch port's local bundle adjustment against plslam_tpu:
`bundle_adjust` on one synthetic window with point and line landmarks, and
`ba_select` / `run_local_ba` / `ba_writeback` on a synthetic map.

Tolerances: BA slot assignments (`sel`, `slot_safe`, `has`, the observation
grids) exact; poses and landmarks after the 5 + 10 (or 4 + 8) LM iterations
within 1e-4 relative (float32 Schur products summed in another order);
observation inlier verdicts equal in >= 99% of cells."""
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from plslam_tpu.geometry import camera as jcam, se3 as jse3
from plslam_tpu.mapstate import state as jstate
from plslam_tpu.models import mapping as jmap
from plslam_tpu.optim import local_ba as jba
from plslam_tpu_torch.geometry import camera as tcam
from plslam_tpu_torch.mapstate import checkpoint as tckpt
from plslam_tpu_torch.models import mapping as tmap
from plslam_tpu_torch.optim import local_ba as tba
from torch_threads import one_thread  # noqa: F401

FX, W, H = 500.0, 640, 480
JCAM = jcam.Camera.create(FX, FX, W / 2, H / 2, width=W, height=H)
TCAM = tcam.Camera.create(FX, FX, W / 2, H / 2, width=W, height=H)
SIGMA2 = (1.2 ** (2 * np.arange(3))).astype(np.float32)


def _t(x):
    return torch.from_numpy(np.array(x))


def _poses(n, rng):
    xi = np.zeros((n, 6), np.float32)
    xi[:, 3] = -0.15 * np.arange(n)                     # sideways baseline
    xi[:, :3] = rng.normal(0, 0.01, (n, 3))
    return np.asarray(jse3.se3_exp(jnp.asarray(xi)))


def _project(T, X):
    Xc = np.einsum("...ij,...j->...i", T[..., :3, :3], X) + T[..., :3, 3]
    return Xc[..., :2] / Xc[..., 2:] * FX + [W / 2, H / 2], Xc[..., 2]


def _perturb(T, rng, s):
    return np.asarray(jse3.se3_exp(jnp.asarray(
        rng.normal(0, s, 6).astype(np.float32))) @ jnp.asarray(T))


def _pinned(new, old):
    a, d = new[:, 0], new[:, 1] - new[:, 0]
    d = d / np.maximum(np.linalg.norm(d, axis=-1, keepdims=True), 1e-9)
    return np.stack([a + np.sum((old[:, e] - a) * d, -1)[:, None] * d
                     for e in (0, 1)], 1)


def _rel(a, b):
    return float((np.abs(a - b) / np.maximum(np.abs(b), 1.0)).max())


@pytest.fixture(scope="module")
def window():
    """A 5-camera window (first two fixed), 300 points and 6 lines, noisy
    observations with 5% gross outliers, perturbed starting values."""
    rng = np.random.default_rng(0)
    K, P, L = 5, 300, 6
    T_gt = _poses(K, rng)
    X = np.stack([rng.uniform(-2, 2, P), rng.uniform(-1.5, 1.5, P),
                  rng.uniform(3, 6, P)], -1).astype(np.float32)
    uv, z = _project(T_gt[:, None], X[None])
    uv = uv + rng.normal(0, 0.5, uv.shape)
    out = rng.random((K, P)) < 0.05
    uv[out] += rng.uniform(-30, 30, (int(out.sum()), 2))
    mask = (rng.random((K, P)) < 0.8) & (z > 0)
    ln = np.stack([X[:L] + [0, -0.3, 0], X[:L] + [0, 0.3, 0.1]], 1)
    l2d = []
    for T in T_gt:
        a, _ = _project(T, ln[:, 0])
        b, _ = _project(T, ln[:, 1])
        l = np.cross(np.c_[a, np.ones(L)], np.c_[b, np.ones(L)])
        l2d.append(l / np.linalg.norm(l[:, :2], axis=-1, keepdims=True))
    T0 = np.stack([T if k < 2 else _perturb(T, rng, 0.01)
                   for k, T in enumerate(T_gt)])
    arrays = dict(
        kf_T=T0.astype(np.float32), kf_fixed=np.arange(K) < 2,
        kf_mask=np.ones(K, bool),
        pt_xyz=(X + rng.normal(0, 0.03, X.shape)).astype(np.float32),
        pt_mask=np.ones(P, bool), obs_uv=uv.astype(np.float32),
        obs_mask=mask,
        obs_sigma2=SIGMA2[rng.integers(0, 3, (K, P))],
        ln_xyz=(ln + rng.normal(0, 0.02, ln.shape)).astype(np.float32),
        ln_mask=np.ones(L, bool), ln_obs_l2d=np.stack(l2d).astype(np.float32),
        ln_obs_mask=rng.random((K, L)) < 0.9)
    return arrays, np.full(L, 0.5, np.float32)


def test_bundle_adjust_matches_jax(window):
    arrays, info = window
    pj = jba.BAProblem(**{k: jnp.asarray(v) for k, v in arrays.items()},
                       ln_info=jnp.asarray(info))
    pt = tba.BAProblem(**{k: _t(v) for k, v in arrays.items()},
                       ln_info=_t(info))
    rj = jax.jit(lambda p: jba.bundle_adjust(p, JCAM))(pj)
    rt = tba.bundle_adjust(pt, TCAM)
    assert _rel(rt.kf_T.numpy(), np.asarray(rj.kf_T)) < 1e-4
    assert _rel(rt.pt_xyz.numpy(), np.asarray(rj.pt_xyz)) < 1e-4
    # an endpoint's place along its line is an exact null direction of the
    # endpoint-to-line residual, so compare the endpoints as the map stores
    # them: re-pinned next to their old positions (ba_writeback)
    old = arrays["ln_xyz"]
    assert _rel(_pinned(rt.ln_xyz.numpy(), old),
                _pinned(np.asarray(rj.ln_xyz), old)) < 1e-4
    inl_t, inl_j = rt.obs_inlier.numpy(), np.asarray(rj.obs_inlier)
    assert (inl_t == inl_j).mean() >= 0.99
    assert (rt.ln_obs_inlier.numpy() == np.asarray(rj.ln_obs_inlier)
            ).mean() >= 0.99
    np.testing.assert_allclose(float(rt.cost), float(rj.cost), rtol=1e-4)
    # the outliers were found and the fixed cameras did not move
    assert inl_j[arrays["obs_mask"]].mean() > 0.9
    np.testing.assert_array_equal(rt.kf_T.numpy()[:2], arrays["kf_T"][:2])


def test_bundle_adjust_records_its_decisions(window):
    """`BAResult.accepted` holds one bit per LM iteration, the first
    iteration's highest: the steps that lowered lambda when the schedule
    runs one iteration at a time."""
    arrays, info = window
    pt = tba.BAProblem(**{k: _t(v) for k, v in arrays.items()},
                       ln_info=_t(info))
    res = tba.bundle_adjust(pt, TCAM, iters_a=5, iters_b=10)
    st, bits = tba.ba_init(pt, TCAM), ""
    for phase, n in enumerate((5, 10)):
        if phase:
            st = tba.ba_demote(pt, TCAM, st)
        for _ in range(n):
            lam = float(st.lam)
            st = tba.ba_rounds(pt, TCAM, st, 1)
            bits += "1" if float(st.lam) < lam else "0"
    assert format(int(res.accepted), "015b") == bits
    assert torch.equal(res.kf_T, st.kf_T)


def _map(all_bound: bool):
    """A JAX map of 6 keyframes (capacity 8) over 80 points (capacity 128),
    each keyframe binding 48 of its 64 keypoints, or all 64 with
    `all_bound`, to points it sees, at noisy pixels: most points are seen
    by 4 or more keyframes, so the window is well conditioned."""
    rng = np.random.default_rng(1)
    Kc, n_kf, N, Pc, n_pt = 8, 6, 64, 128, 80
    T_gt = _poses(n_kf, rng)
    X = np.stack([rng.uniform(-1.5, 1.5, n_pt), rng.uniform(-1, 1, n_pt),
                  rng.uniform(3, 5, n_pt)], -1).astype(np.float32)
    ms = jstate.allocate(jstate.MapConfig(max_kf=Kc, max_pt=Pc, max_ln=16,
                                          n_kp=N, n_lf=8, n_levels=3))
    kf_T = np.tile(np.eye(4, dtype=np.float32), (Kc, 1, 1))
    kf_uv = np.zeros((Kc, N, 2), np.float32)
    kf_idx = np.full((Kc, N), -1, np.int32)
    for k in range(n_kf):
        kf_T[k] = T_gt[k] if k < 2 else _perturb(T_gt[k], rng, 0.005)
        ids = rng.choice(n_pt, N if all_bound else 48, replace=False)
        lanes = rng.permutation(N)[:len(ids)]
        kf_idx[k, lanes] = ids
        uv, _ = _project(T_gt[k], X[ids])
        kf_uv[k, lanes] = uv + rng.normal(0, 0.5, uv.shape)
    pt_xyz = np.zeros((Pc, 3), np.float32)
    pt_xyz[:n_pt] = X + rng.normal(0, 0.01, X.shape)
    ms = ms._replace(
        kf_T=jnp.asarray(kf_T), kf_uv=jnp.asarray(kf_uv),
        kf_pt_idx=jnp.asarray(kf_idx),
        kf_valid=jnp.asarray(np.arange(Kc) < n_kf),
        kf_kp_valid=jnp.ones((Kc, N), bool),
        kf_octave=jnp.asarray(rng.integers(0, 3, (Kc, N)).astype(np.int32)),
        pt_xyz=jnp.asarray(pt_xyz),
        pt_valid=jnp.asarray(np.arange(Pc) < n_pt), n_kf=jnp.int32(n_kf),
        n_pt=jnp.int32(n_pt))
    return ms


def _port(ms_j):
    return tckpt.from_numpy({k: np.array(v) for k, v in ms_j._asdict().items()},
                            "cpu")


@pytest.mark.parametrize("p_ba", [60, 128])
def test_ba_select_slots_match_jax(p_ba):
    """Slots and observation grids; with p_ba=60 the budget binds and the
    newest points win. Column 0 of the grids is compared where no unbound
    or unselected lane targets it (see
    test_ba_select_keeps_slot_zero_observations)."""
    ms_j = _map(all_bound=True)
    sj = jmap.ba_select(ms_j, jnp.asarray(SIGMA2), window=5, p_ba=p_ba,
                        l_ba=8)
    st = tmap.ba_select(_port(ms_j), _t(SIGMA2), window=5, p_ba=p_ba, l_ba=8)
    clean = ~(~np.asarray(sj.has) & np.asarray(sj.kf_mask)[:, None]).any(1)
    for name in ("ids_c", "kf_mask", "sel", "sel_ok", "slot_safe", "has",
                 "lsel", "lsel_ok", "win_pt_idx"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(sj, name)), name)
    for name in ("kf_fixed", "kf_mask", "obs_mask", "pt_xyz", "pt_mask",
                 "kf_T", "ln_obs_l2d", "ln_obs_mask"):
        np.testing.assert_array_equal(getattr(st.prob, name).numpy(),
                                      np.asarray(getattr(sj.prob, name)), name)
    for name in ("obs_uv", "obs_sigma2"):
        a, b = getattr(st.prob, name).numpy(), np.asarray(getattr(sj.prob, name))
        np.testing.assert_array_equal(a[:, 1:], b[:, 1:], name)
        np.testing.assert_array_equal(a[clean, 0], b[clean, 0], name)
    assert clean.any() == (p_ba == 128)


def test_run_local_ba_matches_jax():
    ms_j = _map(all_bound=True)
    out_j = jax.jit(lambda m: jmap.run_local_ba(
        JCAM, m, jnp.asarray(SIGMA2), window=5, p_ba=128, l_ba=8))(ms_j)
    out_t = tmap.run_local_ba(TCAM, _port(ms_j), _t(SIGMA2), window=5,
                              p_ba=128, l_ba=8)
    assert _rel(out_t.kf_T.numpy(), np.asarray(out_j.kf_T)) < 1e-4
    assert _rel(out_t.pt_xyz.numpy(), np.asarray(out_j.pt_xyz)) < 1e-4
    assert (out_t.kf_pt_idx.numpy() == np.asarray(out_j.kf_pt_idx)
            ).mean() >= 0.99
    np.testing.assert_array_equal(
        out_t.pt_n_obs.numpy(),
        (np.asarray(jstate.observers_of_points(out_j._replace(
            kf_pt_idx=jnp.asarray(out_t.kf_pt_idx.numpy())))).sum(0)))
    # the window's oldest camera (slot 1 of the map) stays fixed
    np.testing.assert_array_equal(out_t.kf_T.numpy()[1],
                                  np.asarray(ms_j.kf_T)[1])


@pytest.mark.parametrize("all_bound,p_ba", [(False, 128), (True, 60)])
def test_ba_select_keeps_slot_zero_observations(all_bound, p_ba):
    """Fault in the reference, pinned: the JAX package scatters the
    observation grids with `.at[slot].set(where(has, new, old))`, and every
    keypoint without a BA slot (unbound, or bound to a point the budget
    left out) has slot 0, so such a lane after the real observer of BA slot
    0 writes the stale (0, 0) pixel over it (XLA's CPU scatter keeps the
    last write). The port writes the observing lanes only."""
    ms_j = _map(all_bound=all_bound)
    sj = jmap.ba_select(ms_j, jnp.asarray(SIGMA2), window=5, p_ba=p_ba,
                        l_ba=8)
    st = tmap.ba_select(_port(ms_j), _t(SIGMA2), window=5, p_ba=p_ba, l_ba=8)
    np.testing.assert_array_equal(st.slot_safe.numpy(),
                                  np.asarray(sj.slot_safe))
    uv_t, uv_j = st.prob.obs_uv.numpy(), np.asarray(sj.prob.obs_uv)
    has, slot = np.asarray(sj.has), np.asarray(sj.slot_safe)
    kf_uv = np.asarray(ms_j.kf_uv)[np.asarray(sj.ids_c)]
    lost = 0
    for w in range(has.shape[0]):
        for n in np.nonzero(has[w])[0]:
            np.testing.assert_array_equal(uv_t[w, slot[w, n]], kf_uv[w, n])
            lost += int(slot[w, n] == 0 and (uv_j[w, 0] == 0).all())
    assert lost >= 1          # the reference lost slot 0's observation
    other = np.ones(uv_t.shape[:2], bool)
    other[:, 0] = False
    np.testing.assert_array_equal(uv_t[other], uv_j[other])


def test_ba_select_keeps_slot_zero_stereo_columns():
    """Fault in the reference, pinned: the stereo grid `obs_ur` is scattered
    as the other grids (`.at[slot].set(where(has, u_r, old))`,
    `plslam_tpu/models/mapping.py:594-597`), so a keypoint without a BA slot
    after the real observer of BA slot 0 writes the -1 it read back over
    slot 0's right column, and slot 0's stereo edge becomes a monocular one.
    The port writes the observing lanes only. Map of `_map(all_bound=False)`
    with every keypoint's u_r = u - bf / 4."""
    ms_j = _map(all_bound=False)
    bf = 40.0
    ms_j = ms_j._replace(kf_ur=jnp.where(ms_j.kf_valid[:, None],
                                         ms_j.kf_uv[..., 0] - bf / 4.0, -1.0))
    sj = jmap.ba_select(ms_j, jnp.asarray(SIGMA2), window=5, p_ba=128,
                        l_ba=8, use_stereo=True, bf=bf)
    st = tmap.ba_select(_port(ms_j), _t(SIGMA2), window=5, p_ba=128, l_ba=8,
                        use_stereo=True, bf=bf)
    assert sj.prob.bf == st.prob.bf == bf
    ur_t, ur_j = st.prob.obs_ur.numpy(), np.asarray(sj.prob.obs_ur)
    has, slot = np.asarray(sj.has), np.asarray(sj.slot_safe)
    kf_ur = np.asarray(ms_j.kf_ur)[np.asarray(sj.ids_c)]
    lost = []
    for w in range(has.shape[0]):
        for n in np.nonzero(has[w])[0]:
            assert ur_t[w, slot[w, n]] == kf_ur[w, n]
            if slot[w, n] == 0 and ur_j[w, 0] == -1.0:
                lost.append((w, float(kf_ur[w, n])))
    print(f"window rows whose slot-0 u_r the reference lost (row, u_r): "
          f"{lost}")
    assert lost               # the reference set them to -1: mono edges
    np.testing.assert_array_equal(ur_t[:, 1:], ur_j[:, 1:])
    np.testing.assert_array_equal(ur_t[~np.asarray(sj.prob.obs_mask)], -1.0)
    mono = tmap.ba_select(_port(ms_j), _t(SIGMA2), window=5, p_ba=128, l_ba=8)
    assert mono.prob.obs_ur is None

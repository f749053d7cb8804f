"""The multi-card program set over a mesh of ranks, and its lockstep curve.

Port of `__graft_entry__.dryrun_multichip` and of scripts/scaling_curve.py.
`dryrun_multichip(n)` spawns n ranks (`parallel/mesh.py`) and runs the four
parts of the JAX dry run on them: (1) one batched tracking step with the
stream axis sharded over the ranks, (2) the keyframe chain (insert ->
triangulate -> fuse -> local BA -> cull) vmapped over each rank's streams,
(3) the landmark-sharded global BA (`parallel/sharded_ba.py`, the camera
system all-reduced once per LM iteration) and (4) the edge-sharded pose
system. `scaling_curve(ranks)` runs `BatchedTracker(mesh=)` over 16 streams
at 1, 2, 4 ... ranks and prints each world's lockstep step time and
aggregate frames/s. Ranks that share a card (gloo) time-slice it, so that
curve shows the mechanics, not a speed-up; NCCL runs one rank per card.

    python -m plslam_tpu_torch.parallel.multichip --world N \\
        [--backend nccl|gloo]
    python -m plslam_tpu_torch.parallel.multichip --ranks 1 2 4 \\
        --backend gloo [--steps 8]

`kitti_like_problem` makes the KITTI 00-scale global-BA window of
tests/test_sharded_ba_scale.py in numpy; `ba_rank` and `lockstep_rank` are
the rank functions that chip_smoke.py's multi-card phase spawns, and
`lockstep` is the lockstep loop that `lockstep_rank` runs on a rank's
share and chip_smoke.py on one process's `BatchedTracker`.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
import time

import numpy as np
import torch

from ..entry import _build, random_point_map
from ..geometry import camera, se3
from ..mapstate import state as mstate
from ..models import mapping, tracking
from ..ops import extract, gated_match
from ..optim import local_ba
from . import sharded_ba, streams
from .mesh import spawn
from .multistream import BatchedTracker


def _t(x, device, dtype=None):
    return torch.as_tensor(np.asarray(x), dtype=dtype, device=device)


def _dryrun_rank(mesh):
    """The four parts of the dry run on this rank; returns what every rank
    holds replicated (poses, H, b, cost, keyframe chain counts) and the
    rank's K1 launches (the count set to 0 just before its first)."""
    dev, S = mesh.device, mesh.world        # one stream per rank
    cam, ext_cfg, map_cfg, sf, s2 = _build(dev, n_feats=128, n_levels=2,
                                           max_pt=256, h=96, w=128)
    rng = np.random.default_rng(0)
    ms_b = mstate.stack([random_point_map(map_cfg, rng, "cpu")
                         for _ in range(S)])
    imgs = torch.from_numpy(rng.uniform(0, 255, (S, 96, 128))
                            .astype(np.float32))
    T_preds = torch.eye(4).expand(S, 4, 4)
    extractor = extract.PointExtractor(ext_cfg, 96, 128).to(dev)
    gated_match.gated_hamming_best2.launches = 0

    def one(img, ms1, T_pred):
        f = extractor(img)
        f = f._replace(uv_un=camera.undistort_pixels(cam, f.uv))
        r = tracking.track_local_map(
            cam, ms1, f, T_pred, scale_factors=sf, sigma2_levels=s2,
            n_levels=ext_cfg.n_levels, scale=ext_cfg.scale)
        return r.T, r.n_inliers
    Ts, n_inl = torch.func.vmap(one)(*streams.shard_streams(
        mesh, (imgs, ms_b, T_preds)))
    Ts, n_inl = (streams.gather_streams(mesh, x) for x in (Ts, n_inl))
    if Ts.shape != (S, 4, 4):
        raise RuntimeError(f"batched step poses {tuple(Ts.shape)}")

    # the edge-sharded pose system, all-reduced, against one process
    E = 64 * S
    xyz = rng.uniform(-2, 2, (E, 3)).astype(np.float32)
    xyz[:, 2] = rng.uniform(3, 8, E)
    uv = rng.uniform(0, 100, (E, 2)).astype(np.float32)
    edges = [_t(a, dev) for a in (xyz, uv, np.ones(E, np.float32))]
    eye = torch.eye(4, device=dev)
    H, b = streams.sharded_pose_normal_equations(
        streams.make_mesh(axis="edge", device=dev), cam, eye, *edges)
    H1, b1 = streams.sharded_pose_normal_equations(cam, eye, *edges, S)
    if H.shape != (6, 6) or b.shape != (6,):
        raise RuntimeError(f"edge system {tuple(H.shape)} {tuple(b.shape)}")
    for x, y in ((H, H1), (b, b1)):
        if not torch.allclose(x, y, rtol=0, atol=1e-5 * float(
                y.abs().max()) + 1e-12):
            raise RuntimeError("the all-reduced edge system differs from "
                               "one process's")

    n_kf, n_pt, n_bound = _dryrun_keyframe_chain(mesh, cam, map_cfg, S)
    cost, kf_T = _dryrun_sharded_gba(mesh, cam, rng)
    return dict(T=Ts.cpu().numpy(), n_inliers=n_inl.cpu().numpy(),
                H=H.cpu().numpy(), b=b.cpu().numpy(), n_kf=n_kf, n_pt=n_pt,
                n_bound=n_bound, cost=cost, kf_T=kf_T,
                launches=gated_match.gated_hamming_best2.launches)


def _dryrun_keyframe_chain(mesh, cam, map_cfg, S):
    """The keyframe chain vmapped over the rank's streams: each a
    consistent two-keyframe map and a third view's features, half of them
    bound to map points (insertion, BA) and half not (triangulation).
    Returns every stream's keyframe and point counts after it."""
    dev = mesh.device
    N = map_cfg.n_kp
    n_bound = N // 2

    def project(T, X):
        Xc = (T[:3, :3] @ X.T).T + T[:3, 3]
        return np.stack([cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx,
                         cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy], -1)

    def make_state(s):
        r = np.random.default_rng(100 + s)
        X = np.stack([r.uniform(-1.5, 1.5, N), r.uniform(-1.0, 1.0, N),
                      r.uniform(2.5, 5.0, N)], -1).astype(np.float32)
        desc = (r.random((N, 256)) < 0.5).astype(np.uint8)
        Ts = [np.eye(4, dtype=np.float32) for _ in range(3)]
        Ts[1][0, 3], Ts[2][0, 3] = -0.30, -0.60
        K, MP = map_cfg.max_kf, map_cfg.max_pt
        ms = mstate.allocate(map_cfg, "cpu")
        for k in (0, 1):
            ms.kf_T[k] = _t(Ts[k], "cpu")
            ms.kf_uv[k] = _t(project(Ts[k], X), "cpu")
            ms.kf_desc[k] = _t(desc, "cpu")
            ms.kf_pt_idx[k, :n_bound] = torch.arange(n_bound)
            ms.kf_valid[k] = True
            ms.kf_frame_id[k] = k
            ms.kf_kp_valid[k] = True
        ms.kf_frame_id[2:] = -1
        ms.pt_xyz[:N] = _t(X, "cpu")
        ms.pt_desc[:N] = _t(desc, "cpu")
        ms.pt_valid[:n_bound] = True
        ms.pt_max_dist.fill_(20.0)
        ms.pt_min_dist.fill_(0.1)
        ms.pt_normal.copy_(torch.tensor([0, 0, -1.0]).expand(MP, 3))
        ms.n_kf.fill_(2)
        ms.n_pt.fill_(n_bound)
        uv2 = _t(project(Ts[2], X), "cpu")
        feats = extract.PointFeatures(
            uv=uv2, uv_un=uv2.clone(), response=torch.ones(N),
            octave=torch.zeros(N, dtype=torch.int32), angle=torch.zeros(N),
            desc=_t(desc, "cpu"), valid=torch.ones(N, dtype=torch.bool))
        matched = torch.where(torch.arange(N) < n_bound, torch.arange(N),
                              -1).to(torch.int32)
        return ms, feats, _t(Ts[2], "cpu"), matched

    per = [make_state(s) for s in range(S)]
    ms_b = mstate.stack([p[0] for p in per])
    feats_b = extract.PointFeatures(*(torch.stack(x) for x in zip(
        *(p[1] for p in per))))
    T_b = torch.stack([p[2] for p in per])
    m_b = torch.stack([p[3] for p in per])
    ms_b, feats_b, T_b, m_b = streams.shard_streams(
        mesh, (ms_b, feats_b, T_b, m_b))
    sf = torch.tensor([1.0, 1.2], device=dev)
    s2 = torch.tensor([1.0, 1.44], device=dev)

    def kf_chain(ms, feats, T, matched):
        mapping.process_keyframe(
            cam, ms, feats, None, T, matched,
            torch.full((map_cfg.n_lf,), -1, dtype=torch.int32, device=dev),
            2, torch.zeros(N, device=dev), s2, sf, window=4, p_ba=128,
            l_ba=8, max_depth=40.0, do_kf_cull=False, use_depth=False)
        return ms.n_kf, ms.n_pt
    n_kf, n_pt = (streams.gather_streams(mesh, x).cpu().numpy()
                  for x in torch.func.vmap(kf_chain)(ms_b, feats_b, T_b,
                                                     m_b))
    if not (n_kf == 3).all():
        raise RuntimeError(f"keyframe chain: keyframe counts {n_kf}")
    if not (n_pt > n_bound).all():
        raise RuntimeError(f"keyframe chain created no landmarks: {n_pt}")
    return n_kf, n_pt, n_bound


def empty_lines(K: int, L: int = 1, device=None) -> dict:
    """The line fields of a `BAProblem` with L empty line slots."""
    return dict(
        ln_xyz=torch.zeros((L, 2, 3), device=device),
        ln_mask=torch.zeros((L,), dtype=torch.bool, device=device),
        ln_obs_l2d=torch.tensor([1.0, 0.0, -1e9], device=device)
        .expand(K, L, 3).clone(),
        ln_obs_mask=torch.zeros((K, L), dtype=torch.bool, device=device))


def _dryrun_sharded_gba(mesh, cam, rng):
    """One landmark-sharded global BA (4 cameras, 64 points and 2 line
    slots per rank); returns its replicated cost and poses."""
    W = mesh.world
    K, P, L = 4, 64 * W, 2 * W
    X = np.stack([rng.uniform(-1.5, 1.5, P), rng.uniform(-1.0, 1.0, P),
                  rng.uniform(3, 8, P)], -1).astype(np.float32)
    Ts = np.broadcast_to(np.eye(4, dtype=np.float32), (K, 4, 4)).copy()
    Ts[:, 0, 3] = -0.1 * np.arange(K)
    obs_uv = np.zeros((K, P, 2), np.float32)
    for k in range(K):
        Xc = (Ts[k][:3, :3] @ X.T).T + Ts[k][:3, 3]
        obs_uv[k, :, 0] = cam.fx * Xc[:, 0] / Xc[:, 2] + cam.cx
        obs_uv[k, :, 1] = cam.fy * Xc[:, 1] / Xc[:, 2] + cam.cy
    obs_uv += rng.normal(0, 0.5, obs_uv.shape)
    dev = mesh.device
    prob = local_ba.BAProblem(
        kf_T=_t(Ts, dev), kf_fixed=_t([True] + [False] * (K - 1), dev),
        kf_mask=torch.ones(K, dtype=torch.bool, device=dev),
        pt_xyz=_t(X + rng.normal(0, 0.02, X.shape), dev, torch.float32),
        pt_mask=torch.ones(P, dtype=torch.bool, device=dev),
        obs_uv=_t(obs_uv, dev, torch.float32),
        obs_mask=torch.ones((K, P), dtype=torch.bool, device=dev),
        obs_sigma2=torch.ones((K, P), device=dev), **empty_lines(K, L, dev))
    lm = streams.make_mesh(axis=sharded_ba.AXIS, device=dev)
    res = sharded_ba.sharded_bundle_adjust(
        lm, sharded_ba.prepare_problem(prob, W), cam, iters_a=2, iters_b=3)
    cost = float(res.cost)
    if not np.isfinite(cost):
        raise RuntimeError(f"sharded global BA cost {cost}")
    return cost, res.kf_T.cpu().numpy()


def _build_kernel(device):
    """K1 built once here, before the ranks start (each then loads it)."""
    if device is None or torch.device(device).type == "cuda":
        gated_match.build()


def dryrun_multichip(n_devices: int, backend: str = "nccl", device=None,
                     threads: int | None = None) -> list:
    """The dry run on `n_devices` spawned ranks of a `backend` group, each
    on `device` (by default its card); raises where a rank fails or the
    ranks' replicated outputs differ. Returns each rank's result."""
    _build_kernel(device)
    out = spawn(_dryrun_rank, n_devices, backend, device=device,
                threads=threads)
    for r, o in enumerate(out[1:], 1):
        for k in ("T", "n_inliers", "H", "b", "n_kf", "n_pt", "kf_T"):
            if not np.array_equal(o[k], out[0][k]):
                raise RuntimeError(f"rank {r}'s {k} differs from rank 0's")
        if o["cost"] != out[0]["cost"]:
            raise RuntimeError(f"rank {r}'s BA cost differs from rank 0's")
    print(f"dryrun_multichip({n_devices}, {backend}): batched track step on "
          f"{out[0]['T'].shape[0]} streams + keyframe chain on the mesh "
          f"(keyframes {out[0]['n_kf'].tolist()}, points "
          f"{out[0]['n_pt'].tolist()}) + landmark-sharded GBA (cost "
          f"{out[0]['cost']:.4g}) + all-reduced edge system OK")
    return out


# ---------------------------------------------------------------------------
# the KITTI-scale global BA and the lockstep tracker on the ranks

KITTI_CAM = camera.Camera.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                                 width=640, height=480)


def kitti_like_problem(K: int, P: int, obs_span: int = 6, noise: float = 0.5,
                       seed: int = 11) -> local_ba.BAProblem:
    """tests/test_sharded_ba_scale.py's `make_kitti_like` on the CPU: K
    keyframes 0.4 m apart along z with a gentle sway, landmark p anchored
    4-10 m ahead of a random owner keyframe and observed (pixel noise
    `noise`) by up to `obs_span` consecutive keyframes from it, landmarks
    seen fewer than twice masked out; poses perturbed by a drift-shaped
    error and landmarks by 5 cm; the first two keyframes fixed, 8 empty
    line slots."""
    rng = np.random.default_rng(seed)
    ks = np.arange(K, dtype=np.float32)
    xi = np.zeros((K, 6), np.float32)
    xi[:, 3] = 0.15 * np.sin(0.1 * ks)
    xi[:, 5] = 0.4 * ks
    xi[:, 1] = 0.03 * np.sin(0.05 * ks)
    Ts = se3.se3_exp(torch.from_numpy(xi)).numpy()

    owner = rng.integers(0, K, P)
    depth = rng.uniform(4.0, 10.0, P).astype(np.float32)
    uv0 = np.stack([rng.uniform(40, 600, P), rng.uniform(40, 440, P)],
                   -1).astype(np.float32)
    Xc = np.stack([(uv0[:, 0] - 320.0) / 500.0 * depth,
                   (uv0[:, 1] - 240.0) / 500.0 * depth, depth], -1)
    X = np.einsum("pji,pj->pi", Ts[owner, :3, :3],
                  Xc - Ts[owner, :3, 3]).astype(np.float32)

    obs_uv = np.zeros((K, P, 2), np.float32)
    obs_mask = np.zeros((K, P), bool)
    for d in range(obs_span):
        k = np.minimum(owner + d, K - 1)
        Xck = np.einsum("pij,pj->pi", Ts[k, :3, :3], X) + Ts[k, :3, 3]
        z = Xck[:, 2]
        uv = np.stack([500.0 * Xck[:, 0] / np.maximum(z, 1e-6) + 320.0,
                       500.0 * Xck[:, 1] / np.maximum(z, 1e-6) + 240.0], -1)
        ok = (z > 0.5) & (uv[:, 0] > 2) & (uv[:, 0] < 638) \
            & (uv[:, 1] > 2) & (uv[:, 1] < 478)
        obs_uv[k[ok], np.arange(P)[ok]] = \
            uv[ok] + rng.normal(0, noise, (int(ok.sum()), 2))
        obs_mask[k[ok], np.arange(P)[ok]] = True
    keep = obs_mask.sum(0) >= 2

    Ts_pert = Ts.copy()
    rngp = np.random.default_rng(seed + 1)
    for k in range(1, K):
        mag = 0.002 + 0.01 * k / K
        dxi = rngp.normal(0, mag, 6).astype(np.float32) \
            * np.array([1, 1, 1, 4, 4, 4], np.float32)
        Ts_pert[k] = se3.se3_exp(torch.from_numpy(dxi)).numpy() @ Ts[k]
    X_pert = X + rngp.normal(0, 0.05, X.shape).astype(np.float32)
    return local_ba.BAProblem(
        kf_T=torch.from_numpy(Ts_pert),
        kf_fixed=torch.tensor([True, True] + [False] * (K - 2)),
        kf_mask=torch.ones(K, dtype=torch.bool),
        pt_xyz=torch.from_numpy(X_pert), pt_mask=torch.from_numpy(keep),
        obs_uv=torch.from_numpy(obs_uv),
        obs_mask=torch.from_numpy(obs_mask & keep[None, :]),
        obs_sigma2=torch.ones((K, P)), **empty_lines(K, 8))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed_bundle_adjust(mesh, prob, cam, iters_a: int, iters_b: int,
                        n_shards: int = 1) -> dict:
    """A prepared problem through `sharded_bundle_adjust` (the mesh, or one
    process in `n_shards` ranges), timed. Returns the result as numpy (the
    inlier grids packed, the LM decisions as a string of 0 / 1, the first
    iteration's first), the ms per LM iteration and the peak device memory
    above what was allocated before the call."""
    dev = prob.kf_T.device if mesh is None else mesh.device
    if dev.type == "cuda":
        base = torch.cuda.memory_allocated(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    _sync(dev)
    t0 = time.perf_counter()
    res = sharded_ba.sharded_bundle_adjust(
        n_shards if mesh is None else mesh, prob, cam, iters_a, iters_b)
    _sync(dev)
    secs = time.perf_counter() - t0
    n = iters_a + iters_b
    return dict(
        kf_T=res.kf_T.cpu().numpy(), cost=float(res.cost),
        pt_xyz=res.pt_xyz.cpu().numpy(), ln_xyz=res.ln_xyz.cpu().numpy(),
        obs_inlier=np.packbits(res.obs_inlier.cpu().numpy()),
        ln_obs_inlier=res.ln_obs_inlier.cpu().numpy(),
        accepted=format(int(res.accepted), f"0{n}b"),
        ms_per_iter=1e3 * secs / n,
        peak=torch.cuda.max_memory_allocated(dev) - base
        if dev.type == "cuda" else None)


def ba_rank(mesh, K: int, P: int, iters_a: int = 2, iters_b: int = 3,
            seed: int = 11, edges: int = 12288):
    """A rank of the multi-card BA check: the KITTI-like window (K, P,
    `seed`) through `timed_bundle_adjust` over the mesh; the all-reduce of
    the camera system and its right-hand side timed alone (ms per call,
    over 10 calls); and the edge-sharded pose system on `edges` random
    edges against the one-process form in `world` ranges."""
    dev = mesh.device
    # a small window first: the solver's first calls set up their libraries
    small = sharded_ba.prepare_problem(kitti_like_problem(8, 64 * mesh.world,
                                                          seed=seed),
                                       mesh.world)
    timed_bundle_adjust(mesh, small, KITTI_CAM, 1, 1)
    prob = sharded_ba.prepare_problem(kitti_like_problem(K, P, seed=seed),
                                      mesh.world)
    out = timed_bundle_adjust(mesh, prob, KITTI_CAM, iters_a, iters_b)
    buf = torch.zeros(36 * K * K + 6 * K, device=dev)
    streams.psum(mesh, buf)
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(10):
        streams.psum(mesh, buf)
    _sync(dev)
    out["allreduce_ms"] = 1e3 * (time.perf_counter() - t0) / 10
    out["allreduce_bytes"] = buf.numel() * buf.element_size()

    rng = np.random.default_rng(seed)
    xyz = np.stack([rng.uniform(-1, 1, edges), rng.uniform(-1, 1, edges),
                    rng.uniform(3, 6, edges)], -1).astype(np.float32)
    uv = camera.project(KITTI_CAM, torch.from_numpy(xyz)).numpy()
    uv = uv + rng.normal(0, 1, uv.shape).astype(np.float32)
    w = (rng.random(edges) > 0.1).astype(np.float32)
    args = [_t(a, dev) for a in (xyz, uv, w)]
    T = torch.eye(4, device=dev)
    T[:3, 3] = torch.tensor([0.05, -0.02, 0.1])
    H, b = streams.sharded_pose_normal_equations(mesh, KITTI_CAM, T, *args)
    H1, b1 = streams.sharded_pose_normal_equations(KITTI_CAM, T, *args,
                                                   mesh.world)
    out.update(H=H.cpu().numpy(), b=b.cpu().numpy(), H1=H1.cpu().numpy(),
               b1=b1.cpu().numpy())
    return out


def save_streams(path, maps: list, frames) -> tuple:
    """The streams' maps (a list of S maps, moved to the CPU, stacked) and
    frames ((S, F, H, W) uint8) into two files under directory `path`, as
    `lockstep_rank` reads them; returns their paths."""
    maps_path = os.path.join(path, "maps.pt")
    frames_path = os.path.join(path, "frames.npy")
    torch.save({f: torch.stack([getattr(m, f).cpu() for m in maps])
                for f in mstate.FIELDS}, maps_path)
    np.save(frames_path, np.ascontiguousarray(frames, np.uint8))
    return maps_path, frames_path


def lockstep_rank(mesh, cfg, maps_path: str, frames_path: str, n_frames: int,
                  deterministic: bool = False, n_streams: int | None = None
                  ) -> dict:
    """A rank of `BatchedTracker(mesh=)` over the first `n_streams` (all)
    streams of `save_streams`' files: it bootstraps its share of the maps
    and tracks frames 1 .. n_frames in lockstep (frame 0 made the maps;
    the keyframe chain every 5th frame from the first),
    synchronized after each step, under torch's deterministic algorithms
    where asked; K1's count set to 0 just before and read just after.
    Returns every stream's poses (F, S, 4, 4) and scalars (F, S, 6), the
    step seconds, K1 launches, peak device memory and graph counts."""
    if deterministic:
        torch.use_deterministic_algorithms(True, warn_only=True)
    dev = mesh.device
    frames = np.load(frames_path, mmap_mode="r")
    S = n_streams or frames.shape[0]
    frames = frames[:S]
    maps = torch.load(maps_path, mmap=True, weights_only=True)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    bt = BatchedTracker(cfg, S, mesh=mesh)
    bt.bootstrap(mstate.MapState(**{f: t[:S] for f, t in maps.items()}))
    out = lockstep(bt, frames, n_frames, dev)
    out.update(peak=torch.cuda.max_memory_allocated(dev)
               if dev.type == "cuda" else None,
               captures=bt.graphs.captures, replays=bt.graphs.replays)
    return out


def lockstep(bt, frames, n_frames: int, device, around=None) -> dict:
    """Frames 1 .. n_frames of `frames` (S, F, H, W) through the bootstrapped
    `BatchedTracker` `bt` in lockstep, synchronized after each step, the
    step timed; `around(j)`, where given, a context manager entered around
    step j and its timing. K1's count is set to 0 just before the first
    step and read just after the last. Returns every stream's poses (F, S,
    4, 4) and scalars (F, S, 6), the step seconds and the K1 launches."""
    Ts, sc, secs = [], [], []
    gated_match.gated_hamming_best2.launches = 0
    for j in range(n_frames):
        with around(j) if around is not None else contextlib.nullcontext():
            _sync(device)
            t0 = time.perf_counter()
            T, scalars = bt.step(frames[:, 1 + j])
            _sync(device)
            secs.append(time.perf_counter() - t0)
        Ts.append(T.cpu().numpy())
        sc.append(scalars.cpu().numpy())
    return dict(poses=np.stack(Ts), scalars=np.stack(sc), secs=secs,
                launches=gated_match.gated_hamming_best2.launches)


def depth_map(cfg, img, depth, device):
    """One stream's map from a frame: a keyframe at the origin and points
    from its depth (as chip_smoke.py bootstraps its maps)."""
    from ..ops import stereo
    ext_cfg = extract.ExtractorConfig(n_features=cfg.n_features,
                                      n_levels=cfg.n_levels)
    sf, _ = extract.scale_factors(ext_cfg, device)
    cam = camera.Camera.create(cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                               width=cfg.width, height=cfg.height)
    f = extract.PointExtractor(ext_cfg, cfg.height, cfg.width).to(device)(
        torch.from_numpy(np.asarray(img)).to(device).to(torch.float32))
    f = f._replace(uv_un=camera.undistort_pixels(cam, f.uv))
    ms = mstate.allocate(mstate.MapConfig(
        max_kf=cfg.max_kf, max_pt=cfg.max_pt, max_ln=cfg.max_ln,
        n_kp=cfg.n_features, n_lf=cfg.n_lf, n_levels=cfg.n_levels), device)
    mapping.insert_keyframe(cam, ms, f, torch.eye(4, device=device),
                            torch.full((cfg.n_features,), -1,
                                       dtype=torch.int32, device=device),
                            0, sf)
    mapping.create_points_from_depth(cam, ms, ms.n_kf - 1, stereo.depth_at(
        torch.from_numpy(np.asarray(depth, np.float32)).to(device), f.uv),
        sf)
    return ms


def curve_config():
    """scripts/scaling_curve.py's `SLAMConfig` (384 features, 3 levels,
    10 keyframes x 3072 points, lines on, loop closing off)."""
    from ..models.system import SLAMConfig
    return SLAMConfig(
        fx=500.0, fy=500.0, cx=320.0, cy=240.0, k1=0, k2=0, p1=0, p2=0, k3=0,
        n_features=384, n_levels=3, max_kf=10, max_pt=3072, n_lf=64,
        ba_window=4, ba_points=768, ba_lines=64, kf_max_interval=5,
        use_loop_closing=False)


def scaling_curve(ranks, backend: str, device=None,
                  n_steps: int = 8) -> list:
    """scripts/scaling_curve.py over ranks: `make_scene(seed=7)` along its
    orbit, one map from frame 0's depth broadcast to 16 streams (where the
    JAX script bootstraps a System), then 6 warm-up and `n_steps` timed
    lockstep frames through `BatchedTracker(mesh=)` at each world size of
    `ranks`. Prints and returns a row per world (lockstep step ms median
    over the timed steps, aggregate frames/s, the largest pose gap to the
    first world's run)."""
    from ..datasets import synthetic
    cfg, n_streams, warmup = curve_config(), 16, 6
    n = warmup + n_steps + 1
    scene = synthetic.make_scene(seed=7, width=cfg.width, height=cfg.height,
                                 fx=cfg.fx, fy=cfg.fy)
    Ts = synthetic.trajectory(24, "orbit", amplitude=1.0)
    img0, depth0 = synthetic.render_rgbd(scene, Ts[0])
    frames = np.stack([img0] + [synthetic.render(scene, Ts[i % 24])
                                for i in range(1, n)]).astype(np.uint8)
    ms = depth_map(cfg, img0, depth0, "cpu")
    rows, first = [], None
    _build_kernel(device)
    with tempfile.TemporaryDirectory(prefix="plslam_curve_") as tmp:
        paths = save_streams(tmp, [ms] * n_streams, np.broadcast_to(
            frames, (n_streams,) + frames.shape))
        for world in ranks:
            out = spawn(lockstep_rank, world, backend, device=device,
                        args=(cfg, *paths, warmup + n_steps))[0]
            step = np.array(out["secs"][warmup:])
            first = out["poses"] if first is None else first
            rows.append(dict(
                ranks=world, backend=backend, streams=n_streams,
                step_ms=1e3 * float(np.median(step)),
                aggregate_fps=n_streams * len(step) / float(step.sum()),
                pose_gap=float(np.abs(out["poses"] - first).max()),
                launches=out["launches"]))
            print(json.dumps(rows[-1]), flush=True)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--world", type=int, help="dry run on this many ranks")
    ap.add_argument("--ranks", type=int, nargs="+",
                    help="the lockstep curve at these world sizes")
    ap.add_argument("--backend", default="nccl", choices=("nccl", "gloo"))
    ap.add_argument("--steps", type=int, default=8)
    args = ap.parse_args(argv)
    if (args.world is None) == (args.ranks is None):
        ap.error("give one of --world and --ranks")
    if args.world is not None:
        dryrun_multichip(args.world, args.backend)
        return 0
    rows = scaling_curve(args.ranks, args.backend, n_steps=args.steps)
    print("\nranks  step_ms  aggregate_fps  pose_gap   (ranks sharing a card "
          "time-slice it: mechanics, not a speed-up)")
    for r in rows:
        print(f"{r['ranks']:5d}  {r['step_ms']:7.1f}  "
              f"{r['aggregate_fps']:13.1f}  {r['pose_gap']:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`plslam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

1. builds the gated Hamming top-2 kernel (K1) from `plslam_tpu_torch/csrc`;
2. checks K1 against its plain PyTorch version on the card, bit for bit, at
   (N=200, P=700) and at the slice's (N=1024, P=12288), gated and gates-off,
   and times the device work of the kernel launch on packed descriptors, of
   the wrapper with its packing, and of the plain version (CUDA events around
   batches of 10 calls queued behind a spin kernel, median of 20 batches,
   after a warm-up batch);
3. drives the per-frame tracking step over a rendered 48-frame 640x480
   sequence at the default configuration (1024 features, 8 levels, a
   12288-point map): a depth bootstrap on frame 0, then extraction ->
   undistortion -> local-map tracking on frames 1-47, with a depth keyframe
   every 8th frame. It checks >= 30 inliers per frame, an ATE below 5% of the
   path length (no alignment: the map is metric and frame 0 is the origin),
   and that every search of the step went through K1 (3 per frame).

Any failed check exits non-zero. The last line is the device JSON; the line
before it lists the kernels with their launch counts and timings. There is no
CPU path: without a CUDA device the script exits non-zero.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
WIDTH, HEIGHT, FX = 640, 480, 500.0
N_FRAMES = 48
KF_EVERY = 8
MIN_INLIERS = 30
ATE_FRACTION = 0.05


def fail(msg: str):
    print(f"FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 \
        else f"nvidia-smi failed: {out.stderr.strip()}"


def _sleep_cycles_per_ms() -> float:
    """Clock cycles of `torch.cuda._sleep` per millisecond on the device."""
    cycles = 10_000_000
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(1000)   # loads the spin kernel before it is timed
    start.record()
    torch.cuda._sleep(cycles)
    stop.record()
    stop.synchronize()
    return cycles / start.elapsed_time(stop)


def cuda_ms(fn, runs: int = 20, batch: int = 10) -> float:
    """Device milliseconds per fn() call: the median over `runs`
    CUDA-event-timed batches of `batch` back-to-back calls, after a warm-up
    batch. A spin kernel runs ahead of each batch; a batch counts only if the
    spin was still running when the host had queued all of it, so that the
    events time the device's work and not the host's launch path (otherwise
    the spin is doubled and the batch run again)."""
    for _ in range(batch):
        fn()
    torch.cuda.synchronize()
    cycles_per_ms = _sleep_cycles_per_ms()
    hold_ms, times = 2.0, []
    for _ in range(3 * runs):
        start = torch.cuda.Event(enable_timing=True)
        stop = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(cycles_per_ms * hold_ms))
        start.record()
        for _ in range(batch):
            fn()
        caught_up = start.query()
        stop.record()
        stop.synchronize()
        if caught_up:
            hold_ms *= 2.0
            if hold_ms > 1000.0:
                break   # the host waits for the device inside fn
            continue
        times.append(start.elapsed_time(stop) / batch)
        if len(times) == runs:
            return float(np.median(times))
    fail(f"timing: only {len(times)} of {3 * runs} batches were queued "
         f"before the device reached them")


def random_search_inputs(rng, n: int, p: int) -> dict:
    """Search inputs shaped like the tracking step's, as numpy arrays:
    keypoints and projected map points in a 640x480 image, windows of
    15 px x 1.2^level."""
    level = rng.integers(0, 8, p).astype(np.int32)
    return dict(
        q_bits=rng.integers(0, 2, (n, 256)).astype(np.uint8),
        q_uv=np.stack([rng.uniform(0, 640, n), rng.uniform(0, 480, n)],
                      -1).astype(np.float32),
        q_oct=rng.integers(0, 8, n).astype(np.int32),
        q_valid=rng.random(n) > 0.05,
        d_bits=rng.integers(0, 2, (p, 256)).astype(np.uint8),
        d_uv=np.stack([rng.uniform(0, 640, p), rng.uniform(0, 480, p)],
                      -1).astype(np.float32),
        d_radius=(15.0 * 1.2 ** level).astype(np.float32),
        d_level=level,
        d_visible=rng.random(p) > 0.3)


def check_kernel(gm, device):
    """K1 against its plain version: exact equality, and timings."""
    rng = np.random.default_rng(0)
    max_err, timing = 0, {}
    for n, p in ((200, 700), (1024, 12288)):
        a = {k: torch.from_numpy(v).to(device)
             for k, v in random_search_inputs(rng, n, p).items()}
        for gated in (True, False):
            got = gm.gated_hamming_best2(**a, gated=gated)
            want = gm.gated_hamming_best2_reference(**a, gated=gated)
            torch.cuda.synchronize()
            for name, x, y in zip(("idx", "best", "second"), got, want):
                err = int((x.long() - y.long()).abs().max())
                max_err = max(max_err, err)
                if err:
                    fail(f"K1 N={n} P={p} gated={gated}: {name} differs from "
                         f"the plain version (max |diff| {err})")
            packed = dict(a, q_bits=gm.pack_bits(a["q_bits"]),
                          d_bits=gm.pack_bits(a["d_bits"]))
            k_ms = cuda_ms(lambda: gm.launch_packed(*packed.values(),
                                                    gated=gated))
            w_ms = cuda_ms(lambda: gm.gated_hamming_best2(**a, gated=gated))
            p_ms = cuda_ms(lambda: gm.gated_hamming_best2_reference(
                **a, gated=gated))
            timing[(n, p, gated)] = (k_ms, p_ms)
            print(f"K1 N={n} P={p} gated={gated}: bit-equal to the plain "
                  f"version; ms per call: kernel {k_ms:.4f}, wrapper with "
                  f"packing {w_ms:.4f}, plain {p_ms:.4f}")
    return max_err, timing


def render_sequence(n_frames=N_FRAMES):
    from plslam_tpu_torch.datasets import synthetic
    scene = synthetic.make_scene(seed=0, width=WIDTH, height=HEIGHT, fx=FX,
                                 fy=FX)
    Ts = synthetic.trajectory(n_frames, "orbit")
    frames, depths = [], {}
    for i, T in enumerate(Ts):
        if i % KF_EVERY == 0:
            img, depths[i] = synthetic.render_rgbd(scene, T)
        else:
            img = synthetic.render(scene, T)
        frames.append(img.astype(np.uint8))
    return Ts, np.stack(frames), depths


def run_slice(frames_np, depths_np, after_frame=lambda i: None):
    """The port's per-frame step on the card at the repo's configuration
    (1024 features, 8 levels, a 12288-point map): a depth bootstrap on frame
    0, then extraction -> undistortion -> tracking on every later frame, with
    a depth keyframe every KF_EVERY frames. Each stage runs under a
    `record_function` label (extract, track, keyframe) and is timed on the
    host clock up to a device synchronization; `after_frame(i)` is called
    once frame i is done."""
    from torch.profiler import record_function
    from plslam_tpu_torch.geometry import camera
    from plslam_tpu_torch.mapstate import state as mstate
    from plslam_tpu_torch.models import mapping, tracking
    from plslam_tpu_torch.ops import extract, gated_match, stereo

    device = torch.device("cuda", 0)
    cfg, map_cfg = extract.ExtractorConfig(), mstate.MapConfig()
    cam = camera.Camera.create(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2,
                               width=WIDTH, height=HEIGHT)
    sf, s2 = extract.scale_factors(cfg, device)
    extractor = extract.PointExtractor(cfg, HEIGHT, WIDTH).to(device)
    frames = torch.from_numpy(frames_np).to(device)
    depths = {i: torch.from_numpy(d).to(device) for i, d in depths_np.items()}
    ms = mstate.allocate(map_cfg, device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)

    def features(i):
        with record_function("extract"):
            f = extractor(frames[i].to(torch.float32))
            return f._replace(uv_un=camera.undistort_pixels(cam, f.uv))

    def add_keyframe(f, T, matched_pt, i):
        with record_function("keyframe"):
            mapping.insert_keyframe(cam, ms, f, T, matched_pt, i, sf)
            mapping.create_points_from_depth(
                cam, ms, ms.n_kf - 1, stereo.depth_at(depths[i], f.uv), sf)

    gated_match.gated_hamming_best2.launches = 0
    f0 = features(0)
    add_keyframe(f0, torch.eye(4, device=device),
                 torch.full((map_cfg.n_kp,), -1, dtype=torch.int32,
                            device=device), 0)
    torch.cuda.synchronize()
    after_frame(0)
    T, vel = torch.eye(4, device=device), torch.eye(4, device=device)
    poses, inliers, t_ext, t_trk, t_kf = [T.cpu().numpy()], [], [], [], []
    for i in range(1, len(frames_np)):
        t0 = time.perf_counter()
        f = features(i)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with record_function("track"):
            res, ms = tracking.track_local_map(
                cam, ms, f, T, sf, s2, n_levels=cfg.n_levels, scale=cfg.scale,
                velocity=vel, update_stats=True)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        T, vel = res.T, res.velocity
        if i % KF_EVERY == 0:
            add_keyframe(f, T, res.matched_pt, i)
            torch.cuda.synchronize()
            t_kf.append(time.perf_counter() - t2)
        t_ext.append(t1 - t0)
        t_trk.append(t2 - t1)
        poses.append(T.cpu().numpy())
        inliers.append(int(res.n_inliers))
        after_frame(i)
    return dict(poses=np.stack(poses), inliers=inliers, ext=np.array(t_ext),
                trk=np.array(t_trk), kf=np.array(t_kf),
                launches=gated_match.gated_hamming_best2.launches,
                n_pt=int(ms.n_pt), n_kf=int(ms.n_kf),
                peak=torch.cuda.max_memory_allocated(device))


def centers(Ts):
    return np.stack([-T[:3, :3].T @ T[:3, 3] for T in Ts])


def main() -> int:
    if not torch.cuda.is_available():
        print("no CUDA device: the port's kernels need one", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import plslam_tpu_torch
    if Path(plslam_tpu_torch.__file__).resolve().parent.parent != ROOT:
        fail(f"imported plslam_tpu_torch from {plslam_tpu_torch.__file__}, "
             f"not from this checkout")
    from plslam_tpu_torch.ops import gated_match as gm

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}; "
          f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
          f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    t0 = time.perf_counter()
    lib = gm.build(verbose=True)
    print(f"build: {lib.relative_to(ROOT)} ready in "
          f"{time.perf_counter() - t0:.2f} s")

    max_err, timing = check_kernel(gm, device)

    t0 = time.perf_counter()
    Ts, frames, depths = render_sequence()
    print(f"rendered {N_FRAMES} frames 640x480 in "
          f"{time.perf_counter() - t0:.1f} s")
    out = run_slice(frames, depths)

    inl = np.array(out["inliers"])
    c_gt, c_est = centers(Ts), centers(out["poses"])
    path = float(np.linalg.norm(np.diff(c_gt, axis=0), axis=1).sum())
    ate = float(np.sqrt(np.mean(np.sum((c_est - c_gt) ** 2, axis=1))))
    step = out["ext"] + out["trk"]
    pct_ms = lambda x, q: 1e3 * float(np.percentile(x, q))
    print(f"slice: inliers per frame min {inl.min()} median "
          f"{int(np.median(inl))} max {inl.max()}")
    print(f"slice: ATE {ate:.4f} m over a {path:.3f} m path "
          f"({100 * ate / path:.2f}%); final n_pt {out['n_pt']} n_kf "
          f"{out['n_kf']}; K1 launches {out['launches']}")
    for name, x in (("extraction", out["ext"]), ("tracking", out["trk"]),
                    ("step", step), ("keyframe insert", out["kf"])):
        print(f"slice: {name} ms median {pct_ms(x, 50):.2f} p90 {pct_ms(x, 90):.2f}")
    print(f"slice: {1e3 / pct_ms(step, 50):.2f} frames/s at the median step; "
          f"peak device memory {out['peak'] / 2**20:.1f} MiB")

    if inl.min() < MIN_INLIERS:
        fail(f"frame {int(inl.argmin()) + 1} tracked {inl.min()} inliers "
             f"(< {MIN_INLIERS})")
    if not ate < ATE_FRACTION * path:
        fail(f"ATE {ate:.4f} m is not below {ATE_FRACTION:.0%} of the "
             f"{path:.3f} m path")
    if out["launches"] != 3 * (N_FRAMES - 1):
        fail(f"K1 launched {out['launches']} times in the slice, expected "
             f"{3 * (N_FRAMES - 1)}")

    k_ms, p_ms = timing[(1024, 12288, True)]
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": [{
        "name": "gated_hamming_best2", "route": "cuda",
        "source": "plslam_tpu_torch/csrc/gated_hamming.cu",
        "replaces": "plslam_tpu/ops/pallas_match.py:115",
        "launches": out["launches"], "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

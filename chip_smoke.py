#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`plslam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

1. builds the gated Hamming top-2 kernel (K1) from `plslam_tpu_torch/csrc`;
2. checks K1 against its plain PyTorch version on the card, bit for bit, at
   (N=200, P=700) and at the tracking step's (N=1024, P=12288), gated and
   gates-off, and at `match_frames`' shape (the 1024 x 1024 features of
   frames 0 and 2 of the system sequence, 100 px window); it times the
   device work of the wrapper (one kernel launch), of the plain version and
   of `torch._int_mm` on the same rows (the product stage alone), with CUDA
   events around batches of 10 calls queued behind a spin kernel, median of
   20 batches, after a warm-up batch, and prints each beside its bound;
3. the tracking slice: the per-frame tracking step over a rendered 48-frame
   640x480 sequence at the default configuration (1024 features, 8 levels, a
   12288-point map): a depth bootstrap on frame 0, then extraction ->
   undistortion -> local-map tracking on frames 1-47, with a depth keyframe
   every 8th frame. It checks >= 30 inliers per frame, an ATE below 5% of the
   path length (no alignment: the map is metric and frame 0 is the origin),
   and that every search of the step went through K1 (3 per frame);
4. the system phase: `System.track_monocular` over the 60-frame system
   sequence (`make_scene(seed=1)`, orbit) at the `SLAMConfig` defaults with
   the renderer's camera and lines, loop closing and map growth off. It
   checks initialization within the first 10 frames, no LOST frame after
   it, >= 3 keyframes, > 150 map points, an ATE after Sim3 alignment below
   5% of the span, and exactly 3 K1 launches per tracked frame plus one
   per initialization match; it prints per-stage host times (each stage
   synchronized), frames, counts and peak device memory. It records K1's
   arguments on the initialization frame (`match_frames`) and on the first
   frame tracked after the chain's first keyframe (the wide-window, the
   gates-off ratio and the local-map search), and checks and times K1 on
   those four real calls as in step 2, with the share of pairs that pass;
5. the lines phase, on the line-rich sequence of tests/test_lines_help.py
   (40 frames, `make_scene(seed=9, n_lines=24)`, plane textures flattened):
   (a) `System.track_monocular` at the `SLAMConfig` defaults with lines on,
   the lines-help keyframe cadence (every 3 frames, `kf_ref_ratio` 2,
   `min_init_matches` 60, `tri_covis` off), loop closing and growth off,
   with step 4's checks plus >= 1 valid map line at the end, and per-stage
   host times including line detection and `create_new_lines` in the
   chain; (b) tests/test_lines_help.py's own small widths with lines on and
   off: no LOST frame after initialization, a valid map line and a tracked
   frame with a line inlier (lines on), both ATEs printed beside the CPU
   runs of `scripts/lines_yardstick.py`; (c) `detect_lines` on the card
   against the port on the CPU for three frames (`check_detect_on_card`).

Any failed check exits non-zero. The last line is the device JSON; the line
before it lists the kernels with their launch counts (every phase) and
timings. There is no CPU path: without a CUDA device the script exits
non-zero.
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
SYSTEM_FRAMES = 60
INIT_WITHIN = 10      # frames
MIN_KEYFRAMES = 3
MIN_POINTS = 150      # valid map points (tests/test_e2e.py's bar)
TRACKING_SEARCHES = ("wide-window search", "gates-off ratio search",
                     "local-map search")   # K1's calls per tracked frame
LINES_FRAMES = 40
# tests/test_lines_help.py's keyframe cadence and small widths
LINES_HELP = dict(kf_min_interval=3, kf_max_interval=3, kf_ref_ratio=2.0,
                  min_init_matches=60, tri_covis=False)
LINES_SMALL = dict(n_features=256, n_levels=3, max_kf=24, max_pt=4096,
                   max_ln=256, n_lf=96, ba_window=5, ba_points=1024,
                   ba_lines=128, track_line_info=1.0)
# scripts/lines_yardstick.py on the CPU, the small widths (init frame, ATE)
SMALL_CPU = {"jax": "lines on: init 28, ATE 0.0270; off: init 28, "
                    "ATE 0.0334",
             "port": "lines on: init 19, ATE 0.0336; off: init 19, "
                     "ATE 0.0300"}
DETECT_FRAMES = (0, 13, 27)
DETECT_TOL_PX = 0.05      # card vs CPU endpoint gap (check_detect_on_card)
DETECT_TIE_PX = 0.05      # segments this close to the length floor may flip
DETECT_BITS = 0.995       # share of equal descriptor bits


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


def match_frames_inputs(rng, n: int = 1024) -> dict:
    """Search inputs shaped like `match_frames`' call of K1, as numpy
    arrays: two frames' n keypoints in a 640x480 image, a 100 px window
    around every keypoint of the second, octaves 0-7."""
    a = random_search_inputs(rng, n, n)
    a["d_radius"] = np.full(n, 100.0, np.float32)
    a["d_level"] = rng.integers(0, 8, n).astype(np.int32)
    return a


def match_frames_case(feats1, feats2) -> dict:
    """K1's inputs as `tracking.match_frames(feats1, feats2)` passes them."""
    return dict(q_bits=feats1.desc, q_uv=feats1.uv, q_oct=feats1.octave,
                q_valid=feats1.valid, d_bits=feats2.desc, d_uv=feats2.uv,
                d_radius=torch.full((feats2.uv.shape[0],), 100.0,
                                    device=feats2.uv.device),
                d_level=feats2.octave, d_visible=feats2.valid)


H100_INT8_OPS = 1979e12   # dense int8 tensor-core peak, H100 SXM data sheet
H100_BYTES = 3.35e12      # HBM3 bytes/s, H100 SXM data sheet


def int_mm_ms(a):
    """Device ms of `torch._int_mm` on the {0,1} rows viewed as int8, N x 256
    by 256 x P: the product stage alone, as a yardstick; None where the
    call refuses the shape."""
    q, d = a["q_bits"].view(torch.int8), a["d_bits"].view(torch.int8).t()
    try:
        torch._int_mm(q, d)
    except RuntimeError as e:
        print(f"  torch._int_mm refuses {tuple(q.shape)} x {tuple(d.shape)}: "
              f"{str(e).splitlines()[0]}")
        return None
    return cuda_ms(lambda: torch._int_mm(q, d))


def check_case(gm, label, a, gated):
    """K1 against its plain version on inputs `a` (exact equality in idx,
    best and second), then device ms per call of the wrapper, of the plain
    version and of `torch._int_mm`, beside the bound: the larger of the
    bytes the function must move over the memory rate and 2 x 256 integer
    operations per pair that passes the gates over the int8 peak."""
    got = gm.gated_hamming_best2(**a, gated=gated)
    want = gm.gated_hamming_best2_reference(**a, gated=gated)
    torch.cuda.synchronize()
    err = 0
    for name, x, y in zip(("idx", "best", "second"), got, want):
        e = int((x.long() - y.long()).abs().max()) if x.numel() else 0
        err = max(err, e)
        if e or x.dtype != y.dtype:
            fail(f"K1 {label}: {name} differs from the plain version "
                 f"(max |diff| {e}, dtypes {x.dtype} / {y.dtype})")
    n, p = a["q_bits"].shape[0], a["d_bits"].shape[0]
    n_pass = int(gm.gate_mask(*(a[k] for k in (
        "q_uv", "q_oct", "q_valid", "d_uv", "d_radius", "d_level",
        "d_visible")), gated=gated).sum())
    n_bytes = sum(t.numel() * t.element_size() for t in a.values()) \
        + sum(t.numel() * t.element_size() for t in got)
    bytes_ms = 1e3 * n_bytes / H100_BYTES
    ops_ms = 1e3 * 2 * 256 * n_pass / H100_INT8_OPS
    dense_ms = 1e3 * 2 * 256 * n * p / H100_INT8_OPS
    out = dict(err=err, share=n_pass / max(n * p, 1),
               ms=cuda_ms(lambda: gm.gated_hamming_best2(**a, gated=gated)),
               plain_ms=cuda_ms(lambda: gm.gated_hamming_best2_reference(
                   **a, gated=gated)),
               library_ms=int_mm_ms(a), bound_ms=max(bytes_ms, ops_ms),
               bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    lib = "n/a" if out["library_ms"] is None else f"{out['library_ms']:.4f}"
    print(f"K1 {label}: bit-equal to the plain version; {n_pass} of {n * p} "
          f"pairs pass ({100 * out['share']:.3f}%); ms per call: wrapper "
          f"{out['ms']:.4f}, plain {out['plain_ms']:.4f}, torch._int_mm "
          f"{lib}; bound {out['bound_ms']:.5f} ms by {out['bound_by']} "
          f"(bytes {n_bytes} / 3.35 TB/s = {bytes_ms:.5f} ms, 2 x 256 x "
          f"{n_pass} passing pairs / 1979 TOP/s = {ops_ms:.5f} ms; dense "
          f"product {dense_ms:.5f} ms), wrapper at "
          f"{100 * out['bound_ms'] / out['ms']:.1f}% of the bound")
    return out


def check_kernel(gm, device, match_case):
    """`check_case` on random inputs at two sizes (gated and gates-off) and
    on `match_case`."""
    rng = np.random.default_rng(0)
    cases = []
    for n, p in ((200, 700), (1024, 12288)):
        a = {k: torch.from_numpy(v).to(device)
             for k, v in random_search_inputs(rng, n, p).items()}
        cases += [((n, p, gated), f"N={n} P={p} gated={gated}", a, gated)
                  for gated in (True, False)]
    cases.append(("match_frames", "match_frames N=1024 P=1024 r=100 "
                  "gated=True", match_case, True))
    return {key: check_case(gm, label, a, gated)
            for key, label, a, gated in cases}


class K1Recorder:
    """Stands in for the `gated_match` module inside `models/tracking` and
    keeps a copy of the arguments of K1's calls while `on` is set; every
    call still goes through `gated_match.gated_hamming_best2`."""

    def __init__(self, gm):
        import inspect
        self.gm, self.on, self.calls = gm, False, []
        self.names = list(inspect.signature(
            gm.gated_hamming_best2).parameters)[:9]

    def gated_hamming_best2(self, *args, gated=True):
        if self.on:
            self.calls.append((dict(zip(self.names,
                                        (t.clone() for t in args))), gated))
        return self.gm.gated_hamming_best2(*args, gated=gated)


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


def render_system_sequence(n_frames=SYSTEM_FRAMES):
    """The system sequence: `make_scene(seed=1)` along
    `trajectory(60, "orbit")`, 640x480, fx = fy = 500 (the sequence of the
    JAX package's end-to-end scripts)."""
    from plslam_tpu_torch.datasets import synthetic
    scene = synthetic.make_scene(seed=1)
    Ts = synthetic.trajectory(n_frames, "orbit")
    return Ts, [synthetic.render(scene, T) for T in Ts]


def system_config():
    """`SLAMConfig` defaults (TUM fr1 widths: 640x480, 1024 features, 8
    levels, 48 keyframes x 12288 points, an 8 x 3072 BA window) with the
    renderer's camera, and lines, loop closing and map growth off."""
    from plslam_tpu_torch.models.system import SLAMConfig
    return SLAMConfig(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2, k1=0, k2=0,
                      p1=0, p2=0, k3=0, use_lines=False,
                      use_loop_closing=False, grow_map=False)


def run_system(frames, cfg=None, record_calls=True):
    """`System.track_monocular` over the frames on cuda:0 at `cfg` (default
    `system_config()`). Each stage (extraction, line detection inside it,
    initialization match and two-view solve, tracking, the keyframe chain
    and the line triangulations and local BAs inside it, and the local BA
    after initialization) is wrapped to run between two device
    synchronizations and timed on the host clock; K1's launch count is set
    to 0 just before the run and read just after. With `record_calls`, K1's
    arguments are recorded on the initialization frame (its `match_frames`
    call) and on the first frame tracked after the first keyframe of the
    chain (its three searches)."""
    from plslam_tpu_torch.models import mapping, tracking
    from plslam_tpu_torch.models.system import System
    from plslam_tpu_torch.ops import gated_match

    device = torch.device("cuda", 0)
    slam = System(cfg if cfg is not None else system_config(), device=device)
    times = {k: [] for k in ("extract", "lines", "match", "two_view",
                             "init_ba", "track", "keyframe", "create_lines",
                             "local_ba")}

    def timed(fn, name):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            return out
        return wrapper

    for attr, name in (("_extract", "extract"), ("_detect_lines", "lines"),
                       ("_match_frames", "match"),
                       ("_init_two_view", "two_view"),
                       ("_track_update", "track"),
                       ("_process_kf", "keyframe"), ("_local_ba", "init_ba")):
        setattr(slam, attr, timed(getattr(slam, attr), name))
    # inside the chain (the initial map's lines go through slam._create_lines)
    chain_ba, chain_lines = mapping.run_local_ba, mapping.create_new_lines
    mapping.run_local_ba = timed(chain_ba, "local_ba")
    mapping.create_new_lines = timed(chain_lines, "create_lines")
    recorder = K1Recorder(gated_match)
    tracking.gated_match = recorder
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    init, states, real_calls = None, [], []
    gated_match.gated_hamming_best2.launches = 0
    try:
        for i, img in enumerate(frames):
            capture = record_calls and not real_calls and slam.n_kf_host > 2
            recorder.on = record_calls and (init is None or capture)
            recorder.calls = []
            slam.track_monocular(img, i / 30.0)
            states.append(slam.state)
            if init is None and slam.state == "OK":
                init = i
                init_call = recorder.calls[-1] if record_calls else None
            elif capture:
                real_calls = [(f"{label}, frame {i}", *call) for label, call
                              in zip(TRACKING_SEARCHES, recorder.calls)]
                if len(recorder.calls) != len(TRACKING_SEARCHES):
                    fail(f"frame {i} made {len(recorder.calls)} K1 calls, "
                         f"expected {len(TRACKING_SEARCHES)}")
    finally:
        mapping.run_local_ba, mapping.create_new_lines = chain_ba, chain_lines
        tracking.gated_match = gated_match
    launches = gated_match.gated_hamming_best2.launches
    if init is not None and record_calls:
        real_calls.append((f"match_frames, init frame {init}", *init_call))
    traj = dict(slam.trajectory)
    idx = [i for i in range(len(frames)) if i / 30.0 in traj]
    return dict(slam=slam, init=init, states=states, times=times,
                launches=launches, idx=idx, real_calls=real_calls,
                poses=np.stack([traj[i / 30.0] for i in idx]),
                peak=torch.cuda.max_memory_allocated(device))


def check_system(Ts, out, label="system", min_lines=0):
    """The system phase's six checks (and, with `min_lines`, at least that
    many valid map lines at the end); returns the ATE and span."""
    from plslam_tpu_torch.datasets import synthetic
    slam, init, times = out["slam"], out["init"], out["times"]
    pct_ms = lambda x, q: 1e3 * float(np.percentile(x, q)) if x else 0.0
    for name in ("extract", "lines", "track", "keyframe", "create_lines",
                 "local_ba"):
        x = times[name]
        if x:
            print(f"{label}: {name} ms median {pct_ms(x, 50):.2f} p90 "
                  f"{pct_ms(x, 90):.2f} over {len(x)} calls")
    if init is not None and times["init_ba"]:
        tv = times["two_view"]
        print(f"{label}: init on frame {init}: "
              f"{1e3 * slam.timings[init]:.2f} ms, of which match "
              f"{1e3 * times['match'][-1]:.2f} ms, two-view "
              f"{1e3 * tv[-1]:.2f} ms, initial local BA "
              f"{1e3 * times['init_ba'][0]:.2f} ms; {len(times['match'])} "
              f"match and {len(tv)} two-view attempts in all, the first "
              f"two-view {1e3 * tv[0]:.2f} ms")
    n_track = len(times["track"])
    expected = 3 * n_track + len(times["match"])
    lost = [i for i, s in enumerate(out["states"]) if init is not None
            and i > init and s != "OK"]
    idx = out["idx"]
    ate = synthetic.ate_rmse(out["poses"], Ts[idx])
    c = centers(Ts[idx])
    span = float(np.linalg.norm(c[-1] - c[0]))
    n_lines = int(slam.ms.ln_valid.sum())
    ln_inl = [s.get("line_inliers", 0) for s in slam.stats
              if not s.get("lost")]
    print(f"{label}: {n_track} frames tracked, {len(idx)} poses, "
          f"{slam.n_keyframes()} keyframes, {slam.n_map_points()} map points, "
          f"{int(slam.ms.n_ln)} map lines created, {n_lines} valid, line "
          f"inliers per tracked frame max {max(ln_inl, default=0)} (on "
          f"{sum(1 for n in ln_inl if n > 0)} frames), ATE {ate:.4f} m over a "
          f"{span:.3f} m span ({100 * ate / max(span, 1e-9):.2f}%), K1 "
          f"launches {out['launches']} (expected {expected}), peak device "
          f"memory {out['peak'] / 2**20:.1f} MiB")
    if init is None or init >= INIT_WITHIN:
        fail(f"{label}: not initialized within the first {INIT_WITHIN} "
             f"frames (init frame {init})")
    if lost:
        fail(f"{label}: LOST after initialization on frames {lost}")
    if slam.n_keyframes() < MIN_KEYFRAMES:
        fail(f"{label}: {slam.n_keyframes()} keyframes (< {MIN_KEYFRAMES})")
    if slam.n_map_points() <= MIN_POINTS:
        fail(f"{label}: {slam.n_map_points()} map points (<= {MIN_POINTS})")
    if n_lines < min_lines:
        fail(f"{label}: {n_lines} valid map lines at the end (< {min_lines})")
    if not ate < ATE_FRACTION * max(span, 0.2):
        fail(f"{label}: ATE {ate:.4f} m is not below {ATE_FRACTION:.0%} of "
             f"the {span:.3f} m span")
    if out["launches"] != expected:
        fail(f"{label}: K1 launched {out['launches']} times, expected 3 x "
             f"{n_track} tracked frames + {len(times['match'])} init matches "
             f"= {expected}")
    return ate, span


def render_lines_sequence(n_frames=LINES_FRAMES):
    """The line-rich sequence of tests/test_lines_help.py: `make_scene(seed=9,
    n_lines=24)` with the plane textures flattened to 5% contrast (weak
    corners, high-contrast segments), `trajectory(40, "orbit",
    amplitude=1.0)`, 640x480, fx = fy = 500."""
    from plslam_tpu_torch.datasets import synthetic
    scene = synthetic.make_scene(seed=9, n_lines=24)
    planes = [synthetic.Plane(p.origin, p.e1, p.e2, p.scale,
                              (110.0 + (p.tex - float(p.tex.mean())) * 0.05
                               ).astype(np.float32)) for p in scene.planes]
    scene = synthetic.Scene(planes, scene.lines, scene.points, scene.K,
                            scene.width, scene.height)
    Ts = synthetic.trajectory(n_frames, "orbit", amplitude=1.0)
    return Ts, [synthetic.render(scene, T) for T in Ts]


def lines_config(small: bool = False, use_lines: bool = True):
    """The lines phase's `SLAMConfig`: the defaults (or, with `small`,
    tests/test_lines_help.py's widths) with the renderer's camera, the
    lines-help keyframe cadence, loop closing and map growth off."""
    from plslam_tpu_torch.models.system import SLAMConfig
    return SLAMConfig(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2, k1=0, k2=0,
                      p1=0, p2=0, k3=0, use_lines=use_lines,
                      use_loop_closing=False, grow_map=False, **LINES_HELP,
                      **(LINES_SMALL if small else {}))


def check_lines_small(Ts, on, off):
    """(b): the small-width configuration with lines on: no LOST frame
    after initialization, a valid map line at the end and a line inlier on
    at least one tracked frame; prints both runs beside the CPU runs."""
    from plslam_tpu_torch.datasets import synthetic
    res = {}
    for name, out in (("on", on), ("off", off)):
        slam, idx = out["slam"], out["idx"]
        res[name] = dict(init=out["init"], poses=len(idx),
                         kf=slam.n_keyframes(), pts=slam.n_map_points(),
                         ln=int(slam.ms.n_ln),
                         ln_valid=int(slam.ms.ln_valid.sum()),
                         ln_inl=[s.get("line_inliers", 0) for s in slam.stats
                                 if not s.get("lost")],
                         launches=out["launches"],
                         ate=synthetic.ate_rmse(out["poses"], Ts[idx])
                         if len(idx) >= 3 else float("nan"))
        r = res[name]
        print(f"lines (b), lines {name}: init frame {r['init']}, "
              f"{r['poses']} poses, {r['kf']} keyframes, {r['pts']} points, "
              f"{r['ln']} lines created, {r['ln_valid']} valid, line inliers "
              f"per tracked frame {r['ln_inl']}, ATE {r['ate']:.4f}, K1 "
              f"launches {r['launches']}")
    print(f"lines (b): ATE on / off {res['on']['ate']:.4f} / "
          f"{res['off']['ate']:.4f} (ratio "
          f"{res['on']['ate'] / res['off']['ate']:.3f}); the CPU runs of "
          f"scripts/lines_yardstick.py: JAX package {SMALL_CPU['jax']}, "
          f"port {SMALL_CPU['port']}")
    lost = [i for i, s in enumerate(on["states"])
            if on["init"] is not None and i > on["init"] and s != "OK"]
    if on["init"] is None:
        fail("lines (b): never initialized")
    if lost:
        fail(f"lines (b): LOST after initialization on frames {lost}")
    if res["on"]["ln_valid"] < 1:
        fail("lines (b): no valid map line at the end")
    if max(res["on"]["ln_inl"], default=0) < 1:
        fail("lines (b): no tracked frame had a line inlier")


def check_detect_on_card(frames, idx=DETECT_FRAMES):
    """(c): `detect_lines` on the card against the port on the CPU for three
    frames. The card's FMA contraction and atan2/cos differ from the CPU's
    by ulps, which the chain fit's covariance (two ~1e5 moments subtracted)
    turns into ~1e-2 px at the endpoints (0.004-0.025 px between the JAX
    program and the port on the CPU, tests/test_torch_lines.py), so: the
    segments longer than the length floor + DETECT_TIE_PX pair up one to
    one within DETECT_TOL_PX, and >= DETECT_BITS of their descriptor bits
    agree. A chain at the floor itself may fall on either side of it on
    either device."""
    from plslam_tpu_torch.ops import lines
    cpu = lines.LineDetector(HEIGHT, WIDTH)
    card = lines.LineDetector(HEIGHT, WIDTH).to(torch.device("cuda", 0))
    for i in idx:
        img = torch.from_numpy(frames[i].astype(np.uint8)).to(torch.float32)
        img_card = img.cuda()
        want = cpu(img)
        got = lines.LineFeatures(*(t.cpu() for t in card(img_card)))
        ms = cuda_ms(lambda: card(img_card), runs=5, batch=2)
        keep = lambda f: (f.valid & (f.length > card.min_length
                                     + DETECT_TIE_PX)).numpy()
        kt, kc = keep(got), keep(want)
        seg = lambda f, k: np.concatenate([f.uv_a.numpy(), f.uv_b.numpy()],
                                          1)[k]
        st, sc = seg(got, kt), seg(want, kc)
        if len(st) != len(sc) or not len(st):
            fail(f"lines (c), frame {i}: {len(st)} card segments above the "
                 f"floor, {len(sc)} on the CPU (valid {int(got.valid.sum())}"
                 f" / {int(want.valid.sum())})")
        d = np.abs(st[:, None] - sc[None]).max(-1)
        m = d.argmin(1)
        gap = float(d.min(1).max())
        if sorted(m) != list(range(len(sc))) or gap > DETECT_TOL_PX:
            fail(f"lines (c), frame {i}: card segments do not pair with the "
                 f"CPU's within {DETECT_TOL_PX} px (worst {gap:.4f} px)")
        bits = float((got.desc.numpy()[kt] != want.desc.numpy()[kc][m]
                      ).mean())
        if 1.0 - bits < DETECT_BITS:
            fail(f"lines (c), frame {i}: {100 * bits:.3f}% of descriptor "
                 f"bits differ")
        print(f"lines (c), frame {i}: {int(got.valid.sum())} / "
              f"{int(want.valid.sum())} valid (card / CPU), {len(st)} above "
              f"the floor pair up within {gap:.5f} px, {100 * bits:.3f}% "
              f"descriptor bits differ; detect_lines on the card "
              f"{ms:.3f} ms (device time)")


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

    t0 = time.perf_counter()
    Ts_sys, frames_sys = render_system_sequence()
    print(f"rendered the {SYSTEM_FRAMES}-frame system sequence in "
          f"{time.perf_counter() - t0:.1f} s")
    from plslam_tpu_torch.ops import extract
    extractor = extract.PointExtractor(extract.ExtractorConfig(), HEIGHT,
                                       WIDTH).to(device)
    f0, f2 = (extractor(torch.from_numpy(frames_sys[i].astype(np.uint8))
                        .to(device).to(torch.float32)) for i in (0, 2))
    timing = check_kernel(gm, device, match_frames_case(f0, f2))

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

    t0 = time.perf_counter()
    sys_out = run_system(frames_sys)
    print(f"system: {SYSTEM_FRAMES} frames in {time.perf_counter() - t0:.1f} s")
    check_system(Ts_sys, sys_out)
    if len(sys_out["real_calls"]) != len(TRACKING_SEARCHES) + 1:
        fail(f"recorded {len(sys_out['real_calls'])} of K1's real calls, "
             f"expected {len(TRACKING_SEARCHES) + 1}")
    for label, a, gated in sys_out["real_calls"]:
        n, p = a["q_bits"].shape[0], a["d_bits"].shape[0]
        timing[label] = check_case(gm, f"real call, {label}: N={n} P={p} "
                                   f"gated={gated}", a, gated)

    # the lines phase: (a) the defaults with lines on, (b) the lines-help
    # widths with lines on and off, (c) detect_lines on the card vs the CPU
    t0 = time.perf_counter()
    Ts_ln, frames_ln = render_lines_sequence()
    print(f"rendered the {LINES_FRAMES}-frame line-rich sequence in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lines_out = run_system(frames_ln, lines_config(), record_calls=False)
    print(f"lines (a): {LINES_FRAMES} frames in "
          f"{time.perf_counter() - t0:.1f} s")
    check_system(Ts_ln, lines_out, "lines (a)", min_lines=1)
    small = {}
    for use_lines in (True, False):
        t0 = time.perf_counter()
        small[use_lines] = run_system(frames_ln, lines_config(True, use_lines),
                                      record_calls=False)
        print(f"lines (b), lines {'on' if use_lines else 'off'}: "
              f"{LINES_FRAMES} frames in {time.perf_counter() - t0:.1f} s")
    check_lines_small(Ts_ln, small[True], small[False])
    check_detect_on_card(frames_ln)
    line_launches = lines_out["launches"] + sum(o["launches"]
                                                for o in small.values())
    print(f"K1 launches: slice {out['launches']}, system "
          f"{sys_out['launches']}, lines (a) {lines_out['launches']}, lines "
          f"(b) {small[True]['launches']} / {small[False]['launches']}")

    head = timing[(1024, 12288, True)]
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": [{
        "name": "gated_hamming_best2", "route": "cuda",
        "source": "plslam_tpu_torch/csrc/gated_hamming.cu",
        "replaces": "plslam_tpu/ops/pallas_match.py:115",
        "launches": out["launches"] + sys_out["launches"] + line_launches,
        "max_abs_err": max(c["err"] for c in timing.values()),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

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
   the renderer's camera and lines off (loop closing and map growth on). It
   checks initialization within the first 10 frames, no LOST frame after
   it, >= 3 keyframes, > 150 map points, an ATE after Sim3 alignment below
   5% of the span, and exactly 3 K1 launches per tracked frame plus one
   per initialization match (plus 2 per relocalization attempt and per
   Sim3 stage, in every phase); it prints per-stage host times (each stage
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
   against the port on the CPU for three frames (`check_detect_on_card`);
6. the relocalization phase: tests/test_reloc_e2e.py's kidnap (30 frames,
   `make_scene(seed=2)`, orbit) at the `SLAMConfig` defaults with that
   test's keyframe cadence: the last pose thrown far off after 20 frames,
   then relocalization; that test's bars (> 5 keyframes before the kidnap,
   a relocalization, OK at the end, ATE over frames >= 22 below 0.1 m),
   the host ms per attempt and K1's launch count;
7. the loop phase: tests/test_loop_closure_e2e.py's box circuit (110
   frames, rendered at fx 500, tracked at fx 512) at that test's widths
   (a) and at the defaults (b), loop closing and growth on: that test's
   bars (a long-range closure, a finished global BA, keyframe ATE after the
   correction and at the end below the ATE before it, the exported
   trajectory within 1.5 x + 0.05 of it) plus a growth event, host ms of
   detection, the Sim3 stage, the correction, search-and-fuse, global-BA
   rounds and the merge, and what the Sim3 stages' gates rejected; it runs
   under torch's deterministic algorithms. Then K1 on the first
   relocalization attempt's two calls and the first Sim3 stage's two
   (forward and reverse pairs), bit for bit and timed as in step 2;
8. the RGB-D phase: `System.track_rgbd` over tests/test_depth_sensors.py's
   RGB-D sequence (18 frames, `make_scene(seed=5)`, orbit of amplitude 1)
   at the `SLAMConfig` defaults (lines, loop closing and growth on), a
   monocular config that the first depth frame switches: every frame
   tracked, OK at the end, > 200 map points, metric ATE < 0.03 m (rigid
   alignment, no scale), K1's launch count;
9. the stereo phase: `System.track_stereo` over that file's stereo sequence
   (14 frames, `make_scene(seed=6)`, orbit of amplitude 0.8, the right view
   0.3 to the right) at the defaults with `sensor="stereo"`, baseline 0.3
   and th_depth 10.5: every frame tracked, > 150 points, metric ATE < 0.10
   m, K1's launch count; then tests/test_depth_sensors.py's depth check on
   frame 3 through the System's own `stereo_match` (>= 150 valid matches,
   median relative depth error < 0.6%, p90 < 2%, far-field p90 < 2%), and
   the device ms of one `stereo_match` call beside its Hamming product's.
   Both depth phases print per-stage host ms (extraction, the stereo search,
   tracking, the keyframe chain, local BA), counts, ATE and peak device
   memory.

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
RELOC_SEARCHES = ("relocalization ratio search (gates off)",
                  "relocalization widened search (gated)")
SIM3_SEARCHES = ("Sim3 pairs forward (gates off)",
                 "Sim3 pairs reverse (gates off)")
# the stages run_system times on the host clock
STAGES = ("extract", "lines", "stereo", "match", "two_view", "init_ba",
          "track",
          "keyframe", "create_lines", "local_ba", "young_gba", "reloc",
          "detect", "sim3", "correct", "search_fuse", "gba_step", "gba_merge",
          "grow")
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
# the relocalization phase: tests/test_reloc_e2e.py's kidnap at the defaults
RELOC_FRAMES = 30
RELOC_KIDNAP_AFTER = 20
RELOC_PINS = dict(kf_max_interval=2, kf_min_interval=1, kf_ref_ratio=2.0)
KIDNAP_XI = (1.5, -0.8, 2.0, 5.0, 4.0, -6.0)   # the kidnapped last pose
RELOC_ATE_FROM = 22
RELOC_ATE_MAX = 0.1
# the loop phase: tests/test_loop_closure_e2e.py's circuit
LOOP_FRAMES = 110
LOOP_PINS = dict(kf_max_interval=3, kf_min_interval=2, desc_pattern="gauss",
                 tri_covis=False)
LOOP_SMALL = dict(n_features=512, n_levels=3, max_kf=40, max_pt=8192,
                  max_ln=256, n_lf=64, ba_window=5, ba_points=1536)
# the depth phases: tests/test_depth_sensors.py's sequences and bars
RGBD_FRAMES, STEREO_FRAMES = 18, 14
STEREO_BASELINE = 0.3
DEPTH_BARS = {"rgbd": (200, 0.03), "stereo": (150, 0.10)}  # points, ATE m
STEREO_DEPTH_FRAME = 3
STEREO_DEPTH_BARS = dict(n=150, median=0.006, p90=0.02, far_p90=0.02)


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
    levels, 48 keyframes x 12288 points, an 8 x 3072 BA window, loop
    closing and map growth on) with the renderer's camera and lines off."""
    from plslam_tpu_torch.models.system import SLAMConfig
    return SLAMConfig(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2, k1=0, k2=0,
                      p1=0, p2=0, k3=0, use_lines=False)


def run_system(frames, cfg=None, record_calls=True, drive=None,
               track="track_monocular"):
    """`System.track_monocular` (or the entry point `track`, each frame a
    tuple of its image arguments) over the frames on cuda:0 at `cfg`
    (default `system_config()`). Each stage (extraction, line detection
    inside it, the stereo search,
    initialization match and two-view solve, tracking, the keyframe chain
    and the line triangulations and local BAs inside it, the local BA after
    initialization, relocalization, and with loop closing its detection,
    Sim3 stage, correction, search-and-fuse, global-BA rounds and merge, and
    growth) is wrapped to run between two device synchronizations and timed
    on the host clock; K1's launch count is set to 0 just before the run
    and read just after. With `record_calls`, K1's arguments are recorded on
    the initialization frame (its `match_frames` call) and on the first
    frame tracked after the first keyframe of the chain (its three
    searches); the first relocalization attempt's two calls and the first
    Sim3 stage's two are recorded always. `drive(slam, step)` runs the
    frames through `step(i)` (default: in order)."""
    from plslam_tpu_torch.mapstate import state as mstate
    from plslam_tpu_torch.models import loop_closing, mapping, tracking
    from plslam_tpu_torch.models.system import System
    from plslam_tpu_torch.ops import gated_match

    device = torch.device("cuda", 0)
    slam = System(cfg if cfg is not None else system_config(), device=device)
    times = {k: [] for k in STAGES}

    def timed(fn, name):
        def wrapper(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            times[name].append(time.perf_counter() - t0)
            return out
        return wrapper

    recorder = K1Recorder(gated_match)
    stage_calls, sim3_log = {}, []

    def recorded(fn, name):
        """Keeps K1's arguments of the first call of a stage."""
        def wrapper(*args, **kwargs):
            if name in stage_calls:
                return fn(*args, **kwargs)
            saved = recorder.on, recorder.calls
            recorder.on, recorder.calls = True, []
            try:
                return fn(*args, **kwargs)
            finally:
                stage_calls[name] = recorder.calls
                recorder.on, recorder.calls = saved
        return wrapper

    for attr, name in (("_extract", "extract"), ("_detect_lines", "lines"),
                       ("_stereo_match", "stereo"),
                       ("_match_frames", "match"),
                       ("_init_two_view", "two_view"),
                       ("_track_update", "track"),
                       ("_process_kf", "keyframe"), ("_local_ba", "init_ba"),
                       ("run_global_ba", "young_gba")):
        setattr(slam, attr, timed(getattr(slam, attr), name))
    slam._relocalize = recorded(timed(slam._relocalize, "reloc"), "reloc")
    step_gba = timed(slam._step_gba, "gba_step")
    slam._step_gba = lambda: None if slam._gba is None else step_gba()
    lc = slam.loop_closer
    if lc is not None:
        for attr, name in (("detect", "detect"), ("correct", "correct"),
                           ("_search_fuse", "search_fuse")):
            setattr(lc, attr, timed(getattr(lc, attr), name))
        stage = timed(lc._sim3_stage, "sim3")

        def logged(ms, k, c, *args, **kwargs):
            out = stage(ms, k, c, *args, **kwargs)
            n_matches, n_seed, S12, n_inl = out
            sim3_log.append((k, c, int(n_matches), int(n_seed), int(n_inl),
                             round(lc.drift_angle(ms, k, c, S12), 3)))
            return out
        lc._sim3_stage = recorded(logged, "sim3")
    # inside the chain (the initial map's lines go through slam._create_lines)
    patched = [(mapping, "run_local_ba", "local_ba"),
               (mapping, "create_new_lines", "create_lines"),
               (mapping, "gba_merge", "gba_merge"), (mstate, "grow", "grow")]
    originals = [getattr(m, a) for m, a, _ in patched]
    for m, a, name in patched:
        setattr(m, a, timed(getattr(m, a), name))
    tracking.gated_match = loop_closing.gated_match = recorder
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    init, states, real_calls, init_call = None, [], [], []

    def step(i):
        nonlocal init
        capture = record_calls and not real_calls and slam.n_kf_host > 2
        recorder.on = record_calls and (init is None or capture)
        recorder.calls = []
        args = frames[i] if isinstance(frames[i], tuple) else (frames[i],)
        getattr(slam, track)(*args, i / 30.0)
        recorder.on = False
        states.append(slam.state)
        if init is None and slam.state == "OK":
            init = i
            if record_calls:
                init_call.append((f"match_frames, init frame {i}",
                                  *recorder.calls[-1]))
        elif capture:
            if len(recorder.calls) != len(TRACKING_SEARCHES):
                fail(f"frame {i} made {len(recorder.calls)} K1 calls, "
                     f"expected {len(TRACKING_SEARCHES)}")
            real_calls.extend((f"{label}, frame {i}", *call) for label, call
                              in zip(TRACKING_SEARCHES, recorder.calls))

    gated_match.gated_hamming_best2.launches = 0
    try:
        if drive is None:
            for i in range(len(frames)):
                step(i)
        else:
            drive(slam, step)
        slam.flush()
    finally:
        for (m, a, _), fn in zip(patched, originals):
            setattr(m, a, fn)
        tracking.gated_match = loop_closing.gated_match = gated_match
    launches = gated_match.gated_hamming_best2.launches
    traj = dict(slam.trajectory)
    idx = [i for i in range(len(frames)) if i / 30.0 in traj]
    return dict(slam=slam, init=init, states=states, times=times,
                launches=launches, idx=idx, real_calls=real_calls + init_call,
                stage_calls=stage_calls, sim3_log=sim3_log,
                poses=np.stack([traj[i / 30.0] for i in idx]),
                peak=torch.cuda.max_memory_allocated(device))


def expected_launches(times) -> tuple:
    """(K1 launches a run must make, the formula): 3 per tracked frame, 1
    per initialization match, 2 per relocalization attempt and 2 per Sim3
    stage."""
    n = {k: len(times[k]) for k in ("track", "match", "reloc", "sim3")}
    return (3 * n["track"] + n["match"] + 2 * n["reloc"] + 2 * n["sim3"],
            f"3 x {n['track']} tracked frames + {n['match']} init matches "
            f"+ 2 x {n['reloc']} relocalization attempts + 2 x {n['sim3']} "
            f"Sim3 stages")


def print_stage_times(label, times):
    pct_ms = lambda x, q: 1e3 * float(np.percentile(x, q))
    for name in STAGES:
        x = times[name]
        if x and name not in ("match", "two_view", "init_ba"):
            print(f"{label}: {name} ms median {pct_ms(x, 50):.2f} p90 "
                  f"{pct_ms(x, 90):.2f} over {len(x)} calls")


def check_launches(label, out):
    expected, formula = expected_launches(out["times"])
    print(f"{label}: K1 launches {out['launches']} (expected {formula} = "
          f"{expected})")
    if out["launches"] != expected:
        fail(f"{label}: K1 launched {out['launches']} times, expected "
             f"{formula} = {expected}")


def check_system(Ts, out, label="system", min_lines=0):
    """The system phase's six checks (and, with `min_lines`, at least that
    many valid map lines at the end); returns the ATE and span."""
    from plslam_tpu_torch.datasets import synthetic
    slam, init, times = out["slam"], out["init"], out["times"]
    print_stage_times(label, times)
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
          f"{span:.3f} m span ({100 * ate / max(span, 1e-9):.2f}%), peak "
          f"device memory {out['peak'] / 2**20:.1f} MiB")
    check_launches(label, out)
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


def _np(x):
    """A tensor of either package as a numpy array."""
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def render_reloc_sequence(n_frames=RELOC_FRAMES):
    """The kidnap sequence of tests/test_reloc_e2e.py: `make_scene(seed=2)`
    along `trajectory(30, "orbit", amplitude=1.0)`, 640x480, fx = fy =
    500."""
    from plslam_tpu_torch.datasets import synthetic
    scene = synthetic.make_scene(seed=2)
    Ts = synthetic.trajectory(n_frames, "orbit", amplitude=1.0)
    return Ts, [synthetic.render(scene, T) for T in Ts]


def reloc_config():
    """The relocalization phase's `SLAMConfig`: the defaults (1024
    features, 8 levels, 48 x 12288 x 1024, lines, loop closing and growth
    on) with the renderer's camera and tests/test_reloc_e2e.py's cadence
    pins, which make every frame after initialization a keyframe."""
    from plslam_tpu_torch.models.system import SLAMConfig
    return SLAMConfig(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2, k1=0, k2=0,
                      p1=0, p2=0, k3=0, **RELOC_PINS)


def run_kidnap(slam, frames, Ts, kidnap, step=None):
    """tests/test_reloc_e2e.py's kidnap on either package's `System`: track
    RELOC_KIDNAP_AFTER frames, flush, `kidnap(slam)` (the test's identity
    velocity and far-off last pose), track the rest, each frame through
    `step(i)` (default: `track_monocular`). Returns the keyframes before the
    kidnap, the relocalizations (frame, inliers, anchor keyframe), the final
    state and the Sim3-aligned ATE over the frames from RELOC_ATE_FROM
    on."""
    from plslam_tpu_torch.datasets import synthetic
    if step is None:
        step = lambda i: slam.track_monocular(frames[i], i / 30.0)
    for i in range(RELOC_KIDNAP_AFTER):
        step(i)
    slam.flush()
    n_kf_before, state_before = slam.n_kf_host, slam.state
    kidnap(slam)
    relocs = []
    for i in range(RELOC_KIDNAP_AFTER, len(frames)):
        step(i)
        if slam.stats and slam.stats[-1].get("reloc"):
            relocs.append((i, slam.stats[-1]["inliers"], slam._anchor_kf))
    est = {ts: _np(T) for ts, T in slam.trajectory}
    idx = [i for i in range(len(frames))
           if i / 30.0 in est and i >= RELOC_ATE_FROM]
    ate = synthetic.ate_rmse(np.stack([est[i / 30.0] for i in idx]),
                             Ts[idx]) if len(idx) >= 3 else float("nan")
    return dict(n_kf_before=n_kf_before, state_before=state_before,
                relocs=relocs, state=slam.state, ate=ate, poses=len(idx),
                kf=slam.n_keyframes(), pts=slam.n_map_points())


def reloc_failures(r) -> list:
    """tests/test_reloc_e2e.py's bars on `run_kidnap`'s result."""
    bad = []
    if r["state_before"] != "OK" or r["n_kf_before"] <= 5:
        bad.append(f"{r['n_kf_before']} keyframes (state "
                   f"{r['state_before']}) before the kidnap, need > 5")
    if not r["relocs"]:
        bad.append("relocalization never fired")
    if r["state"] != "OK":
        bad.append(f"state {r['state']} at the end")
    if not r["ate"] < RELOC_ATE_MAX:
        bad.append(f"ATE {r['ate']:.4f} over frames >= {RELOC_ATE_FROM} "
                   f"(>= {RELOC_ATE_MAX})")
    return bad


def render_loop_sequence(n_frames=LOOP_FRAMES):
    """The circuit of tests/test_loop_closure_e2e.py: a 360-degree circle of
    radius 2 inside `make_scene(seed=7, layout="box")`, rendered at fx =
    500 (and tracked at fx = 512, a 2.4% focal error)."""
    from plslam_tpu_torch.datasets import synthetic
    scene = synthetic.make_scene(seed=7, layout="box")
    Ts = synthetic.trajectory(n_frames, "circle", amplitude=2.0)
    return Ts, [synthetic.render(scene, T) for T in Ts]


def loop_config(small: bool = True):
    """The loop phase's `SLAMConfig`: tests/test_loop_closure_e2e.py's
    widths (a), or with `small=False` the defaults (b), with that test's
    camera (fx 512) and pins; loop closing and growth on."""
    from plslam_tpu_torch.models.system import SLAMConfig
    return SLAMConfig(fx=512.0, fy=512.0, cx=WIDTH / 2, cy=HEIGHT / 2, k1=0,
                      k2=0, p1=0, p2=0, k3=0, **LOOP_PINS,
                      **(LOOP_SMALL if small else {}))


def loop_metrics(slam, Ts) -> dict:
    """The loop circuit's numbers on either package's flushed `System`:
    loops, the last closure, global-BA rounds, growth events and the
    keyframe ATEs of tests/test_loop_closure_e2e.py (before the correction,
    right after it, at the end, over the keyframes that existed at the
    closure) and of the exported trajectory."""
    from plslam_tpu_torch.datasets import synthetic
    lc = slam.loop_closer
    n_kf = slam.n_kf_host
    fid = _np(slam.ms.kf_frame_id)[:n_kf]
    kf_T = _np(slam.ms.kf_T)[:n_kf]
    est = {ts: _np(T) for ts, T in slam.trajectory}
    idx = [i for i in range(len(Ts)) if i / 30.0 in est]
    out = dict(n_loops=lc.n_loops, closure=lc.last_closure,
               n_gba=slam.n_gba_done, n_growths=slam.n_growths, kf=n_kf,
               pts=slam.n_map_points(), max_kf=slam.map_cfg.max_kf,
               max_pt=slam.map_cfg.max_pt,
               lost=sum(1 for s in slam.stats if s.get("lost")),
               ate_kf=synthetic.ate_rmse(kf_T, Ts[fid]),
               ate_traj=synthetic.ate_rmse(
                   np.stack([est[i / 30.0] for i in idx]), Ts[idx]),
               ate_pre=None, ate_corr=None, ate_final=None)
    if lc.n_loops:
        k, _ = lc.last_closure
        n_pre = min(k + 1, n_kf)
        gt = Ts[fid][:n_pre]
        out.update(ate_pre=synthetic.ate_rmse(lc.pre_correction_kf_T[:n_pre],
                                              gt),
                   ate_corr=synthetic.ate_rmse(
                       lc.post_correction_kf_T[:n_pre], gt),
                   ate_final=synthetic.ate_rmse(kf_T[:n_pre], gt))
    return out


def loop_failures(m) -> list:
    """tests/test_loop_closure_e2e.py's bars (plus a growth event) on
    `loop_metrics`' result."""
    bad = []
    if m["n_loops"] < 1:
        return ["no loop closure fired"]
    k, c = m["closure"]
    if k - c < 15:
        bad.append(f"closure ({k}, {c}) is not a long-range loop")
    if m["n_gba"] < 1:
        bad.append("global BA never completed")
    if not m["ate_corr"] < m["ate_pre"]:
        bad.append(f"corrected keyframe ATE {m['ate_corr']:.4f} >= "
                   f"{m['ate_pre']:.4f} before the closure")
    if not m["ate_final"] < m["ate_pre"]:
        bad.append(f"final keyframe ATE {m['ate_final']:.4f} >= "
                   f"{m['ate_pre']:.4f} before the closure")
    if not m["ate_traj"] < 1.5 * m["ate_final"] + 0.05:
        bad.append(f"trajectory ATE {m['ate_traj']:.4f} >= 1.5 x "
                   f"{m['ate_final']:.4f} + 0.05")
    if m["n_growths"] < 1:
        bad.append("the map never grew")
    return bad


def format_loop(m) -> str:
    f = lambda x: "n/a" if x is None else f"{x:.4f}"
    return (f"{m['n_loops']} loop(s), last closure {m['closure']}, "
            f"{m['n_gba']} global BA(s) done, {m['n_growths']} growth "
            f"event(s) (capacity {m['max_kf']} x {m['max_pt']}), "
            f"{m['kf']} keyframes, {m['pts']} points, {m['lost']} LOST "
            f"frames; keyframe ATE before the closure {f(m['ate_pre'])}, "
            f"after the correction {f(m['ate_corr'])}, at the end "
            f"{f(m['ate_final'])}; all keyframes {f(m['ate_kf'])}; "
            f"trajectory {f(m['ate_traj'])}")


def check_reloc(out, r):
    """The relocalization phase: tests/test_reloc_e2e.py's bars, the
    relocalizations (frame, inliers, anchor keyframe), host ms per attempt
    and K1's launch count."""
    print_stage_times("reloc", out["times"])
    x = out["times"]["reloc"]
    print(f"reloc: {r['n_kf_before']} keyframes before the kidnap; "
          f"relocalizations (frame, inliers, anchor keyframe) {r['relocs']}; "
          f"{len(x)} attempts, host ms per attempt "
          f"{[round(1e3 * t, 2) for t in x]}; state {r['state']} at the end, "
          f"{r['kf']} keyframes, {r['pts']} points; ATE over frames >= "
          f"{RELOC_ATE_FROM} {r['ate']:.4f} m over {r['poses']} poses")
    check_launches("reloc", out)
    bad = reloc_failures(r)
    if bad:
        fail("reloc: " + "; ".join(bad))


def check_loop(label, Ts, out) -> list:
    """A loop phase: its counts and ATEs, the stage host times, what the
    Sim3 stages' gates rejected, and K1's launch count; returns what fails
    tests/test_loop_closure_e2e.py's bars plus a growth event."""
    m = loop_metrics(out["slam"], Ts)
    print(f"{label}: {format_loop(m)}")
    print_stage_times(label, out["times"])
    log = out["sim3_log"]
    gates = [sum(1 for r in log if r[3] < 12),
             sum(1 for r in log if r[3] >= 12 and r[4] < 20),
             sum(1 for r in log if r[3] >= 12 and r[4] >= 20 and r[2] < 40)]
    drift = sum(1 for r in log if r[3] >= 12 and r[4] >= 20 and r[2] >= 40
                and r[5] > out["slam"].cfg.loop_max_drift_rot)
    print(f"{label}: {len(log)} Sim3 stages: {gates[0]} under the 12-inlier "
          f"RANSAC floor, then {gates[1]} under 20 LM inliers, {gates[2]} "
          f"under 40 matches, {drift} past the drift gate, "
          f"{len(log) - sum(gates) - drift} accepted; the 5 with the most LM "
          f"inliers as (keyframe, candidate, matches, RANSAC inliers, LM "
          f"inliers, drift rad): "
          f"{sorted(log, key=lambda r: (-r[4], -r[2]))[:5]}")
    check_launches(label, out)
    return loop_failures(m)


def render_rgbd_sequence(n_frames=RGBD_FRAMES):
    """tests/test_depth_sensors.py's RGB-D sequence: `make_scene(seed=5)`
    along `trajectory(18, "orbit", amplitude=1.0)`, 640x480, fx = fy = 500;
    each frame (image, metric depth)."""
    from plslam_tpu_torch.datasets import synthetic
    scene = synthetic.make_scene(seed=5)
    Ts = synthetic.trajectory(n_frames, "orbit", amplitude=1.0)
    return Ts, [synthetic.render_rgbd(scene, T) for T in Ts]


def render_stereo_sequence(n_frames=STEREO_FRAMES):
    """tests/test_depth_sensors.py's stereo sequence: `make_scene(seed=6)`
    along `trajectory(14, "orbit", amplitude=0.8)`, each frame (left,
    right) with the right camera STEREO_BASELINE to the right; and the
    left depth of frame STEREO_DEPTH_FRAME."""
    from plslam_tpu_torch.datasets import synthetic
    scene = synthetic.make_scene(seed=6)
    Ts = synthetic.trajectory(n_frames, "orbit", amplitude=0.8)
    T_rl = np.eye(4, dtype=np.float32)
    T_rl[0, 3] = -STEREO_BASELINE
    frames = [(synthetic.render(scene, T), synthetic.render(scene, T_rl @ T))
              for T in Ts]
    return Ts, frames, synthetic.render_rgbd(scene,
                                             Ts[STEREO_DEPTH_FRAME])[1]


def depth_config(kind: str):
    """The depth phases' `SLAMConfig`: the defaults (1024 features, 8
    levels, 48 x 12288 x 1024, lines, loop closing and growth on) with the
    renderer's camera; RGB-D on the default monocular config (the first
    depth frame switches it), stereo with `sensor="stereo"`, baseline 0.3
    and th_depth 35 x baseline (tests/test_depth_sensors.py's)."""
    from plslam_tpu_torch.models.system import SLAMConfig
    extra = {} if kind == "rgbd" else dict(
        sensor="stereo", baseline=STEREO_BASELINE,
        th_depth=35 * STEREO_BASELINE)
    return SLAMConfig(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2, k1=0, k2=0,
                      p1=0, p2=0, k3=0, **extra)


def check_depth(kind, Ts, out):
    """A depth phase: tests/test_depth_sensors.py's bars (every frame
    tracked, OK at the end, the point floor, metric ATE with a rigid
    alignment) and K1's launch count; prints the stage times and counts."""
    from plslam_tpu_torch.datasets import synthetic
    slam, idx = out["slam"], out["idx"]
    print_stage_times(kind, out["times"])
    ate = synthetic.ate_rmse(out["poses"], Ts[idx], align_scale=False) \
        if len(idx) >= 3 else float("nan")
    not_ok = [i for i, s in enumerate(out["states"]) if s != "OK"]
    print(f"{kind}: init frame {out['init']}, {len(out['times']['track'])} "
          f"frames tracked, {len(idx)} poses, {slam.n_keyframes()} keyframes, "
          f"{slam.n_map_points()} map points, {int(slam.ms.n_ln)} map lines, "
          f"metric ATE {ate:.4f} m, state {slam.state}, sensor "
          f"{slam.cfg.sensor}, loops {slam.loop_closer.n_loops}, global BAs "
          f"{slam.n_gba_done}, growth events {slam.n_growths}, peak device "
          f"memory {out['peak'] / 2**20:.1f} MiB")
    check_launches(kind, out)
    min_points, max_ate = DEPTH_BARS[kind]
    bad = []
    if out["init"] != 0 or not_ok or len(idx) != len(Ts):
        bad.append(f"init frame {out['init']}, frames not OK {not_ok}, "
                   f"{len(idx)} of {len(Ts)} poses")
    if slam.state != "OK":
        bad.append(f"state {slam.state} at the end")
    if slam.n_map_points() <= min_points:
        bad.append(f"{slam.n_map_points()} map points (<= {min_points})")
    if not ate < max_ate:
        bad.append(f"metric ATE {ate:.4f} m (>= {max_ate})")
    if bad:
        fail(f"{kind}: " + "; ".join(bad))
    return ate


def check_stereo_depth(slam, frame, dep_gt):
    """tests/test_depth_sensors.py's depth check on one stereo pair through
    the System's own extraction and `stereo_match` (at the System's
    widths); then the device ms of one `stereo_match` call and of its
    Hamming product alone (`hamming.distance_matrix`)."""
    from functools import partial
    from plslam_tpu_torch.ops import hamming, stereo
    im_l, im_r = (slam._image(im) for im in frame)
    fl, fr = slam.extractor(im_l), slam.extractor(im_r)
    match = partial(stereo.stereo_match, fx=float(slam.cfg.fx),
                    baseline=slam.cfg.baseline,
                    scale_factors=slam.scale_factors)
    depth, _, ok = match(fl, fr, im_l, im_r)
    ok = ok.cpu().numpy()
    uv, d = fl.uv.cpu().numpy()[ok], depth.cpu().numpy()[ok]
    d_gt = dep_gt[np.clip(np.round(uv[:, 1]).astype(int), 0, HEIGHT - 1),
                  np.clip(np.round(uv[:, 0]).astype(int), 0, WIDTH - 1)]
    valid = d_gt > 0
    rel = np.abs(d[valid] - d_gt[valid]) / d_gt[valid]
    far = d_gt[valid] > np.median(d_gt[valid])
    got = dict(n=int(valid.sum()), median=float(np.median(rel)),
               p90=float(np.percentile(rel, 90)),
               far_p90=float(np.percentile(rel[far], 90)))
    # one call per batch: a call queues ~250 small kernels, and the host
    # blocks once ~1000 launches are pending behind the spin kernel
    ms = cuda_ms(lambda: match(fl, fr, im_l, im_r), batch=1)
    ms_ham = cuda_ms(lambda: hamming.distance_matrix(fl.desc, fr.desc))
    print(f"stereo depth, frame {STEREO_DEPTH_FRAME}: {got['n']} valid "
          f"matches of {fl.valid.sum().item()} keypoints, relative depth "
          f"error median {100 * got['median']:.3f}%, p90 "
          f"{100 * got['p90']:.3f}%, far-field p90 "
          f"{100 * got['far_p90']:.3f}%; stereo_match "
          f"{ms:.4f} ms device per call, its Hamming product "
          f"{fl.desc.shape[0]} x {fr.desc.shape[0]} {ms_ham:.4f} ms")
    b = STEREO_DEPTH_BARS
    if not (got["n"] >= b["n"] and got["median"] < b["median"]
            and got["p90"] < b["p90"] and got["far_p90"] < b["far_p90"]):
        fail(f"stereo depth, frame {STEREO_DEPTH_FRAME}: {got} misses the "
             f"bars {b}")
    return dict(got, ms=ms, ms_hamming=ms_ham)


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

    # the relocalization phase: tests/test_reloc_e2e.py's kidnap at the
    # defaults
    t0 = time.perf_counter()
    Ts_rl, frames_rl = render_reloc_sequence()
    print(f"rendered the {RELOC_FRAMES}-frame kidnap sequence in "
          f"{time.perf_counter() - t0:.1f} s")
    reloc = {}

    def kidnap(slam):
        from plslam_tpu_torch.geometry import se3
        slam.velocity = torch.eye(4, device=device)
        slam.T_last = se3.se3_exp(torch.tensor(KIDNAP_XI, device=device))

    t0 = time.perf_counter()
    rl_out = run_system(frames_rl, reloc_config(), record_calls=False,
                        drive=lambda slam, step: reloc.update(run_kidnap(
                            slam, frames_rl, Ts_rl, kidnap, step)))
    print(f"reloc: {RELOC_FRAMES} frames in {time.perf_counter() - t0:.1f} s")
    check_reloc(rl_out, reloc)

    # the depth phases: tests/test_depth_sensors.py's RGB-D and stereo runs
    # at the defaults
    depth_out = {}
    for kind, render in (("rgbd", render_rgbd_sequence),
                         ("stereo", render_stereo_sequence)):
        t0 = time.perf_counter()
        Ts_d, frames_d, *dep = render()
        print(f"rendered the {len(Ts_d)}-frame {kind} sequence in "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        depth_out[kind] = run_system(frames_d, depth_config(kind),
                                     record_calls=False,
                                     track=f"track_{kind}")
        print(f"{kind}: {len(Ts_d)} frames in "
              f"{time.perf_counter() - t0:.1f} s")
        check_depth(kind, Ts_d, depth_out[kind])
        if kind == "stereo":
            check_stereo_depth(depth_out[kind]["slam"],
                               frames_d[STEREO_DEPTH_FRAME], dep[0])

    # the loop phase: tests/test_loop_closure_e2e.py's circuit at its widths
    # (a) and at the defaults (b)
    t0 = time.perf_counter()
    Ts_lp, frames_lp = render_loop_sequence()
    print(f"rendered the {LOOP_FRAMES}-frame circuit in "
          f"{time.perf_counter() - t0:.1f} s")
    # whether the circuit closes at the defaults turns on which candidates
    # become consistent, and the order of float atomics (BA's index_add_)
    # moves the trajectory from run to run: 9 of 10 runs closed (PERF.md).
    # The loop phase runs torch's deterministic algorithms, so it repeats.
    loops, loop_bad = {}, []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, small_widths in (("loop (a)", True), ("loop (b)", False)):
            t0 = time.perf_counter()
            loops[name] = run_system(frames_lp, loop_config(small_widths),
                                     record_calls=False)
            print(f"{name}: {LOOP_FRAMES} frames in "
                  f"{time.perf_counter() - t0:.1f} s")
            loop_bad += [f"{name}: {b}"
                         for b in check_loop(name, Ts_lp, loops[name])]
    finally:
        torch.use_deterministic_algorithms(False)

    # K1 on the calls of the new stages: the first relocalization attempt,
    # the first Sim3 stage at the default widths (else at (a)'s)
    sim3_run = loops["loop (b)"] if "sim3" in loops["loop (b)"][
        "stage_calls"] else loops["loop (a)"]
    new_calls = list(zip(RELOC_SEARCHES, rl_out["stage_calls"]["reloc"])) \
        + list(zip(SIM3_SEARCHES, sim3_run["stage_calls"]["sim3"]))
    if len(new_calls) != 4 or len(sim3_run["stage_calls"]["sim3"]) != 2:
        fail(f"recorded {len(new_calls)} K1 calls of the relocalization "
             f"and Sim3 stages, expected 4")
    for label, (a, gated) in new_calls:
        n, p = a["q_bits"].shape[0], a["d_bits"].shape[0]
        timing[label] = check_case(gm, f"real call, {label}: N={n} P={p} "
                                   f"gated={gated}", a, gated)
    if loop_bad:
        fail("; ".join(loop_bad))
    new_launches = rl_out["launches"] + sum(o["launches"]
                                            for o in loops.values()) \
        + sum(o["launches"] for o in depth_out.values())
    print(f"K1 launches: slice {out['launches']}, system "
          f"{sys_out['launches']}, lines (a) {lines_out['launches']}, lines "
          f"(b) {small[True]['launches']} / {small[False]['launches']}, "
          f"reloc {rl_out['launches']}, loop (a) "
          f"{loops['loop (a)']['launches']}, loop (b) "
          f"{loops['loop (b)']['launches']}, rgbd "
          f"{depth_out['rgbd']['launches']}, stereo "
          f"{depth_out['stereo']['launches']}")

    head = timing[(1024, 12288, True)]
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": [{
        "name": "gated_hamming_best2", "route": "cuda",
        "source": "plslam_tpu_torch/csrc/gated_hamming.cu",
        "replaces": "plslam_tpu/ops/pallas_match.py:115",
        "launches": out["launches"] + sys_out["launches"] + line_launches
        + new_launches,
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

#!/usr/bin/env python3
"""Smoke run of the PyTorch / CUDA port (`plslam_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Every phase runs the per-frame steps as CUDA graphs (`models/step_graph`)
except the system phase and the dispatch phase's eager run, which record
K1's real calls eagerly (a capture fills no buffer); a graphed phase times
line detection as part of extraction.

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
   undistortion -> local-map tracking on frames 1-47 (one graph each), with
   a depth keyframe every 8th frame. It checks >= 30 inliers per frame, an
   ATE below 5% of the path length (no alignment: the map is metric and
   frame 0 is the origin), and that every search of the step went through
   K1 (3 per frame);
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
4b. the dispatch phase: the system sequence at `bench.py`'s configuration
   (1024 features, 8 levels, 32 keyframes x 8192 points, a 6 x 2048 BA
   window, kf_max_interval 6, growth off, lines and loop closing on) five
   times: `track_monocular` eager and graphed, `track_synced`,
   `track_chunked` in chunks of 6 and `async_pipeline` at depth 4, each
   with step 4's checks and K1's count (3 launches per tracked frame,
   replayed or not); per run the host ms per frame (median, p90; the
   latency paths synchronize after every call), frames/s after
   initialization and the graphs' captures and replays. The eager run
   records K1's real calls at this configuration's map (the init match and
   the first frame tracked after the chain's first keyframe) and checks and
   times K1 on them as in step 2. Then the tracking
   graph against the eager step on the same inputs, with a re-capture after
   a growth event, and one graphed chunk against an eager one from one
   state, at ROADMAP item 7's bars (T within 1e-4, inliers within 2,
   `matched_pt` >= 99% equal);
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
   memory;
10. the map I/O check: the system phase's map through `System.save_map`
   into a fresh System's `load_map`, every field bit-equal, and 4 more
   frames (the sequence's last 4, backwards) tracked by both Systems from
   the same tracking state, poses within 1e-4;
11. the multistream phase: 16 streams at the TUM fr1 defaults (640x480,
   1024 features, 8 levels, 48 keyframes x 12288 points, lines on), stream
   s rendering `make_scene(seed=100 + s)` along the slice's orbit (rendered
   in worker processes), each bootstrapped with a keyframe and points from
   frame 0's rendered depth (a metric map), then 24 lockstep frames through
   `parallel.multistream.BatchedTracker` (graphed, `kf_interval` 5, the
   first frame a keyframe step), K1 one batched launch per search. It
   checks each stream's ATE < 0.05 m (rigid alignment) and >= 30 inliers
   per stream and frame; over the first 8 frames each stream against the
   same stream alone through the unbatched graphed step: poses within 1e-4
   on the first frame (one optimization from the same inputs) and within
   1e-3 over the 8, at S = 16 and at S = 4, inliers within 2, and the
   vmapped step at S = 1 bit-equal to the unbatched one (the batched
   kernels sum floats in another order only at S > 1). As the witness of
   the float32 noise floor it tracks each stream alone again from a first
   pose moved 1e-6 m and prints that gap beside the batched one, with the
   frame at which each run's integer scalars first part; 16 identical
   streams under deterministic algorithms
   (equal integer scalars, poses within 1e-4); the eager batched step
   against the graphed one, bit for bit, over the first 7 frames; the
   batched K1 bit-equal to 16 single launches and to the batched plain
   version at (16, 1024, 12288) and on the eager step's three real batched
   calls, each timed against 16 single launches and the batched plain
   version beside its bound. It prints the lockstep step ms (median, p90)
   and frames/s per card at S = 1, 4 and 16 (frames 2-11 of each run,
   after the two captures), peak device memory, captures and replays; then
   `RoundRobinTracker` at S = 4, B = 6 over the same frames: its frames/s,
   each stream's ATE and no capture after the first chunk.

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
          "track", "frame",
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
DISPATCH_CHUNK = 6
DISPATCH_RUNS = (  # label, entry point, graphed, SLAMConfig overrides
    ("monocular eager", "track_monocular", False, {}),
    ("monocular graphed", "track_monocular", True, {}),
    ("synced", "track_synced", True, {}),
    (f"chunked B={DISPATCH_CHUNK}", "track_chunked", True, {}),
    ("async depth 4", "track_monocular", True,
     dict(async_pipeline=True, async_depth=4)))
GRAPH_T_TOL, GRAPH_INLIERS, GRAPH_MATCHED = 1e-4, 2, 0.99   # item 7's bars
MAP_IO_FRAMES = 4
MS_STREAMS, MS_FRAMES, MS_KF_INTERVAL = 16, 24, 5
MS_TIMED = (2, 12)        # lockstep frames timed in every S run
MS_SIZES = (1, 4, 16)
MS_ALONE_FRAMES, MS_EAGER_FRAMES = 8, 7
MS_ATE = 0.05             # m, tests/test_multistream.py's bar
# the unbatched step against the batched one: one optimization from the
# same inputs (frame 1) within 1e-4, the 8 frames within 1e-3, inliers
# within 2. Readings (H100, call 10): 8-frame gaps of 20 stream runs
# (S = 16 and 4) 2.5e-5 to 7.3e-4; the unbatched step against itself from
# a first pose moved MS_MOVED: up to 2.1e-3, the float32 noise floor of 8
# tracked frames, so the 8-frame bar cannot be tighter than ~1e-3
MS_T_TOL, MS_T_TOL_SEQ, MS_INLIERS = 1e-4, 1e-3, 2
MS_MOVED = 1e-6           # m, the witness's move of the first pose
RR_STREAMS, RR_CHUNK = 4, 6


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


def run_slice(frames_np, depths_np, after_frame=lambda i: None,
              use_graphs=True):
    """The port's per-frame step on the card at the repo's configuration
    (1024 features, 8 levels, a 12288-point map): a depth bootstrap on frame
    0, then extraction -> undistortion -> tracking on every later frame, with
    a depth keyframe every KF_EVERY frames. Extraction and tracking are one
    CUDA graph each (`models/step_graph`) unless `use_graphs` is False. Each
    stage runs under a `record_function` label (extract, track, keyframe)
    and is timed on the host clock up to a device synchronization;
    `after_frame(i)` is called once frame i is done."""
    from torch.profiler import record_function
    from plslam_tpu_torch.geometry import camera
    from plslam_tpu_torch.mapstate import state as mstate
    from plslam_tpu_torch.models import mapping, step_graph, tracking
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
    graphs = step_graph.StepGraphs(device, enabled=use_graphs)

    def extract_impl(img):
        f = extractor(img.to(torch.float32))
        return f._replace(uv_un=camera.undistort_pixels(cam, f.uv))

    def track_impl(ms, f, T, vel):
        return tracking.track_local_map(
            cam, ms, f, T, sf, s2, n_levels=cfg.n_levels, scale=cfg.scale,
            velocity=vel, update_stats=True)[0]
    extract_step = graphs.step(extract_impl)
    track_step = graphs.step(track_impl, bound=0)

    def features(i):
        with record_function("extract"):
            return extract_step(frames[i])

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
            res = track_step(ms, f, T, vel)
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
                captures=graphs.captures, replays=graphs.replays,
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
               track="track_monocular", use_graphs=None, stage_times=True):
    """`System.track_monocular` (or the entry point `track`, each frame a
    tuple of its image arguments) over the frames on cuda:0 at `cfg`
    (default `system_config()`), its per-frame steps graphed unless
    `use_graphs` is False (default: graphed unless `record_calls`: K1's
    arguments are recorded from eager calls, a capture fills no buffer).
    Each stage (extraction, line detection inside it when eager, the
    stereo search, initialization match and two-view solve, tracking, the
    graphed extraction-and-tracking frame step, the keyframe chain and the
    line triangulations and local BAs inside it, the local BA after
    initialization, relocalization, and with loop closing its detection,
    Sim3 stage, correction, search-and-fuse, global-BA rounds and merge, and
    growth) is wrapped to run between two device synchronizations and timed
    on the host clock (with `stage_times` False only counted, with no
    synchronization); K1's launch count is set to 0 just before the run
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
    if use_graphs is None:
        use_graphs = not record_calls
    slam = System(cfg if cfg is not None else system_config(), device=device,
                  use_graphs=use_graphs)
    times = {k: [] for k in STAGES}

    def timed(fn, name):
        def wrapper(*args, **kwargs):
            if not stage_times:
                times[name].append(None)
                return fn(*args, **kwargs)
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

    # line detection runs inside the extraction graph: no synchronization
    # may go there
    for attr, name in (("_extract", "extract"), ("_detect_lines", "lines"),
                       ("_stereo_match", "stereo"),
                       ("_match_frames", "match"),
                       ("_init_two_view", "two_view"),
                       ("_track_update", "track"), ("_frame_step", "frame"),
                       ("_process_kf", "keyframe"), ("_local_ba", "init_ba"),
                       ("run_global_ba", "young_gba")):
        if name != "lines" or not use_graphs:
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
                captures=slam.graphs.captures, replays=slam.graphs.replays,
                stage_calls=stage_calls, sim3_log=sim3_log,
                poses=np.stack([traj[i / 30.0] for i in idx]),
                peak=torch.cuda.max_memory_allocated(device))


def expected_launches(times) -> tuple:
    """(K1 launches a run must make, the formula): 3 per tracked frame (a
    tracking step or an extraction-and-tracking frame step), 1 per
    initialization match, 2 per relocalization attempt and 2 per Sim3
    stage."""
    n = {k: len(times[k]) for k in ("track", "frame", "match", "reloc",
                                    "sim3")}
    n_track = n["track"] + n["frame"]
    return (3 * n_track + n["match"] + 2 * n["reloc"] + 2 * n["sim3"],
            f"3 x {n_track} tracked frames + {n['match']} init matches "
            f"+ 2 x {n['reloc']} relocalization attempts + 2 x {n['sim3']} "
            f"Sim3 stages")


def print_stage_times(label, times):
    pct_ms = lambda x, q: 1e3 * float(np.percentile(x, q))
    for name in STAGES:
        x = [t for t in times[name] if t is not None]
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
    if init is not None and times["init_ba"] and None not in times["match"]:
        tv = times["two_view"]
        print(f"{label}: init on frame {init}: "
              f"{1e3 * slam.timings[init]:.2f} ms, of which match "
              f"{1e3 * times['match'][-1]:.2f} ms, two-view "
              f"{1e3 * tv[-1]:.2f} ms, initial local BA "
              f"{1e3 * times['init_ba'][0]:.2f} ms; {len(times['match'])} "
              f"match and {len(tv)} two-view attempts in all, the first "
              f"two-view {1e3 * tv[0]:.2f} ms")
    n_track = len(times["track"]) + len(times["frame"])
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


def dispatch_config(**overrides):
    """bench.py's `SLAMConfig` (1024 features, 8 levels, 32 keyframes x 8192
    points, a 6 x 2048 BA window, kf_max_interval 6, growth off; lines and
    loop closing on, as by default) with the renderer's camera."""
    from plslam_tpu_torch.models.system import SLAMConfig
    return SLAMConfig(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2, k1=0, k2=0,
                      p1=0, p2=0, k3=0, n_features=1024, n_levels=8,
                      max_kf=32, max_pt=8192, ba_window=6, ba_points=2048,
                      kf_max_interval=6, grow_map=False, **overrides)


def clone_map(ms):
    """A copy of a `MapState` in fresh tensors."""
    import dataclasses
    return dataclasses.replace(ms, **{f.name: getattr(ms, f.name).clone()
                                      for f in dataclasses.fields(ms)})


def copy_state(dst, src):
    """`src` System's map (a copy) and tracking state into System `dst`."""
    dst.ms = clone_map(src.ms)
    for name in ("state", "frame_id", "n_kf_host", "last_kf_frame",
                 "last_reloc_frame", "ref_kf_matches", "_occupancy",
                 "map_cfg"):
        setattr(dst, name, getattr(src, name))
    dst.T_last, dst.velocity = src.T_last.clone(), src.velocity.clone()
    dst.kf_timestamps = list(src.kf_timestamps)
    dst._traj = list(src._traj)


def _track_gaps(a, b) -> dict:
    """Item 7's quantities between two TrackResults: the pose gap, the
    inlier difference and the share of equal `matched_pt` entries."""
    return dict(T=float((a.T - b.T).abs().max()),
                inliers=abs(int(a.n_inliers) - int(b.n_inliers)),
                matched=float((a.matched_pt == b.matched_pt).float().mean()))


def _graph_failures(label, gaps) -> list:
    return [f"{label}: {name} {gaps[name]} beyond {bar}"
            for name, bar, bad in (
                ("T", GRAPH_T_TOL, gaps["T"] > GRAPH_T_TOL),
                ("inliers", GRAPH_INLIERS, gaps["inliers"] > GRAPH_INLIERS),
                ("matched", GRAPH_MATCHED, gaps["matched"] < GRAPH_MATCHED))
            if bad]


def check_graphed_step(frames, cfg, n_cmp=4) -> dict:
    """The tracking graph against the eager tracking step on the same
    inputs, at ROADMAP item 7's bars (T within 1e-4, inliers within 2,
    `matched_pt` >= 99% equal): an eager System tracks until two frames
    after its initialization; on each of the next `n_cmp` frames both steps
    run from its pose and velocity on the frame's features, each on its own
    copy of its map, before the System tracks the frame itself. The graph
    captures on the first (returning its eager warm-up's result) and
    replays on the others. Then the map grows (capacities doubled) and the
    step, its graph's pointers stale, captures anew on the grown copies for
    one more frame. Returns the worst gaps and the captures and replays;
    fails on a bar."""
    from plslam_tpu_torch.mapstate import state as mstate
    from plslam_tpu_torch.models import step_graph
    from plslam_tpu_torch.models.system import System

    device = torch.device("cuda", 0)
    slam = System(cfg, device=device, use_graphs=False)
    i, after = 0, 0
    while after < 2:
        slam.track_monocular(frames[i], i / 30.0)
        after += slam.state == "OK"
        i += 1
    graphs = step_graph.StepGraphs(device)
    step = graphs.step(slam._track_impl, bound=0)
    worst, bad, copies = dict(T=0.0, inliers=0, matched=1.0), [], None
    for k in range(n_cmp + 1):
        if k == n_cmp:
            c = slam.map_cfg
            slam.map_cfg = c._replace(max_kf=2 * c.max_kf,
                                      max_pt=2 * c.max_pt,
                                      max_ln=2 * c.max_ln)
            slam.ms = mstate.grow(slam.ms, slam.map_cfg)
            if slam.loop_closer is not None:
                slam.loop_closer.map_cfg = slam.map_cfg
            copies = None
        if copies is None:
            copies = [clone_map(slam.ms), clone_map(slam.ms)]
        else:
            for cp in copies:
                for f, t in vars(slam.ms).items():
                    getattr(cp, f).copy_(t)
        feats, lfeats = slam._extract(frames[i])
        kw = dict(lfeats=lfeats, velocity=slam.velocity,
                  anchor_kf=slam._anchor_arg())
        eager = slam._track_impl(copies[0], feats, slam.T_last, **kw)
        graphed = step(copies[1], feats, slam.T_last, **kw)
        gaps = _track_gaps(eager, graphed)
        bad += _graph_failures(f"graphed step, frame {i}", gaps)
        worst = dict(T=max(worst["T"], gaps["T"]),
                     inliers=max(worst["inliers"], gaps["inliers"]),
                     matched=min(worst["matched"], gaps["matched"]))
        slam.track_monocular(frames[i], i / 30.0)
        i += 1
    worst.update(captures=graphs.captures, replays=graphs.replays)
    if (graphs.captures, graphs.replays) != (2, n_cmp - 1):
        bad.append(f"graphed step: {graphs.captures} captures and "
                   f"{graphs.replays} replays, expected 2 and {n_cmp - 1}")
    if bad:
        fail("; ".join(bad))
    return worst


def check_chunk_frames(frames, cfg, B=DISPATCH_CHUNK) -> dict:
    """One chunk of `track_chunked`, graphed and eager, from one state: an
    eager System tracks until two frames after its initialization, its map
    and state are copied into a graphed System, and both take the next B
    frames as one chunk. Each frame's pose in the graphed chunk must be its
    own (no two frames share a stack slot) and agree with the eager
    chunk's within item 7's bars, with the same decisions after the flush.
    Returns the worst pose gap; fails on a bar."""
    from plslam_tpu_torch.models.system import System
    device = torch.device("cuda", 0)
    eager = System(cfg, device=device, use_graphs=False)
    i, after = 0, 0
    while after < 2:
        eager.track_monocular(frames[i], i / 30.0)
        after += eager.state == "OK"
        i += 1
    graphed = System(cfg, device=device)
    copy_state(graphed, eager)
    imgs, tss = np.stack(frames[i:i + B]), [(i + j) / 30.0 for j in range(B)]
    out, stats = {}, {}
    for name, slam in (("eager", eager), ("graphed", graphed)):
        n0 = len(slam.stats)
        out[name] = slam.track_chunked(imgs, tss).clone()
        slam.flush()
        stats[name] = slam.stats[n0:]
    Tg, Te = out["graphed"], out["eager"]
    gap = float((Tg - Te).abs().max())
    bad = []
    if gap > GRAPH_T_TOL:
        bad.append(f"chunk poses differ by {gap} (> {GRAPH_T_TOL})")
    step_gaps = [float((Tg[j] - Tg[j + 1]).abs().max()) for j in range(B - 1)]
    if min(step_gaps) == 0.0:
        bad.append(f"two frames of the graphed chunk share a pose: "
                   f"{step_gaps}")
    for j, (a, b) in enumerate(zip(stats["graphed"], stats["eager"])):
        if (abs(a["inliers"] - b["inliers"]) > GRAPH_INLIERS
                or (a["kf"], a["lost"]) != (b["kf"], b["lost"])):
            bad.append(f"chunk frame {j}: graphed {a}, eager {b}")
    if bad:
        fail("; ".join(bad))
    return dict(T=gap, frames=B, captures=graphed.graphs.captures)


def run_dispatch(gm, Ts, frames, timing) -> dict:
    """The dispatch phase: the system sequence at `dispatch_config()`
    through `DISPATCH_RUNS`, each a fresh System checked against
    `check_system`'s bars. Per run: the host ms of each call of the entry
    point per frame (a call that is followed by a synchronization on the
    latency paths, the monocular and synced ones; the chunked and async
    runs synchronize only at the end), frames per second from the first
    call after initialization to the end (flush and a synchronization
    included), and the graphs' captures and replays and K1's launches.
    The eager run records K1's real calls, which are checked and timed
    into `timing` as in step 2."""
    res = {}
    for label, entry, graphed, extra in DISPATCH_RUNS:
        calls, latency = [], entry != "track_chunked" and not extra
        B = DISPATCH_CHUNK if entry == "track_chunked" else 1

        def drive(slam, step):
            for c0 in range(0, len(frames), B):
                t0 = time.perf_counter()
                if B > 1:
                    slam.track_chunked(np.stack(frames[c0:c0 + B]),
                                       [(c0 + j) / 30.0 for j in range(B)])
                else:
                    step(c0)
                if latency:
                    torch.cuda.synchronize()
                calls.append((c0, t0, time.perf_counter()))
            slam.flush()
            torch.cuda.synchronize()
            calls.append((len(frames), time.perf_counter(), None))

        t0 = time.perf_counter()
        out = run_system(frames, dispatch_config(**extra),
                         record_calls=not graphed, drive=drive,
                         track=entry,
                         use_graphs=graphed, stage_times=False)
        wall = time.perf_counter() - t0
        slam = out["slam"]
        # the init frame (the second keyframe's) and each later frame's
        # state from its resolved decision
        init = round(30 * slam.kf_timestamps[1]) if len(
            slam.kf_timestamps) > 1 else None
        out["init"] = init
        out["states"] = ["NOT_INITIALIZED"] * (init + 1) + [
            "LOST" if s["lost"] else "OK" for s in slam.stats] \
            if init is not None else []
        ate, span = check_system(Ts, out, f"dispatch, {label}")
        if not graphed:
            check_real_calls(gm, out, timing, f"dispatch, {label}")
        after = [c for c in calls[:-1] if init is not None and c[0] > init]
        per = 1e3 * np.array([(b - a) / B for _, a, b in after])
        t_end = calls[-1][1]
        fps = (len(frames) - after[0][0]) / (t_end - after[0][1])
        print(f"dispatch, {label}: per-frame host ms median "
              f"{np.median(per):.2f} p90 {np.percentile(per, 90):.2f} over "
              f"{len(after)} calls after init frame {init} ("
              f"{'each ending in a synchronization' if latency else 'no synchronization until the end'}"
              f"), {fps:.2f} frames/s to the end (flush and a "
              f"synchronization included); captures {out['captures']} "
              f"({slam.graphs.capture_s:.2f} s of host time, warm-ups "
              f"included), replays {out['replays']}, K1 launches "
              f"{out['launches']}; run {wall:.1f} s")
        res[label] = dict(out=out, median=float(np.median(per)),
                          p90=float(np.percentile(per, 90)), fps=fps,
                          ate=ate, span=span)
    return res


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
    im_l, im_r = (slam._image(im).to(torch.float32) for im in frame)
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


def check_map_io(sys_out, frames):
    """The system phase's map through `save_map` / `load_map` into a fresh
    System (graphed as the original is), every field bit-equal; then both
    Systems, from the same tracking state, track the sequence's last
    MAP_IO_FRAMES frames backwards, poses within GRAPH_T_TOL."""
    import dataclasses
    import tempfile
    from plslam_tpu_torch.models.system import System
    slam = sys_out["slam"]
    fresh = System(slam.cfg, device=slam.device,
                   use_graphs=slam.graphs.enabled)
    with tempfile.TemporaryDirectory(dir=ROOT / "build") as tmp:
        path = str(Path(tmp) / "map.npz")
        slam.save_map(path)
        size = Path(path).stat().st_size
        fresh.load_map(path)
    bad = [f.name for f in dataclasses.fields(slam.ms)
           if not torch.equal(getattr(slam.ms, f.name),
                              getattr(fresh.ms, f.name))]
    if bad:
        fail(f"map I/O: fields differ after save_map / load_map: {bad}")
    if fresh.n_kf_host != slam.n_kf_host:
        fail(f"map I/O: load_map set n_kf_host {fresh.n_kf_host}, the "
             f"System has {slam.n_kf_host}")
    for name in ("state", "frame_id", "last_kf_frame", "last_reloc_frame",
                 "ref_kf_matches"):
        setattr(fresh, name, getattr(slam, name))
    fresh.T_last, fresh.velocity = slam.T_last.clone(), slam.velocity.clone()
    fresh.kf_timestamps = list(slam.kf_timestamps)
    gap = 0.0
    for j in range(MAP_IO_FRAMES):
        img = frames[len(frames) - 1 - j]
        ts = (len(frames) + j) / 30.0
        a, b = slam.track_monocular(img, ts), fresh.track_monocular(img, ts)
        gap = max(gap, float((a - b).abs().max()))
    print(f"map I/O: {len(bad)} of {len(dataclasses.fields(slam.ms))} "
          f"fields differ after save_map ({size / 2**20:.1f} MiB npz) and "
          f"load_map; {MAP_IO_FRAMES} more frames from it within {gap:.2e} "
          f"of the original System's; states {slam.state} / {fresh.state}")
    if not gap <= GRAPH_T_TOL or fresh.state != slam.state:
        fail(f"map I/O: the loaded map's continuation differs (poses "
             f"{gap}, states {slam.state} / {fresh.state})")


def multistream_config():
    """`SLAMConfig` defaults (TUM fr1: 640x480, 1024 features, 8 levels,
    48 keyframes x 12288 points, lines on) with the renderer's camera and
    loop closing off (the trackers run none)."""
    from plslam_tpu_torch.models.system import SLAMConfig
    return SLAMConfig(fx=FX, fy=FX, cx=WIDTH / 2, cy=HEIGHT / 2, k1=0, k2=0,
                      p1=0, p2=0, k3=0, use_loop_closing=False)


def _render_stream(args):
    """One stream's frames (uint8) and frame 0's depth (a worker)."""
    seed, n_frames, width, height, fx = args
    from plslam_tpu_torch.datasets import synthetic
    scene = synthetic.make_scene(seed=seed, width=width, height=height,
                                 fx=fx, fy=fx)
    Ts = synthetic.trajectory(N_FRAMES, "orbit")[:n_frames]
    img0, depth0 = synthetic.render_rgbd(scene, Ts[0])
    frames = [img0] + [synthetic.render(scene, T) for T in Ts[1:]]
    return np.stack(frames).astype(np.uint8), depth0.astype(np.float32)


def render_streams(n_streams=MS_STREAMS, n_frames=MS_FRAMES + 1):
    """Stream s: `make_scene(seed=100 + s)` along the slice's orbit (the
    first `n_frames` of `trajectory(N_FRAMES, "orbit")`), rendered in
    worker processes: (Ts, frames (S, n_frames, H, W) uint8, depths (S, H,
    W) of frame 0)."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    from plslam_tpu_torch.datasets import synthetic
    with ProcessPoolExecutor(8, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        out = list(pool.map(_render_stream, [
            (100 + s, n_frames, WIDTH, HEIGHT, FX) for s in range(n_streams)]))
    return (synthetic.trajectory(N_FRAMES, "orbit")[:n_frames],
            np.stack([f for f, _ in out]), np.stack([d for _, d in out]))


def stream_maps(cfg, frames, depths):
    """Each stream's map on the card: a keyframe at the origin and points
    from frame 0's depth (as `run_slice` bootstraps its map)."""
    from plslam_tpu_torch.geometry import camera
    from plslam_tpu_torch.mapstate import state as mstate
    from plslam_tpu_torch.models import mapping
    from plslam_tpu_torch.ops import extract, stereo
    device = torch.device("cuda", 0)
    ext_cfg = extract.ExtractorConfig(n_features=cfg.n_features,
                                      n_levels=cfg.n_levels)
    sf, _ = extract.scale_factors(ext_cfg, device)
    cam = camera.Camera.create(cfg.fx, cfg.fy, cfg.cx, cfg.cy,
                               width=cfg.width, height=cfg.height)
    extractor = extract.PointExtractor(ext_cfg, cfg.height,
                                       cfg.width).to(device)
    map_cfg = mstate.MapConfig(max_kf=cfg.max_kf, max_pt=cfg.max_pt,
                               max_ln=cfg.max_ln, n_kp=cfg.n_features,
                               n_lf=cfg.n_lf, n_levels=cfg.n_levels)
    maps = []
    for s in range(frames.shape[0]):
        f = extractor(torch.from_numpy(frames[s, 0]).to(device)
                      .to(torch.float32))
        f = f._replace(uv_un=camera.undistort_pixels(cam, f.uv))
        ms = mstate.allocate(map_cfg, device)
        mapping.insert_keyframe(cam, ms, f, torch.eye(4, device=device),
                                torch.full((cfg.n_features,), -1,
                                           dtype=torch.int32, device=device),
                                0, sf)
        mapping.create_points_from_depth(
            cam, ms, ms.n_kf - 1, stereo.depth_at(
                torch.from_numpy(depths[s]).to(device), f.uv), sf)
        maps.append(ms)
    return maps


def run_batched(cfg, maps, frames, n_frames, use_graphs=True, record=None):
    """`BatchedTracker` over the streams of `maps` (S maps, cloned and
    stacked) and `frames` (S, F, H, W) for `n_frames` lockstep frames
    (frames 1.., frame 0 made the maps), synchronized after each step;
    K1's count set to 0 just before and read just after. With `record`
    (a list), K1's batched calls of the step of frame 1 are appended to it
    (eager runs). Returns poses (F, S, 4, 4), scalars (F, S, 6), step
    seconds, launches, peak memory, captures and replays."""
    from plslam_tpu_torch.mapstate import state as mstate
    from plslam_tpu_torch.ops import gated_match as gm
    from plslam_tpu_torch.parallel import multistream
    device = torch.device("cuda", 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(device)
    bt = multistream.BatchedTracker(cfg, len(maps), kf_interval=MS_KF_INTERVAL,
                                    device=device, use_graphs=use_graphs)
    bt.bootstrap(mstate.stack([clone_map(m) for m in maps]))
    launch = gm._launch

    def recording(args, gated, in_dims=(None,) * 9, S=1):
        record.append(([t.clone() for t in args], tuple(in_dims), S, gated))
        return launch(args, gated, in_dims, S)
    Ts, sc, secs = [], [], []
    gm.gated_hamming_best2.launches = 0
    try:
        for j in range(n_frames):
            imgs = frames[:, 1 + j]
            if record is not None and j == 1:
                gm._launch = recording
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            T, scalars = bt.step(imgs)
            torch.cuda.synchronize()
            secs.append(time.perf_counter() - t0)
            gm._launch = launch
            Ts.append(T.cpu().numpy())
            sc.append(scalars.cpu().numpy())
    finally:
        gm._launch = launch
    return dict(poses=np.stack(Ts), scalars=np.stack(sc), secs=secs,
                launches=gm.gated_hamming_best2.launches,
                peak=torch.cuda.max_memory_allocated(device),
                captures=bt.graphs.captures, replays=bt.graphs.replays,
                capture_s=bt.graphs.capture_s, bt=bt)


def run_alone(cfg, maps, frames, n_frames, moved=0.0):
    """Each stream alone through the unbatched graphed step (the batched
    tracker's per-stream step, no vmap), the streams one after the other
    through one bound map: poses (F, S, 4, 4) and scalars (F, S, 6). With
    `moved`, the first frame starts from the identity moved by that many
    metres along x."""
    from functools import partial
    from plslam_tpu_torch.models import step_graph
    from plslam_tpu_torch.parallel import multistream
    device = torch.device("cuda", 0)
    bt = multistream.BatchedTracker(cfg, 1, kf_interval=MS_KF_INTERVAL,
                                    device=device)
    graphs = step_graph.StepGraphs(device)
    steps = {kf: graphs.step(partial(bt._stream_step, with_kf=kf), bound=0)
             for kf in (False, True)}
    ms = clone_map(maps[0])
    Ts = np.zeros((n_frames, len(maps), 4, 4), np.float32)
    sc = np.zeros((n_frames, len(maps), 6), np.int32)
    T0 = torch.eye(4, device=device)
    T0[0, 3] = moved
    for s, m in enumerate(maps):
        multistream.copy_map(ms, m)
        T, vel = T0, torch.eye(4, device=device)
        for j in range(n_frames):
            T, vel, scalars = steps[j % MS_KF_INTERVAL == 0](
                ms, torch.from_numpy(frames[s, 1 + j]).to(device), T, vel,
                torch.full((), j, dtype=torch.int32, device=device))
            Ts[j, s], sc[j, s] = T.cpu().numpy(), scalars.cpu().numpy()
    return Ts, sc, graphs.captures


def check_batched_case(gm, label, args, in_dims, S, gated):
    """K1's batched launch (`gated_match._launch`) against S single launches
    and against the batched plain version, exact; then device ms of each
    beside the bound: S searches' bytes (each input read once, each output
    written once) over the memory rate, or 2 x 256 operations per passing
    pair over the int8 peak."""
    args = [t if d is None else t.movedim(d, 0).contiguous()
            for t, d in zip(args, in_dims)]
    dims = tuple(None if d is None else 0 for d in in_dims)
    # each stream's inputs as one search takes them (fresh, so aligned)
    per = [[t if d is None else t[s].clone() for t, d in zip(args, dims)]
           for s in range(S)]
    full = [t.expand((S,) + t.shape) if d is None else t
            for t, d in zip(args, dims)]
    got = gm._launch(args, gated, dims, S)
    singles = [gm.gated_hamming_best2(*per[s], gated=gated)
               for s in range(S)]
    want = gm.gated_hamming_best2_reference(*full, gated=gated)
    torch.cuda.synchronize()
    err = 0
    for k, name in enumerate(("idx", "best", "second")):
        one = torch.stack([x[k] for x in singles])
        for other, what in ((one, "single launches"), (want[k], "plain")):
            e = int((got[k].long() - other.long()).abs().max()) \
                if got[k].numel() else 0
            err = max(err, e)
            if e or got[k].dtype != other.dtype:
                fail(f"batched K1 {label}: {name} differs from the {what} "
                     f"(max |diff| {e})")
    n, p = args[0].shape[-2], args[4].shape[-2]
    n_pass = int(gm.gate_mask(*full[1:4], *full[5:], gated=gated).sum())
    n_bytes = sum(t.numel() * t.element_size() for t in args) \
        + sum(t.numel() * t.element_size() for t in got)
    bytes_ms = 1e3 * n_bytes / H100_BYTES
    ops_ms = 1e3 * 2 * 256 * n_pass / H100_INT8_OPS
    out = dict(err=err, ms=cuda_ms(lambda: gm._launch(args, gated, dims,
                                                       S)),
        single_ms=cuda_ms(lambda: [gm.gated_hamming_best2(
            *per[s], gated=gated) for s in range(S)], runs=10, batch=2),
        plain_ms=cuda_ms(lambda: gm.gated_hamming_best2_reference(
            *full, gated=gated), runs=10, batch=2),
        bound_ms=max(bytes_ms, ops_ms),
        bound_by="bytes" if bytes_ms >= ops_ms else "operations")
    print(f"batched K1 {label}: S={S} N={n} P={p} gated={gated}, "
          f"inputs batched {[d is not None for d in dims]}: bit-equal to "
          f"{S} single launches and to the batched plain version; "
          f"{n_pass} pairs pass; ms: one batched launch {out['ms']:.4f}, "
          f"{S} single launches {out['single_ms']:.4f}, batched plain "
          f"{out['plain_ms']:.4f}; bound {out['bound_ms']:.5f} ms by "
          f"{out['bound_by']} (bytes {n_bytes} / 3.35 TB/s = "
          f"{bytes_ms:.5f} ms, 2 x 256 x {n_pass} / 1979 TOP/s = "
          f"{ops_ms:.5f} ms), batched launch at "
          f"{100 * out['bound_ms'] / out['ms']:.1f}% of the bound")
    return out


def _pose_gaps(a, b):
    """Per stream, the largest pose-entry gap over the frames."""
    return np.abs(a - b).reshape(a.shape[0], a.shape[1], -1).max((0, 2))


def _timed_rate(label, secs, S):
    """Lockstep step ms (median, p90) and frames/s per card over the frames
    MS_TIMED of a run."""
    x = np.array(secs[MS_TIMED[0]:MS_TIMED[1]])
    r = dict(median_ms=1e3 * float(np.median(x)),
             p90_ms=1e3 * float(np.percentile(x, 90)),
             fps=S * len(x) / float(x.sum()))
    print(f"multistream: {label}: lockstep step ms median "
          f"{r['median_ms']:.2f} p90 {r['p90_ms']:.2f} over frames "
          f"{MS_TIMED[0]}-{MS_TIMED[1] - 1}; {r['fps']:.1f} frames/s per "
          f"card ({S} streams)")
    return r


def run_multistream_phase(gm, launches):
    """The multistream phase (item 11 of the module docstring)."""
    from plslam_tpu_torch.datasets import synthetic
    t_phase = time.perf_counter()
    cfg = multistream_config()
    t0 = time.perf_counter()
    Ts, frames, depths = render_streams()
    print(f"multistream: rendered {frames.shape[0]} streams x "
          f"{frames.shape[1]} frames in {time.perf_counter() - t0:.1f} s")
    maps = stream_maps(cfg, frames, depths)
    S = len(maps)

    # the main path: 16 streams, graphed, K1 counted from 0
    main = run_batched(cfg, maps, frames, MS_FRAMES)
    launches["multistream"] = main["launches"]
    inl = main["scalars"][..., 0]
    ates = [synthetic.ate_rmse(main["poses"][:, s], Ts[1:MS_FRAMES + 1],
                               align_scale=False) for s in range(S)]
    bt = main["bt"]
    print(f"multistream: {S} streams x {MS_FRAMES} lockstep frames: "
          f"ATE per stream (m) {' '.join(f'{a:.4f}' for a in ates)}; "
          f"inliers per stream and frame min {inl.min()} median "
          f"{int(np.median(inl))}; keyframes per stream "
          f"{bt.ms.n_kf.tolist()}, points {bt.ms.n_pt.tolist()}, lines "
          f"{bt.ms.n_ln.tolist()}; K1 launches {main['launches']}; peak "
          f"device memory {main['peak'] / 2**20:.1f} MiB; graphs: "
          f"{main['captures']} captures ({main['capture_s']:.1f} s with "
          f"their eager warm-ups), {main['replays']} replays")
    rates = {S: _timed_rate(f"S={S}", main["secs"], S)}
    bad = []
    if main["launches"] != 3 * MS_FRAMES:
        bad.append(f"K1 launched {main['launches']} times, expected "
                   f"{3 * MS_FRAMES} (3 batched searches per step)")
    if max(ates) >= MS_ATE:
        bad.append(f"stream ATE {max(ates):.4f} m (>= {MS_ATE})")
    if inl.min() < MIN_INLIERS:
        bad.append(f"{inl.min()} inliers on a stream and frame "
                   f"(< {MIN_INLIERS})")

    # each stream alone through the unbatched graphed step; and, as the
    # witness of how far float32 noise carries, each stream alone again
    # from a first pose moved by MS_MOVED
    F = MS_ALONE_FRAMES
    T1, s1, caps = run_alone(cfg, maps, frames, F)
    T1m, s1m, _ = run_alone(cfg, maps, frames, F, moved=MS_MOVED)
    batched = main["poses"][:F]
    per_frame = np.abs(batched - T1).reshape(F, -1).max(1)
    per_stream = _pose_gaps(batched, T1)
    moved_stream = _pose_gaps(T1m, T1)
    d_inl = np.abs(main["scalars"][:F, :, 0].astype(int)
                   - s1[..., 0]).max(0)

    def first_flip(a, b):
        """Per stream, the first frame whose integer scalars differ (-1:
        none)."""
        d = (a != b).any(-1)
        return [int(np.argmax(d[:, k])) if d[:, k].any() else -1
                for k in range(d.shape[1])]
    print(f"multistream: each stream alone through the unbatched graphed "
          f"step over {F} frames ({caps} captures): pose gap over the "
          f"streams per frame {' '.join(f'{g:.2e}' for g in per_frame)}; "
          f"per stream {' '.join(f'{g:.2e}' for g in per_stream)}; first "
          f"frame with an integer scalar differing per stream "
          f"{first_flip(main['scalars'][:F], s1)}; inlier gap max "
          f"{d_inl.max()}")
    print(f"multistream: witness, each stream alone from a first pose moved "
          f"{MS_MOVED:g} m against alone: pose gap per stream "
          f"{' '.join(f'{g:.2e}' for g in moved_stream)} (max "
          f"{moved_stream.max():.2e}, batched against alone max "
          f"{per_stream.max():.2e}); first frame with an integer scalar "
          f"differing per stream {first_flip(s1m, s1)}")
    if (per_frame[0] > MS_T_TOL or per_frame.max() > MS_T_TOL_SEQ
            or d_inl.max() > MS_INLIERS):
        bad.append(f"streams alone differ: poses {per_frame.tolist()}, "
                   f"inliers {d_inl.max()}")

    # 16 identical streams under deterministic algorithms
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        same = run_batched(cfg, [maps[0]] * S,
                           np.broadcast_to(frames[:1], frames.shape),
                           MS_ALONE_FRAMES)
    finally:
        torch.use_deterministic_algorithms(False)
    sc_eq = bool((same["scalars"] == same["scalars"][:, :1]).all())
    same_gap = _pose_gaps(same["poses"],
                          np.broadcast_to(same["poses"][:, :1],
                                          same["poses"].shape)).max()
    print(f"multistream: {S} identical streams, deterministic algorithms, "
          f"{MS_ALONE_FRAMES} frames: integer scalars equal {sc_eq}, poses "
          f"within {same_gap:.2e}")
    if not sc_eq or same_gap > MS_T_TOL:
        bad.append(f"identical streams differ: scalars equal {sc_eq}, poses "
                   f"{same_gap}")

    # the eager batched step against the graphed one, and K1's real calls
    calls = []
    eager = run_batched(cfg, maps, frames, MS_EAGER_FRAMES,
                        use_graphs=False, record=calls)
    eq = bool(np.array_equal(eager["poses"],
                             main["poses"][:MS_EAGER_FRAMES])
              and np.array_equal(eager["scalars"],
                                 main["scalars"][:MS_EAGER_FRAMES]))
    print(f"multistream: eager batched step against the graphed one over "
          f"{MS_EAGER_FRAMES} frames (a keyframe step replayed): "
          f"bit-equal {eq}; eager step ms median "
          f"{1e3 * float(np.median(eager['secs'][1:])):.1f}")
    if not eq:
        bad.append("the graphed batched step differs from the eager one")
    if len(calls) != len(TRACKING_SEARCHES):
        bad.append(f"recorded {len(calls)} batched K1 calls in a step, "
                   f"expected {len(TRACKING_SEARCHES)}")
    k1 = {}
    for (args, in_dims, n_s, gated), label in zip(calls, TRACKING_SEARCHES):
        k1[label] = check_batched_case(gm, f"real call, {label}", args,
                                       in_dims, n_s, gated)
    rng = np.random.default_rng(16)
    one = [random_search_inputs(rng, 1024, 12288) for _ in range(S)]
    stacked = [torch.from_numpy(np.stack([o[k] for o in one])).cuda()
               for k in one[0]]
    k1["random"] = check_batched_case(gm, "random inputs", stacked,
                                      (0,) * 9, S, True)

    # frames/s per card at S = 1 and 4 (the first streams); their first
    # frames against the 16-stream run and the unbatched step alone
    for n_s in MS_SIZES:
        if n_s == S:
            continue
        r = run_batched(cfg, maps[:n_s], frames[:n_s], MS_TIMED[1])
        rates[n_s] = _timed_rate(f"S={n_s}", r["secs"], n_s)
        vs_main, vs_alone = (
            " ".join(f"{g:.2e}" for g in _pose_gaps(r["poses"][:F],
                                                    ref[:, :n_s]))
            for ref in (batched, T1))
        print(f"multistream: S={n_s}: peak device memory "
              f"{r['peak'] / 2**20:.1f} MiB, {r['captures']} captures "
              f"({r['capture_s']:.1f} s), K1 launches {r['launches']}; "
              f"over {F} frames, pose gap per stream against S={S} "
              f"{vs_main}, against alone {vs_alone}")
        gap = _pose_gaps(r["poses"][:F], T1[:, :n_s]).max()
        same = np.array_equal(r["scalars"][:F], s1[:, :n_s])
        if n_s == 1 and (gap > 0 or not same):
            bad.append(f"S=1: the vmapped step differs from the unbatched "
                       f"one: poses {gap}, integer scalars equal {same}")
        if gap > MS_T_TOL_SEQ:
            bad.append(f"S={n_s}: streams alone differ: poses {gap}")
    check_round_robin(cfg, maps, frames, Ts, launches, bad)
    print(f"multistream: frames/s per card " + ", ".join(
        f"S={k} {rates[k]['fps']:.1f}" for k in sorted(rates))
        + f"; phase {time.perf_counter() - t_phase:.1f} s")
    if bad:
        fail("multistream: " + "; ".join(bad))
    return rates, k1


def check_round_robin(cfg, maps, frames, Ts, launches, bad):
    """`RoundRobinTracker` at RR_STREAMS streams, chunks of RR_CHUNK, over
    the batched phase's frames: frames/s after the first chunk (which
    captures), each stream's ATE, no capture after the first chunk."""
    from plslam_tpu_torch.datasets import synthetic
    from plslam_tpu_torch.ops import gated_match as gm
    from plslam_tpu_torch.parallel import multistream
    device = torch.device("cuda", 0)
    rr = multistream.RoundRobinTracker(cfg, RR_STREAMS, device=device)
    rr.bootstrap(maps[:RR_STREAMS])
    n_chunks = MS_FRAMES // RR_CHUNK
    poses, secs, caps = [[] for _ in range(RR_STREAMS)], [], []
    gm.gated_hamming_best2.launches = 0
    for c in range(n_chunks):
        chunk = [frames[s, 1 + c * RR_CHUNK:1 + (c + 1) * RR_CHUNK]
                 for s in range(RR_STREAMS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = rr.step_chunks(chunk)
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
        caps.append(rr.slam.graphs.captures)
        for s, T in enumerate(out):
            poses[s].append(T.cpu().numpy())
    launches["round robin"] = gm.gated_hamming_best2.launches
    ates = [synthetic.ate_rmse(np.concatenate(p), Ts[1:n_chunks * RR_CHUNK
                                                     + 1], align_scale=False)
            for p in poses]
    fps = RR_STREAMS * RR_CHUNK * (n_chunks - 1) / sum(secs[1:])
    print(f"round robin: {RR_STREAMS} streams x {n_chunks} chunks of "
          f"{RR_CHUNK}: {fps:.1f} frames/s per card after the first chunk; "
          f"ATE per stream (m) {' '.join(f'{a:.4f}' for a in ates)}; "
          f"captures after each chunk {caps}; K1 launches "
          f"{launches['round robin']}")
    if max(ates) >= MS_ATE:
        bad.append(f"round robin: stream ATE {max(ates):.4f} m")
    if len(set(caps)) != 1:
        bad.append(f"round robin: captures after the first chunk {caps}")
    if launches["round robin"] != 3 * RR_STREAMS * n_chunks * RR_CHUNK:
        bad.append(f"round robin: K1 launched {launches['round robin']} "
                   f"times, expected "
                   f"{3 * RR_STREAMS * n_chunks * RR_CHUNK}")
    return fps


def main() -> int:
    t_start = time.perf_counter()
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

    launches = {}
    launches["slice"] = check_slice()
    sys_out = check_system_phase(gm, Ts_sys, frames_sys, timing)
    launches["system"] = sys_out["launches"]
    check_map_io(sys_out, frames_sys)
    t0 = time.perf_counter()
    for label, r in run_dispatch(gm, Ts_sys, frames_sys, timing).items():
        launches[f"dispatch, {label}"] = r["out"]["launches"]
    g = check_graphed_step(frames_sys, dispatch_config())
    print(f"dispatch: the graphed tracking step against the eager one "
          f"on the same inputs, 4 frames and one after a growth event: "
          f"T within {g['T']:.2e}, inliers within {g['inliers']}, "
          f"matched_pt {100 * g['matched']:.2f}% equal; "
          f"{g['captures']} captures, {g['replays']} replays")
    c = check_chunk_frames(frames_sys, dispatch_config())
    print(f"dispatch: one chunk of {c['frames']}, graphed against eager "
          f"from one state: poses within {c['T']:.2e}, decisions equal; "
          f"{c['captures']} captures; phase "
          f"{time.perf_counter() - t0:.1f} s")
    check_later_phases(gm, device, timing, launches)
    run_multistream_phase(gm, launches)
    print(f"K1 launches: " + ", ".join(f"{k} {v}" for k, v in
                                       launches.items()))
    print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")

    head = timing[(1024, 12288, True)]
    print(f"card: {card_line()}")
    print(json.dumps({"kernels": [{
        "name": "gated_hamming_best2", "route": "cuda",
        "source": "plslam_tpu_torch/csrc/gated_hamming.cu",
        "replaces": "plslam_tpu/ops/pallas_match.py:115",
        "launches": sum(launches.values()),
        "max_abs_err": max(c["err"] for c in timing.values()),
        "ms": head["ms"], "plain_ms": head["plain_ms"],
        "bound_ms": head["bound_ms"], "bound_by": head["bound_by"],
        "library_ms": head["library_ms"]}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def check_slice() -> int:
    """The tracking slice, graphed: its checks; returns K1's launches."""
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
          f"peak device memory {out['peak'] / 2**20:.1f} MiB; graphs: "
          f"{out['captures']} captures, {out['replays']} replays")

    if inl.min() < MIN_INLIERS:
        fail(f"frame {int(inl.argmin()) + 1} tracked {inl.min()} inliers "
             f"(< {MIN_INLIERS})")
    if not ate < ATE_FRACTION * path:
        fail(f"ATE {ate:.4f} m is not below {ATE_FRACTION:.0%} of the "
             f"{path:.3f} m path")
    if out["launches"] != 3 * (N_FRAMES - 1):
        fail(f"K1 launched {out['launches']} times in the slice, expected "
             f"{3 * (N_FRAMES - 1)}")
    return out["launches"]


def check_system_phase(gm, Ts_sys, frames_sys, timing) -> dict:
    """The system phase, eager (it records K1's real calls), and K1 on
    those calls; returns the run (`run_system`)."""
    t0 = time.perf_counter()
    sys_out = run_system(frames_sys)
    print(f"system: {SYSTEM_FRAMES} frames in {time.perf_counter() - t0:.1f} s")
    check_system(Ts_sys, sys_out)
    check_real_calls(gm, sys_out, timing)
    return sys_out


def check_real_calls(gm, out, timing, phase=None):
    """K1 on a run's recorded real calls (the init match and the three
    searches of a tracked frame), bit for bit and timed as in step 2, into
    `timing` under their labels, prefixed with `phase`."""
    if len(out["real_calls"]) != len(TRACKING_SEARCHES) + 1:
        fail(f"recorded {len(out['real_calls'])} of K1's real calls, "
             f"expected {len(TRACKING_SEARCHES) + 1}")
    for label, a, gated in out["real_calls"]:
        label = label if phase is None else f"{phase}, {label}"
        n, p = a["q_bits"].shape[0], a["d_bits"].shape[0]
        timing[label] = check_case(gm, f"real call, {label}: N={n} P={p} "
                                   f"gated={gated}", a, gated)


def check_later_phases(gm, device, timing, launches):
    """The lines, relocalization, depth and loop phases, graphed, and K1
    on the first relocalization attempt's and the first Sim3 stage's real
    calls; adds each run's K1 launches to `launches`."""
    new_calls = []
    # (a) the defaults with lines on, (b) the lines-help widths with
    # lines on and off, (c) detect_lines on the card vs the CPU
    t0 = time.perf_counter()
    Ts_ln, frames_ln = render_lines_sequence()
    print(f"rendered the {LINES_FRAMES}-frame line-rich sequence in "
          f"{time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    lines_out = run_system(frames_ln, lines_config(), record_calls=False)
    print(f"lines (a): {LINES_FRAMES} frames in "
          f"{time.perf_counter() - t0:.1f} s")
    check_system(Ts_ln, lines_out, "lines (a)", min_lines=1)
    launches["lines (a)"] = lines_out["launches"]
    small = {}
    for use_lines in (True, False):
        t0 = time.perf_counter()
        small[use_lines] = run_system(
            frames_ln, lines_config(True, use_lines), record_calls=False)
        name = f"lines (b), lines {'on' if use_lines else 'off'}"
        print(f"{name}: {LINES_FRAMES} frames in "
              f"{time.perf_counter() - t0:.1f} s")
        launches[name] = small[use_lines]["launches"]
    check_lines_small(Ts_ln, small[True], small[False])
    check_detect_on_card(frames_ln)

    # tests/test_reloc_e2e.py's kidnap at the defaults
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
    print(f"reloc: {RELOC_FRAMES} frames in "
          f"{time.perf_counter() - t0:.1f} s")
    check_reloc(rl_out, reloc)
    launches["reloc"] = rl_out["launches"]
    new_calls += list(zip(RELOC_SEARCHES,
                          rl_out["stage_calls"]["reloc"]))

    # tests/test_depth_sensors.py's RGB-D and stereo runs at the
    # defaults
    for kind, render in (("rgbd", render_rgbd_sequence),
                         ("stereo", render_stereo_sequence)):
        t0 = time.perf_counter()
        Ts_d, frames_d, *dep = render()
        print(f"rendered the {len(Ts_d)}-frame {kind} sequence in "
              f"{time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        d_out = run_system(frames_d, depth_config(kind),
                           record_calls=False, track=f"track_{kind}")
        print(f"{kind}: {len(Ts_d)} frames in "
              f"{time.perf_counter() - t0:.1f} s")
        check_depth(kind, Ts_d, d_out)
        launches[kind] = d_out["launches"]
        if kind == "stereo":
            check_stereo_depth(d_out["slam"],
                               frames_d[STEREO_DEPTH_FRAME], dep[0])

    loop_bad = []
    # tests/test_loop_closure_e2e.py's circuit at its widths (a) and at
    # the defaults (b)
    t0 = time.perf_counter()
    Ts_lp, frames_lp = render_loop_sequence()
    print(f"rendered the {LOOP_FRAMES}-frame circuit in "
          f"{time.perf_counter() - t0:.1f} s")
    # whether the circuit closes at the defaults turns on which
    # candidates become consistent, and the order of float atomics
    # (BA's index_add_) moves the trajectory from run to run: 9 of 10
    # runs closed (PERF.md). The loop phase runs torch's deterministic
    # algorithms, so it repeats.
    loops = {}
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for name, small_widths in (("loop (a)", True),
                                   ("loop (b)", False)):
            t0 = time.perf_counter()
            loops[name] = run_system(frames_lp, loop_config(small_widths),
                                     record_calls=False)
            print(f"{name}: {LOOP_FRAMES} frames in "
                  f"{time.perf_counter() - t0:.1f} s")
            loop_bad += [f"{name}: {b}"
                         for b in check_loop(name, Ts_lp, loops[name])]
            launches[name] = loops[name]["launches"]
    finally:
        torch.use_deterministic_algorithms(False)
    # the first Sim3 stage at the default widths (else at (a)'s)
    sim3_run = loops["loop (b)"] if "sim3" in loops["loop (b)"][
        "stage_calls"] else loops["loop (a)"]
    sim3_calls = sim3_run["stage_calls"].get("sim3", [])
    if len(sim3_calls) != 2:
        fail(f"recorded {len(sim3_calls)} K1 calls of the first Sim3 "
             f"stage, expected 2")
    new_calls += list(zip(SIM3_SEARCHES, sim3_calls))

    # K1 on the calls of the relocalization and Sim3 stages
    if len(new_calls) != 4:
        fail(f"recorded {len(new_calls)} K1 calls of the first "
             f"relocalization attempt and Sim3 stage, expected 4")
    for label, (a, gated) in new_calls:
        n, p = a["q_bits"].shape[0], a["d_bits"].shape[0]
        timing[label] = check_case(gm, f"real call, {label}: N={n} P={p} "
                                   f"gated={gated}", a, gated)
    if loop_bad:
        fail("; ".join(loop_bad))


if __name__ == "__main__":
    sys.exit(main())

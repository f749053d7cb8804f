"""One run of a benchmark cell, as `python3 -m benchmark.run` makes it, then
the port's tracer (`plslam_tpu_torch/utils/trace.py`) read over the run's
window: per-stage device ms in fast and slow frames, the device gap between
frames split by the host span that covered it on the calibrated clock, the
frame graph's device ms by CUDA events beside the tracer's, the trace
clock's error bound, the device timer's resolution and the host cost of a
span.

    python3 scripts/trace_revisit.py --workload tum1_mono.revisit \
        --seed 3000000001 --seconds 30 --trace 1 [--slow-ms 44] \
        [--out build/trace_revisit]

Run from the root of a checkout, whose `benchmark` and program it imports:
the result line of `benchmark.run` is printed as that module prints it,
then the tracer's report (`trace ...` lines), and the per-frame rows go to
`<out>/<seed>.json`. A checkout whose program has no tracer gets the CUDA
events' per-frame numbers alone. Needs a CUDA device and `--trace 1`.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time
from pathlib import Path

sys.path.insert(0, os.getcwd())

import benchmark.run as brun  # noqa: E402
from benchmark.harness import profile  # noqa: E402

STAGES = ("extract.points", "extract.lines", "track.search_a",
          "track.pose_a", "track.search_b", "track.pose_b", "track.finish")


def _median(xs):
    xs = [x for x in xs if x is not None]
    return statistics.median(xs) if xs else None


def _split(rows, slow_ms):
    fast = [r for r in rows if "frame" in r["device_ms"]
            and r["device_ms"]["frame"] <= slow_ms]
    slow = [r for r in rows if "frame" in r["device_ms"]
            and r["device_ms"]["frame"] > slow_ms]
    return fast, slow


def _stage_medians(rows):
    out = {"frame": _median(r["device_ms"].get("frame") for r in rows),
           "gap": _median(r["gap_ms"] for r in rows)}
    for s in STAGES:
        out[s] = _median(r["device_ms"].get(s) for r in rows)
    return out


def _frame_bounds(recs):
    """{frame id: (start ns, end ns)} of the frames' `frame` marks."""
    out = {}
    for fid, name, end, ns in recs:
        if name == "frame":
            a, b = out.get(fid, (None, None))
            out[fid] = (a, ns) if end else (ns, b)
    return {f: ab for f, ab in out.items() if None not in ab}


def _cover(a, b, spans):
    """{innermost host span name: ns} over the host interval [a, b];
    `outside` where no span of the program covers it."""
    inside = [s for s in spans if s[2] < b and s[3] > a]
    cuts = sorted({a, b} | {t for s in inside for t in (s[2], s[3])
                            if a < t < b})
    out = {}
    for lo, hi in zip(cuts, cuts[1:]):
        mid = 0.5 * (lo + hi)
        cover = [s for s in inside if s[2] <= mid <= s[3]]
        name = max(cover, key=lambda s: s[2])[1] if cover else "outside"
        out[name] = out.get(name, 0) + (hi - lo)
    return out


def _gap_split(tracer, window):
    """Per gap between consecutive window frames: its device ms and its
    host-clock split by innermost host span (ms)."""
    recs = tracer.records(window.start, window.end)
    spans = tracer.host_spans(window.start, window.end)
    if recs is None or spans is None:
        return None
    bounds = _frame_bounds(recs)
    fids = sorted(bounds)
    out = []
    for f0, f1 in zip(fids, fids[1:]):
        if f1 != f0 + 1:
            continue
        d0, d1 = bounds[f0][1], bounds[f1][0]
        h0, h1 = tracer.to_host_ns([d0, d1])
        out.append({"frame": f1, "gap_ms": (d1 - d0) / 1e6,
                    "split_ms": {k: v / 1e6 for k, v in
                                 _cover(h0, h1, spans).items()}})
    return out


def _span_cost_us(tracer, n=20000):
    """Host us per span: off, on without a stamp, on with its two stamps."""
    was = tracer.on
    out = {}
    for label, on, name, k in (("off", False, "resolve", n),
                               ("on", True, "resolve", n),
                               ("on_stamped", True, "keyframe", n // 10)):
        tracer.enable(on)
        t0 = time.perf_counter()
        for _ in range(k):
            with tracer.span(name):
                pass
        out[label] = 1e6 * (time.perf_counter() - t0) / k
    tracer.enable(was)
    return out


def _stamp_cost_us(tracer, n=200, reps=20):
    """Device us per stamp as a node of a CUDA graph: a graph of `n`
    stamps in a chain, replayed `reps` times between CUDA events."""
    import torch
    issued = tracer.launches
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            tracer.stamp("calibrate")
    tracer.launches = issued
    graph.replay()
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    a.record()
    for _ in range(reps):
        graph.replay()
    b.record()
    b.synchronize()
    tracer.launches += n * (reps + 1)
    return 1e3 * a.elapsed_time(b) / (n * reps)


def report(run, slow_ms: float, out_dir: Path):
    ev = profile.per_frame_ms(run) if getattr(run, "replay_spans", None) \
        else {}
    ev_ms = list(ev.values())
    n_slow = sum(v > slow_ms for v in ev_ms)
    print(f"trace events: {len(ev_ms)} frames, median "
          f"{_median(ev_ms)} ms, {n_slow} slow (> {slow_ms} ms), fast "
          f"median {_median([v for v in ev_ms if v <= slow_ms])}, slow "
          f"median {_median([v for v in ev_ms if v > slow_ms])}")
    window = getattr(run, "slam_trace", None)
    if window is None:
        print("trace: the program has no tracer")
        return
    tracer = window.tracer
    rows = window.rows()
    if rows is None:
        print("trace: the ring overwrote part of the window")
        return
    fast, slow = _split(rows, slow_ms)
    med = {"all": _stage_medians(rows), "fast": _stage_medians(fast),
           "slow": _stage_medians(slow)}
    counts = {"all": len(rows), "fast": len(fast), "slow": len(slow)}
    for k, m in med.items():
        print(f"trace stages {k} ({counts[k]} frames): " + ", ".join(
            f"{s} {v:.4f}" for s, v in m.items() if v is not None))
    step = med["all"]["frame"]
    parts = [med["all"][s] for s in STAGES[:6]]
    if step and None not in parts:
        print(f"trace coverage: four metrics {sum(parts):.4f} of step "
              f"{step:.4f} ms = {100 * sum(parts) / step:.2f}%")
    if ev_ms and step:
        print(f"trace step vs events: {step:.4f} vs {_median(ev_ms):.4f} "
              f"ms ({100 * (step / _median(ev_ms) - 1):+.3f}%)")
    gaps = [r["gap_ms"] for r in rows if r["gap_ms"] is not None]
    if gaps:
        n_frames = sum(r["frames"] for r in run.records)
        idle_ev = 100 * (1 - sum(ev_ms) / (1e3 * run.window_s)) if ev_ms \
            else None
        print(f"trace idle: median gap {_median(gaps):.4f} ms x "
              f"{n_frames} frames / {run.window_s:.3f} s = "
              f"{100 * _median(gaps) * n_frames / (1e3 * run.window_s):.3f}%"
              f" (sum of gaps {100 * sum(gaps) / (1e3 * run.window_s):.3f}%"
              f"); device_idle_pct by events {idle_ev}")
    split = _gap_split(tracer, window)
    if split:
        names = sorted({k for g in split for k in g["split_ms"]})
        print("trace gap split (median ms over gaps): " + ", ".join(
            f"{k} {_median(g['split_ms'].get(k, 0.0) for g in split):.4f}"
            for k in names)
            + f"; median gap {_median(g['gap_ms'] for g in split):.4f}")
    host = [r["host_ms"].get("frame", 0) - r["host_ms"].get("wait", 0)
            for r in rows if "frame" in r["host_ms"]]
    kinds = statistics.mean(len(r["host_ms"]) for r in rows)
    print(f"trace host: own ms per frame median {_median(host)}; host span "
          f"kinds per frame {kinds:.2f}")
    print(f"trace clock: error bound {tracer.clock_error_ns()} ns over "
          f"{len(tracer.clock)} calibrations, offsets "
          f"{[o for _, o, _ in tracer.clock][-3:]}")
    print(f"trace timer resolution: {tracer.timer_resolution_ns()} ns")
    print(f"trace span cost us: {_span_cost_us(tracer)}")
    print(f"trace stamp in a graph: {_stamp_cost_us(tracer):.4f} us")
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{run.seed}.json").write_text(json.dumps(
        {"rows": rows, "gap_split": split, "events_ms": ev_ms,
         "medians": med, "clock": tracer.clock}))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--slow-ms", type=float, default=44.0)
    ap.add_argument("--out", default="build/trace_revisit")
    args, rest = ap.parse_known_args()
    captured = {}
    execute = brun.execute

    def kept(run, readers):
        captured["run"] = run
        return execute(run, readers)
    brun.execute = kept
    rc = brun.main(rest)
    if rc == 0 and "run" in captured:
        report(captured["run"], args.slow_ms, Path(args.out))
    return rc


if __name__ == "__main__":
    sys.exit(main())

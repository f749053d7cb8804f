#!/usr/bin/env python3
"""Where the time of the port's per-frame tracking step goes, on one GPU.

    python3 profile_torch_step.py [--graphs] [--warmup 4] [--frames 4]
                                  [--trace DIR]

Runs `chip_smoke.run_slice` (the depth bootstrap, then extraction ->
undistortion -> tracking, with a depth keyframe every 8th frame) over a
rendered 640x480 sequence, eagerly or, with --graphs, with extraction and
tracking replayed as CUDA graphs (captured on the first tracked frame,
inside the warm-up), and profiles the `--frames` frames that follow the
first `--warmup` tracked ones with torch.profiler, CPU and CUDA
activities. Prints per frame: wall time, device busy time (the sum of kernel
times; one stream, so kernels do not overlap), the device's idle share, the
number of kernel launches, of host-device synchronizations inside the step's
stages (run_slice's own per-stage timing synchronizations are outside them)
and of copies; the operators that synchronize; then the operators that take
the most device time. With --trace, writes a Chrome trace (tens of MB) into
DIR. Needs a CUDA device.

The profiler slows a graph's replay (it traces each of the graph's kernels),
so with --graphs the same frames run once more before, unprofiled, with a
CUDA event pair around each graph replay: that run gives the step's wall
time, the device time inside the graphs (from each replay's start on the
stream to its end, so it holds the gaps between the graph's kernels), and
the share of the wall in which the device runs none of the step's graphs.
"""
from __future__ import annotations

import argparse
import collections
import sys
import time
from pathlib import Path

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parent
STAGES = ("extract", "track", "keyframe")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--warmup", type=int, default=4)
    ap.add_argument("--frames", type=int, default=4)
    ap.add_argument("--trace", default=None)
    ap.add_argument("--graphs", action="store_true",
                    help="replay extraction and tracking as CUDA graphs")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    _, frames, depths = chip_smoke.render_sequence(
        n_frames=1 + args.warmup + args.frames)
    if args.graphs:
        unprofiled_window(chip_smoke, frames, depths, args)
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    wall = []

    def after_frame(i):
        if i == args.warmup:
            prof.start()
            wall.append(time.perf_counter())
        elif i == args.warmup + args.frames:
            wall.append(time.perf_counter())
            prof.stop()

    out = chip_smoke.run_slice(frames, depths, after_frame,
                               use_graphs=args.graphs)
    wall = (wall[1] - wall[0]) / args.frames
    events = prof.events()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA
               and e.name not in STAGES]
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3 / args.frames
    copies = sum(e.name.startswith("Memcpy") for e in kernels)

    def origin(e):
        """stage/outermost operator under it that issued event e, or None
        when e lies outside every stage."""
        name, p = "?", e.cpu_parent
        while p is not None and p.name not in STAGES:
            name, p = p.name, p.cpu_parent
        return None if p is None else f"{p.name}/{name}"
    syncs = [o for o in map(origin, (e for e in events if e.name in (
        "cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize"))) if o is not None]
    print(f"card: {chip_smoke.card_line()}")
    print(f"{'graphed' if args.graphs else 'eager'} step: "
          f"{out['captures']} captures, {out['replays']} replays")
    print(f"per frame over {args.frames} frames: wall {1e3 * wall:.2f} ms, "
          f"device busy {busy:.2f} ms, idle share "
          f"{1 - busy / (1e3 * wall):.3f}, kernel launches "
          f"{len(kernels) / args.frames:.0f}, synchronizations in the stages "
          f"{len(syncs) / args.frames:.1f}, copies {copies / args.frames:.1f}")
    for where, count in collections.Counter(syncs).most_common(10):
        print(f"  synchronizes {count / args.frames:.1f}/frame: {where}")
    print(prof.key_averages().table(sort_by="self_device_time_total",
                                    row_limit=20, max_name_column_width=60))
    if args.trace:
        out = Path(args.trace)
        out.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out / "profile_torch_step.json"))
        print(f"trace: {out / 'profile_torch_step.json'}")
    return 0


def unprofiled_window(chip_smoke, frames, depths, args):
    """The graphed slice over the same frames without the profiler: per
    frame of the window, the wall time and the device time inside the
    step's graph replays (a CUDA event pair around each)."""
    replay, spans, on, wall = torch.cuda.CUDAGraph.replay, [], [False], []

    def timed_replay(graph):
        if not on[0]:
            return replay(graph)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        replay(graph)
        b.record()
        spans.append((a, b))

    def after_frame(i):
        if i in (args.warmup, args.warmup + args.frames):
            wall.append(time.perf_counter())
            on[0] = i == args.warmup

    torch.cuda.CUDAGraph.replay = timed_replay
    try:
        chip_smoke.run_slice(frames, depths, after_frame, use_graphs=True)
    finally:
        torch.cuda.CUDAGraph.replay = replay
    torch.cuda.synchronize()
    wall = 1e3 * (wall[1] - wall[0]) / args.frames
    in_graphs = sum(a.elapsed_time(b) for a, b in spans) / args.frames
    print(f"unprofiled, per frame over {args.frames} frames: wall "
          f"{wall:.2f} ms, device inside the step's graphs {in_graphs:.2f} "
          f"ms ({len(spans) / args.frames:.0f} replays), outside them "
          f"{1 - in_graphs / wall:.3f} of the wall")


if __name__ == "__main__":
    sys.exit(main())

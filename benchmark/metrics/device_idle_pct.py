"""The device's idle share of the window, in percent: 1 - (the device
time inside the program's CUDA graph replays, a CUDA event pair around
each, the profiler off) / the window's wall time. The cell runs all its
per-frame device work in the step's graph; device work outside a graph (an
eager keyframe chain) would count as idle here. A gap inside a replay,
between its event pair, counts as busy, so this share can only understate
the idle time; the profiled tail's union of kernel intervals
(`device.busy_s` / `window_s`) counts such gaps, but under the profiler a
graph launch takes ~5 ms and the profiler's own buffer requests leave gaps
of milliseconds, so it reads far more idle than the unprofiled window
(PERF.md)."""
LAYER = "device"
UNIT = "%"
SOURCE = "program_span"
MOVES = "frames_per_s"


def install(run):
    from benchmark.harness import profile
    return profile.replay_spans(run)


def read(run):
    from benchmark.harness import profile
    if not run.replay_spans or run.window_s <= 0:
        return None
    busy_ms = sum(profile.per_frame_ms(run).values())
    return 100.0 * (1.0 - busy_ms / (1e3 * run.window_s))

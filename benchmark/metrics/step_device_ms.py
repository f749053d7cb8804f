"""Device milliseconds per frame of the per-frame step: from the frame
graph's `frame` stamp to its `frame.end` stamp (`System._frame_impl`:
extraction, line detection and `track_local_map`), on the device's own
timer, the profiler off; the in-program counterpart of
`frame_step_device_ms`, which times each replay with CUDA events from
outside.

The window's frames are read from the program's tracer
(`plslam_tpu_torch/utils/trace.py`, `System.tracer`): `install` opens a
`Tracer.window()` over the window (the clock calibrated, host spans on,
shared by every reader of the tracer), its undo closes it before the
profiled tail, and `read` takes the median over the window's frames of
`Tracer.frames()`' rows, None where the ring has overwritten part of the
window or the program has no tracer."""
LAYER = "per-frame step"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"

VALUE = lambda row: row["device_ms"].get("frame")


def install(run):
    slam = getattr(run.entry, "slam", None)
    tracer = getattr(slam, "tracer", None)
    if tracer is None or hasattr(run, "slam_trace"):
        return None       # a program without the tracer, or installed
    run.slam_trace = tracer.window()
    return run.slam_trace.close


def read(run):
    window = getattr(run, "slam_trace", None)
    return None if window is None else window.median(VALUE)

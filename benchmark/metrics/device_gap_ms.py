"""Device milliseconds between frames: from one frame's `frame.end` stamp
to the next frame's `frame` stamp on the device's timer, where the device
runs none of the frame graph (the upload, the readback and the host's turn
between two replays); the in-program counterpart of `device_idle_pct`
(median gap x frames / window).

The window's frames are read from the program's tracer
(`plslam_tpu_torch/utils/trace.py`, `System.tracer`): `install` opens a
`Tracer.window()` over the window (the clock calibrated, host spans on,
shared by every reader of the tracer), its undo closes it before the
profiled tail, and `read` takes the median over the window's frames of
`Tracer.frames()`' rows, None where the ring has overwritten part of the
window or the program has no tracer."""
LAYER = "device"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"

VALUE = lambda row: row["gap_ms"]


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

"""Device milliseconds per frame of line detection: the frame graph's
`extract.lines` stage (`System._detect_lines`: the segment detector, LBD
descriptors, undistorted endpoints), from its stamp to the next.

The window's frames are read from the program's tracer
(`plslam_tpu_torch/utils/trace.py`, `System.tracer`): `install` opens a
`Tracer.window()` over the window (the clock calibrated, host spans on,
shared by every reader of the tracer), its undo closes it before the
profiled tail, and `read` takes the median over the window's frames of
`Tracer.frames()`' rows, None where the ring has overwritten part of the
window or the program has no tracer."""
LAYER = "line detection"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"

VALUE = lambda row: row["device_ms"].get("extract.lines")


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

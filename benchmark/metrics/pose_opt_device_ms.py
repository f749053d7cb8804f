"""Device milliseconds per frame of pose optimization: the frame graph's
`track.pose_a` stage (the two 2 x 5 LM hypotheses) plus its `track.pose_b`
stage (the 4 x 10 LM with the line edges), each from its stamp to the
next.

The window's frames are read from the program's tracer
(`plslam_tpu_torch/utils/trace.py`, `System.tracer`): `install` opens a
`Tracer.window()` over the window (the clock calibrated, host spans on,
shared by every reader of the tracer), its undo closes it before the
profiled tail, and `read` takes the median over the window's frames of
`Tracer.frames()`' rows, None where the ring has overwritten part of the
window or the program has no tracer."""
LAYER = "pose optimization"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"


def _sum(*stages):
    def value(row):
        d = row["device_ms"]
        return sum(d[s] for s in stages) if all(s in d for s in stages) \
            else None
    return value


VALUE = _sum("track.pose_a", "track.pose_b")


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

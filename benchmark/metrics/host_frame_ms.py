"""Host milliseconds per frame that are the host's own: the `frame` host
span (`System.track_synced`, hand-in to the pose) less its `wait` spans
(the decision readback's wait for the device), leaving the upload, the
graph launch, the copies and the decisions' resolution.

The window's frames are read from the program's tracer
(`plslam_tpu_torch/utils/trace.py`, `System.tracer`): `install` opens a
`Tracer.window()` over the window (the clock calibrated, host spans on,
shared by every reader of the tracer), its undo closes it before the
profiled tail, and `read` takes the median over the window's frames of
`Tracer.frames()`' rows, None where the ring has overwritten part of the
window or the program has no tracer."""
LAYER = "live-camera entry"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"


def _host_own(row):
    h = row["host_ms"]
    return h["frame"] - h.get("wait", 0.0) if "frame" in h else None


VALUE = _host_own


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

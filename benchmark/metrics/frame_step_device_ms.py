"""Device milliseconds per frame inside the per-frame step's CUDA graph
replays (`models/step_graph`: extraction, line detection and
`track_local_map` with K1's three searches): a CUDA event pair around every
`CUDAGraph.replay` of the window, the profiler off (the method of
`profile_torch_step.unprofiled_window`), summed per frame; the median over
the window's frames."""
import statistics

LAYER = "per-frame step"
UNIT = "ms"
SOURCE = "program_span"
MOVES = "frames_per_s"


def install(run):
    from benchmark.harness import profile
    return profile.replay_spans(run)


def read(run):
    from benchmark.harness import profile
    per_frame = profile.per_frame_ms(run)
    return statistics.median(per_frame.values()) if per_frame else None

"""The traced tail: a few frames after the window under `torch.profiler`
(CPU and CUDA activities), and what the device did in them.

The profiler slows graph replays (it traces each kernel of a graph), so it
runs only over this short tail, never over the measured window. From its
device records inside the traced steps (`bench.frame`: hand-in to result):
the seconds in which some device operation ran (the union of their
intervals), the steps' wall time, the operations that took the most time,
and the longest idle gaps, each named by the innermost host operation that
was running at its midpoint (inside which of the harness's `bench.*`
regions, where one encloses it).
"""
from __future__ import annotations

import numpy as np
import torch
from torch.autograd import DeviceType
from torch.profiler import (ProfilerActivity, profile, record_function,
                            schedule)

NAME_CHARS = 160


class Tail:
    """The traced steps' device records, kept to the `bench.frame` ranges:
    each step's hand-in to its result on the host, which holds all of the
    step's device work (the step ends by reading its result back), and
    none of the copies the harness makes for the reference around it."""

    def __init__(self, events, frames: int):
        cpu = [e for e in events if e.device_type == DeviceType.CPU]
        self.steps = sorted((e.time_range.start, e.time_range.end)
                            for e in cpu if e.name == "bench.frame")
        inside = lambda t: any(a <= t <= b for a, b in self.steps)
        # the harness's own `bench.*` regions show on the device's timeline
        # too: they are no device work
        self.ops = [(e.name, e.time_range.start, e.time_range.end)
                    for e in events if e.device_type == DeviceType.CUDA
                    and not e.name.startswith("bench.")
                    and inside(e.time_range.start)]
        self.cpu = (np.array([e.time_range.start for e in cpu], np.float64),
                    np.array([e.time_range.end for e in cpu], np.float64),
                    [e.name for e in cpu])
        self.frames = frames
        self.window_s = sum(b - a for a, b in self.steps) / 1e6
        merged = []
        for s, e in sorted((s, e) for _, s, e in self.ops):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        self.merged = merged
        self.busy_s = sum(e - s for s, e in merged) / 1e6

    def kernels(self, part: str, within=None) -> list:
        """(start, end) microseconds of the device operations whose name
        holds `part`, in time order; with `within` (start, end), those that
        start inside it."""
        return sorted((s, e) for n, s, e in self.ops if part in n and (
            within is None or within[0] <= s <= within[1]))

    def _label(self, t: float) -> str:
        s, e, names = self.cpu
        inside = np.nonzero((s <= t) & (e >= t))[0]
        ops = [i for i in inside if not names[i].startswith("bench.")]
        regions = [i for i in inside if names[i].startswith("bench.")]
        if not ops:
            return names[regions[-1]] if regions else "(no host operation)"
        inner = names[ops[int(np.argmax(s[ops]))]]
        if regions:
            outer = names[regions[int(np.argmax(s[regions]))]]
            return f"{outer}/{inner}"
        return inner

    def breakdown(self) -> dict:
        """The ten device operations that took most time (seconds, summed
        by name) and the ten longest idle gaps inside the traced steps
        (seconds) by the host operation at their midpoint."""
        by_name = {}
        for n, s, e in self.ops:
            by_name[n] = by_name.get(n, 0.0) + (e - s) / 1e6
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
        inside = lambda t: any(a <= t <= b for a, b in self.steps)
        gaps = sorted(((b[0] - a[1], 0.5 * (a[1] + b[0]))
                       for a, b in zip(self.merged, self.merged[1:])
                       if inside(0.5 * (a[1] + b[0]))), reverse=True)[:10]
        return {"device_ops": [[n[:NAME_CHARS], v] for n, v in top],
                "idle_gaps": [[self._label(m)[:NAME_CHARS], g / 1e6]
                              for g, m in gaps]}


def tail(run, n_frames: int, warmup: int = 2) -> Tail:
    """`n_frames` more frames (steps) of the run's entry under the
    profiler, after `warmup` profiled steps whose records are dropped (the
    profiler allocates its buffers in them); step j's snapshots for the
    reference go to `run.trace_snaps[j]`. The tail's wall time is the sum
    of the traced steps' `bench.frame` ranges, hand-in to result on the
    host: the copies for the reference around each step and the trace's
    collection after the last are not in it."""
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=0, warmup=warmup,
                                     active=n_frames, repeat=1))
    run.sync()
    with prof:
        for _ in range(warmup):
            run.entry.step()
            prof.step()
        for _ in range(n_frames):
            run.trace_snaps.append([])
            with record_function("bench.step"):
                run.entry.step(keep=run.trace_snaps[-1])
            prof.step()   # after the last step, this collects the trace
    return Tail(prof.events(), n_frames)


def replay_spans(run):
    """A CUDA event pair around each CUDA graph replay while the window is
    open (the traced tail runs after it): installed once per run, shared
    by the readers that need it. Returns the undo on the first call, None
    after; the spans, (frame index, start, end), go to `run.replay_spans`."""
    if hasattr(run, "replay_spans"):
        return None
    replay = torch.cuda.CUDAGraph.replay
    spans = run.replay_spans = []

    def timed(graph):
        if not run.in_window:
            return replay(graph)
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        a.record()
        replay(graph)
        b.record()
        spans.append((run.frame_index, a, b))

    torch.cuda.CUDAGraph.replay = timed
    return lambda: setattr(torch.cuda.CUDAGraph, "replay", replay)


def per_frame_ms(run) -> dict:
    """Device milliseconds inside graph replays, per window frame."""
    out = {}
    for i, a, b in run.replay_spans:
        out[i] = out.get(i, 0.0) + a.elapsed_time(b)
    return out

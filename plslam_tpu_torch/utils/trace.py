"""The port's tracer: device stamps inside the per-frame step, host spans at
the System's layer boundaries, and one clock for both.

Each `System` owns one, `System.tracer`. It records:

- **Device stamps**, always on. A stamp is a one-thread kernel
  (`csrc/trace_stamp.cu`) that reads the device's nanosecond timer
  (`%globaltimer`) and appends (record index, code, ns) to a ring in device
  memory at a cursor the device keeps. Stamps sit inside the per-frame step,
  so they are captured into its CUDA graphs: a replay logs its frame's stage
  boundaries with no host work, behind the earlier frames' records, whether
  host spans are on or off. On the CPU a stamp appends
  `time.perf_counter_ns()` to a ring on the host instead. The host counts
  the records it has issued (`launches`: each eager stamp adds one, each
  replay the number its capture recorded, through `step_graph.counted`) and
  the frame each run of records belongs to (`set_frame`), so it knows which
  records are whose without reading the device.
- **Host spans**, off until `enable()`. Off, a span is one flag test. On, a
  span records its name, start and end (`perf_counter_ns`), its parent span
  and its frame id, and opens `torch.profiler.record_function("slam.<name>")`,
  so a profiled run shows the program's regions on the profiler's clock.
  Around work the host only enqueues (`DEVICE_SPANS`), a span also stamps
  the device at its start and end.
- **One clock.** `calibrate()` (at creation, and again when asked) places a
  stamp between two synchronized host readings and keeps the offset of the
  device's timer from `perf_counter_ns` and its error bound.

Device marks and what they measure. The frame step (`System._frame_impl`)
stamps `frame` at its start and `frame.end` at its end; between them the
stages: `extract.points` (the ORB extractor and `undistort_pixels`),
`extract.lines` (line detection) and `extract.end` from
`System._extract_impl`, and from `tracking.track_local_map` (through its
`stamp` argument) `track.search_a` (the local-map mask, the windowed search
and the windowless K1 search with its dedup), `track.pose_a` (the two 2 x 5
LM hypotheses), `track.search_b` (the local-map search and the line
search), `track.pose_b` (the 4 x 10 LM) and `track.finish` (the jump guard,
the result and `update_point_stats`), closed by `track.end`. A stage runs
from its mark to the next record; any other span from its mark to its
`.end` mark.

Rings are bounded and read only when asked: `frames()` gives per-frame rows
(device ms of each span and stage, the device gap before the frame, host ms
of each host span), `export(path)` a Chrome trace (Perfetto reads it) of the
host spans and the device spans on the host's clock, and `window()` an
interval of both for a reader. A read over an interval whose records the
ring has overwritten returns None, never a wrong number. Records are told
apart in the order the device ran them, which is the order the host issued
them on one stream.
"""
from __future__ import annotations

import bisect
import collections
import contextlib
import ctypes
import json
import statistics
import time
from typing import Optional

import numpy as np
import torch
from torch.profiler import record_function

from ..models import step_graph
from . import cuda_build

# every name a stamp or a span may carry
SPANS = ("frame", "extract.points", "extract.lines", "extract",
         "track.search_a", "track.pose_a", "track.search_b", "track.pose_b",
         "track.finish", "track", "upload", "replay", "capture", "wait",
         "resolve", "keyframe", "local_ba", "loop_detect", "sim3_stage",
         "loop_correct", "gba_round", "relocalize", "initialize", "grow",
         "calibrate")
# device marks that run to the next record of their frame
STAGES = frozenset(("extract.points", "extract.lines", "track.search_a",
                    "track.pose_a", "track.search_b", "track.pose_b",
                    "track.finish"))
# host spans around work the host only enqueues: they stamp the device too
# (not `upload`: its copy takes a few us of the device, its two stamps ~40 us
# of the host before every launch)
DEVICE_SPANS = frozenset(("keyframe", "local_ba", "loop_detect",
                          "sim3_stage", "loop_correct", "gba_round",
                          "relocalize", "initialize", "grow"))
_CODE = {name: i for i, name in enumerate(SPANS)}
NVCC_FLAGS = ["-gencode", "arch=compute_90,code=[sm_90,compute_90]",
              "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC"]
RECORDS = 1 << 16      # device records a ring holds
HOST_SPANS = 1 << 16   # host spans a ring holds

_NULL = contextlib.nullcontext()
_lib = None


def no_span(name):
    """A span that records nothing: the default of a `span` argument."""
    return _NULL


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(cuda_build.build(
            cuda_build.CSRC_DIR / "trace_stamp.cu", NVCC_FLAGS)))
        lib.plslam_trace_stamp.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_longlong, ctypes.c_int]
        lib.plslam_trace_timer_probe.argtypes = [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]
        lib.plslam_trace_stamp.restype = ctypes.c_int
        lib.plslam_trace_timer_probe.restype = ctypes.c_int
        _lib = lib
    return _lib


class Mark:
    """A position in a tracer's logs: records and host spans issued."""

    __slots__ = ("records", "spans")

    def __init__(self, records: int, spans: int):
        self.records, self.spans = records, spans


class _Span:
    __slots__ = ("tr", "name", "dev", "i", "parent", "fid", "t0", "rf")

    def __init__(self, tr, name, dev):
        self.tr, self.name, self.dev = tr, name, dev

    def __enter__(self):
        tr = self.tr
        self.i = tr.n_spans
        tr.n_spans += 1
        self.parent = tr._stack[-1] if tr._stack else -1
        self.fid = tr.fid
        tr._stack.append(self.i)
        self.rf = record_function("slam." + self.name)
        self.rf.__enter__()
        self.t0 = time.perf_counter_ns()
        # nothing stamps from a span into a graph under capture
        self.dev = self.dev and not (tr.device.type == "cuda" and
                                     torch.cuda.is_current_stream_capturing())
        if self.dev:
            tr.stamp(self.name)
        return self

    def __exit__(self, *exc):
        tr = self.tr
        if self.dev:
            tr.stamp(self.name, end=True)
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        tr._stack.pop()
        tr._spans[self.i % len(tr._spans)] = (
            self.i, self.name, self.t0, t1, self.parent, self.fid)
        return False


class _Frame:
    """The `frame` span: always timed (its seconds go to `sink`), recorded
    when host spans are on; inside another `frame` span it does nothing."""

    __slots__ = ("tr", "fid", "sink", "n", "outer", "span", "t0")

    def __init__(self, tr, fid, sink, n):
        self.tr, self.fid, self.sink, self.n = tr, fid, sink, n

    def __enter__(self):
        tr = self.tr
        self.outer = not tr._in_frame
        if not self.outer:
            return self
        tr._in_frame = True
        tr.set_frame(self.fid)
        self.span = _Span(tr, "frame", False) if tr.on else None
        if self.span is not None:
            self.span.__enter__()
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if not self.outer:
            return False
        dt = time.perf_counter() - self.t0
        tr = self.tr
        tr._in_frame = False
        if self.span is not None:
            self.span.__exit__(*exc)
        if self.sink is not None:
            self.sink.extend([dt / self.n] * self.n)
        return False


class Tracer:
    """Device stamps, host spans and the clock of one System (see the module
    docstring). `device` is the System's; the CPU logs on the host."""

    def __init__(self, device, records: int = RECORDS,
                 host_spans: int = HOST_SPANS):
        self.device = torch.device(device)
        self.on = False
        self.fid = -1               # the frame new records and spans join
        self.n_spans = 0            # host spans opened
        self._spans = [None] * host_spans
        self._stack = []            # indices of the open host spans
        self._in_frame = False
        # (first record index, frame id) at each change of frame
        self._segments = collections.deque(maxlen=records)
        self._segments.append((0, -1))
        self.capacity = records
        self.clock = []             # (host ns, device - host ns, error ns)
        step_graph.counted(self)    # self.launches: the records issued
        if self.device.type == "cuda":
            self._cursor = torch.zeros(1, dtype=torch.int64,
                                       device=self.device)
            self._log = torch.full((records, 3), -1, dtype=torch.int64,
                                   device=self.device)
            self._index = self._log.device.index
            self._fn = _load().plslam_trace_stamp
        else:
            self._log = np.full((records, 3), -1, dtype=np.int64)
        self.calibrate()

    # -- recording ------------------------------------------------------
    def stamp(self, name: str, end: bool = False):
        """Append a device record of mark `name` (its `.end` with `end`)."""
        code = 2 * _CODE[name] + int(end)
        if self.device.type == "cuda":
            err = self._fn(self._index,
                           torch.cuda.current_stream(self.device).cuda_stream,
                           self._cursor.data_ptr(), self._log.data_ptr(),
                           self.capacity, code)
            if err != 0:
                raise RuntimeError(f"trace stamp launch failed: CUDA error "
                                   f"{err}")
        else:
            i = self.launches
            self._log[i % self.capacity] = (i, code, time.perf_counter_ns())
        self.launches += 1

    def set_frame(self, fid: int):
        """Records and spans issued from now on belong to frame `fid`."""
        if fid != self.fid:
            self.fid = fid
            self._segments.append((self.launches, fid))

    def span(self, name: str):
        """A host span named `name` (one of `SPANS`); a no-op while host
        spans are off."""
        if not self.on:
            return _NULL
        return _Span(self, name, name in DEVICE_SPANS)

    def frame(self, fid: int, sink: Optional[list] = None, n: int = 1):
        """The `frame` span of frame `fid` (the first of `n`): always timed,
        its seconds appended to `sink` split over `n` frames by the
        outermost `frame` span."""
        return _Frame(self, fid, sink, n)

    def enable(self, on: bool = True):
        """Turn host spans on (or off with `on=False`)."""
        self.on = bool(on)

    def mark(self) -> Mark:
        return Mark(self.launches, self.n_spans)

    # -- the clock --------------------------------------------------------
    def calibrate(self, repeats: int = 8):
        """Place the device's timer against `perf_counter_ns`: per repeat a
        synchronize, a host reading, a stamp, a synchronize and a host
        reading; keeps the repeat of least error: (host ns at the middle,
        device ns - host ns, half the host interval)."""
        if self.device.type != "cuda":
            self.clock.append((time.perf_counter_ns(), 0, 0))
            return self.clock[-1]
        reads = []
        for _ in range(repeats):
            torch.cuda.synchronize(self.device)
            h0 = time.perf_counter_ns()
            i = self.launches
            self.stamp("calibrate")
            torch.cuda.synchronize(self.device)
            reads.append((time.perf_counter_ns() - h0, h0, i))
        log = self._log.cpu().numpy()
        best = None
        for dh, h0, i in reads:
            rec = log[i % self.capacity]
            if rec[0] != i:
                continue
            mid = h0 + dh // 2
            cand = (mid, int(rec[2]) - mid, dh // 2)
            if best is None or cand[2] < best[2]:
                best = cand
        if best is None:
            raise RuntimeError("the trace clock's stamps were not found")
        self.clock.append(best)
        return best

    def to_host_ns(self, dev_ns):
        """Device timer ns on the host's `perf_counter_ns` clock, the offset
        interpolated between the calibrations."""
        dev = np.asarray(dev_ns, dtype=np.float64)
        c = sorted(self.clock)
        at = np.array([h + o for h, o, _ in c], np.float64)
        off = np.array([o for _, o, _ in c], np.float64)
        return dev - np.interp(dev, at, off)

    def clock_error_ns(self) -> int:
        return max(e for _, _, e in self.clock)

    def timer_resolution_ns(self, n: int = 4096) -> Optional[int]:
        """The least step between distinct readings of the device's timer
        in one thread reading it back to back (CUDA); None on the CPU."""
        if self.device.type != "cuda":
            return None
        out = torch.zeros(n, dtype=torch.int64, device=self.device)
        err = _load().plslam_trace_timer_probe(
            self._index, torch.cuda.current_stream(self.device).cuda_stream,
            out.data_ptr(), n)
        if err != 0:
            raise RuntimeError(f"timer probe launch failed: CUDA error {err}")
        d = np.diff(out.cpu().numpy())
        d = d[d > 0]
        return int(d.min()) if d.size else None

    # -- reading ----------------------------------------------------------
    def records(self, start: Optional[Mark] = None,
                end: Optional[Mark] = None):
        """[(frame id, name, is end, device ns)] of the records issued
        between two marks (default: all the ring holds), in order; None if
        the ring no longer holds them all."""
        r1 = self.launches if end is None else end.records
        r0 = max(0, r1 - self.capacity) if start is None else start.records
        if r1 - r0 > self.capacity or r0 < self._segments[0][0]:
            return None
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            log = self._log.cpu().numpy()
        else:
            log = self._log
        idx = np.arange(r0, r1, dtype=np.int64)
        rec = log[idx % self.capacity]
        if not np.array_equal(rec[:, 0], idx):
            return None
        starts = [s for s, _ in self._segments]
        fids = [f for _, f in self._segments]
        out = []
        for i, code, ns in rec.tolist():
            fid = fids[bisect.bisect_right(starts, i) - 1]
            out.append((fid, SPANS[code >> 1], bool(code & 1), ns))
        return out

    def host_spans(self, start: Optional[Mark] = None,
                   end: Optional[Mark] = None):
        """[(index, name, start ns, end ns, parent index, frame id)] of the
        host spans opened between two marks and closed by now, in order of
        opening; None if the ring no longer holds them all."""
        n = len(self._spans)
        s1 = self.n_spans if end is None else end.spans
        s0 = max(0, s1 - n) if start is None else start.spans
        if s1 - s0 > n:
            return None
        out = []
        for i in range(s0, s1):
            sp = self._spans[i % n]
            if sp is None or sp[0] < i:
                continue            # still open
            if sp[0] != i:
                return None
            out.append(sp)
        return out

    def frames(self, start: Optional[Mark] = None,
               end: Optional[Mark] = None):
        """Per-frame rows between two marks (see `frame_rows`); None where
        the rings have overwritten part of the interval."""
        recs = self.records(start, end)
        spans = self.host_spans(start, end)
        if recs is None or spans is None:
            return None
        return frame_rows(recs, spans)

    def window(self) -> "Window":
        """An interval of the logs from now until its `close()`, with host
        spans on inside it (see `Window`)."""
        return Window(self)

    def export(self, path: str, start: Optional[Mark] = None,
               end: Optional[Mark] = None):
        """Write the host spans and the device spans between two marks
        (default: all the rings hold) on one timeline, the host's clock, as
        a Chrome trace (JSON; Perfetto and chrome://tracing read it).
        Returns the number of events written."""
        recs = self.records(start, end)
        spans = self.host_spans(start, end)
        if recs is None or spans is None:
            raise RuntimeError("the trace rings have overwritten part of the "
                               "interval")
        dev = [(fid, name, a, b) for fid, name, a, b in device_spans(recs)]
        if dev:
            ends = self.to_host_ns([a for _, _, a, _ in dev]
                                   + [b for _, _, _, b in dev])
            k = len(dev)
            dev = [(fid, name, ends[j], ends[k + j])
                   for j, (fid, name, _, _) in enumerate(dev)]
        t_min = min([s[2] for s in spans] + [a for _, _, a, _ in dev]
                    or [0])
        us = lambda ns: (float(ns) - t_min) / 1e3
        ev = [{"ph": "M", "pid": 0, "tid": t, "name": "thread_name",
               "args": {"name": n}} for t, n in ((0, "host"), (1, "device"))]
        for _, name, a, b, parent, fid in spans:
            ev.append({"ph": "X", "pid": 0, "tid": 0, "name": name,
                       "ts": us(a), "dur": (b - a) / 1e3,
                       "args": {"frame": fid}})
        err = self.clock_error_ns()
        for fid, name, a, b in dev:
            ev.append({"ph": "X", "pid": 0, "tid": 1, "name": name,
                       "ts": us(a), "dur": (b - a) / 1e3,
                       "args": {"frame": fid, "clock_error_us": err / 1e3}})
        with open(path, "w") as f:
            json.dump({"traceEvents": ev, "displayTimeUnit": "ms"}, f)
        return len(ev) - 2


class Window:
    """An interval of a tracer's logs for a reader: opening it calibrates
    the clock, turns host spans on and marks the start; `close()` marks the
    end, calibrates again and puts host spans back as they were. `rows()`
    is `Tracer.frames` over the interval, worked out once; it stays
    readable after the System is gone."""

    def __init__(self, tracer: Tracer):
        self.tracer = tracer
        self._was_on = tracer.on
        tracer.calibrate()
        tracer.enable()
        self.start = tracer.mark()
        self.end = None
        self._rows = False

    def close(self):
        t = self.tracer
        self.end = t.mark()
        t.calibrate()
        t.enable(self._was_on)

    def rows(self):
        if self._rows is False:
            self._rows = self.tracer.frames(self.start, self.end) \
                if self.end is not None else None
        return self._rows

    def median(self, value) -> Optional[float]:
        """The median over the interval's frames of `value(row)`, leaving
        out frames where it is None; None without any."""
        rows = self.rows()
        vals = [v for v in map(value, rows or ()) if v is not None]
        return statistics.median(vals) if vals else None


def device_spans(recs):
    """[(frame id, name, start ns, end ns)] of records in order: a stage
    (`STAGES`) runs from its mark to the next record of its frame, any other
    span from its mark to its `.end` mark (a mark without its end, or an
    end without its mark, gives none)."""
    out, stage, begun = [], {}, {}
    for fid, name, end, ns in recs:
        if fid in stage:
            s_name, s_ns = stage.pop(fid)
            out.append((fid, s_name, s_ns, ns))
        if end:
            t0 = begun.pop((fid, name), None)
            if t0 is not None:
                out.append((fid, name, t0, ns))
        elif name in STAGES:
            stage[fid] = (name, ns)
        else:
            begun[(fid, name)] = ns
    return out


def frame_rows(recs, spans) -> list:
    """One row per frame id >= 0 found in the device records `recs`
    (`Tracer.records`) or the host spans `spans` (`Tracer.host_spans`), in
    order of frame id:

    - `device_ms`: {span or stage: device ms, summed over its runs};
    - `gap_ms`: device ms from the previous row's end to this frame's
      start, where both rows have device records (a frame starts at its
      `frame` mark, else its first record; it ends at its `frame.end` mark,
      else its last record);
    - `host_ms`: {host span: host ms, summed over its runs}."""
    rows = {}

    def row(fid):
        if fid not in rows:
            rows[fid] = {"frame": fid, "device_ms": {}, "gap_ms": None,
                         "host_ms": {}, "_first": None, "_last": None,
                         "_start": None, "_end": None}
        return rows[fid]

    for fid, name, end, ns in recs:
        if fid < 0:
            continue
        r = row(fid)
        r["_first"] = ns if r["_first"] is None else r["_first"]
        r["_last"] = ns
        if name == "frame":
            r["_end" if end else "_start"] = ns
    for fid, name, a, b in device_spans(recs):
        if fid >= 0:
            d = rows[fid]["device_ms"]
            d[name] = d.get(name, 0.0) + (b - a) / 1e6
    for _, name, a, b, _, fid in spans:
        if fid >= 0:
            h = row(fid)["host_ms"]
            h[name] = h.get(name, 0.0) + (b - a) / 1e6
    out, prev_end = [], None
    for fid in sorted(rows):
        r = rows[fid]
        start = r["_start"] if r["_start"] is not None else r["_first"]
        end = r["_end"] if r["_end"] is not None else r["_last"]
        if start is not None and prev_end is not None:
            r["gap_ms"] = (start - prev_end) / 1e6
        prev_end = end
        out.append({k: v for k, v in r.items() if not k.startswith("_")})
    return out

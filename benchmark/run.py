"""Run one cell of the benchmark once.

    python3 -m benchmark.run --workload <config>.<mix> --seed <n> \
        --seconds <s> --trace <0|1>

Everything is found by name: the cell in `BENCHMARK.json`, its
configuration in `benchmark/configs/<config>.json` (whose `entry` names the
loop in `benchmark/entries/<entry>.py`), its traffic mix in
`benchmark/traffic/<mix>.json`, and with `--trace 1` the per-layer metrics
`BENCHMARK.json` lists for the cell, each read by
`benchmark/metrics/<metric>.py`.

A run: set-up (frames made on the card from the seed, the program built,
its warm-up frames, every graph captured), then a closed loop for
`--seconds` seconds of wall time, each call handing in the next frame as
the previous one returns. With `--trace 1` the metric readers' hooks are on
through the window, and a short profiled tail of frames follows it. Then
the program's state is freed, and the frozen reference judges the outputs
sampled in the window. The last line of standard output is the result's
JSON; the numbers compared, each beside its limit, are also the last lines
of standard error. Needs a CUDA device: without one (or with fewer cards
than the cell asks for) it exits with 2 and prints no result.
"""
from __future__ import annotations

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# the program's kernel caches live at fixed paths inside the checkout
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("TRITON_CACHE_DIR", "triton")):
    os.environ.setdefault(_var, str(ROOT / "build" / "benchmark_cache" / _sub))
os.environ.setdefault("USE_FLAX", "0")

import argparse  # noqa: E402
import hashlib  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import statistics  # noqa: E402

import numpy as np  # noqa: E402
import torch  # noqa: E402

from benchmark.harness import config as hconfig  # noqa: E402
from benchmark.harness import judge, profile, traffic  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "plslam_tpu")
METRICS_DIR = ROOT / "benchmark" / "metrics"
LIMITS_DIR = ROOT / "benchmark" / "limits"


def process_age() -> float:
    """Seconds since this process started (Linux `/proc`), else since this
    module was imported."""
    try:
        with open("/proc/self/stat") as f:
            start = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        return up - start / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _T_IMPORT


_T_IMPORT = time.perf_counter()


def load_benchmark() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def cell_metrics(bench: dict, cell: str, trace: bool) -> list:
    """The metric entries a run of `cell` reports: its end-to-end metrics,
    or with `trace` its per-layer ones."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def load_reader(name: str):
    """The reader module of per-layer metric `name`."""
    spec = importlib.util.spec_from_file_location(
        "benchmark.metrics." + name.replace(".", "__"),
        METRICS_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _frac(seed: int, i: int, salt: str) -> float:
    """A number in [0, 1) fixed by the seed, an index and a salt."""
    h = hashlib.sha256(f"{seed}:{salt}:{i}".encode()).digest()
    return int.from_bytes(h[:8], "little") / 2 ** 64


class Run:
    """What a run knows: the cell, its configuration and mix, the seed, the
    device, the window's records and the traced tail. Entries and metric
    readers read it."""

    def __init__(self, cell: dict, seed: int, seconds: float, trace: bool,
                 device, fields_override=None):
        self.cell = cell
        self.seed, self.seconds, self.trace = seed, seconds, trace
        self.device = torch.device(device)
        self.config = hconfig.load(cell["config"])
        self.mix = traffic.load(cell["traffic"])
        self.fields = hconfig.slam_fields(self.config)
        if fields_override:
            self.fields.update(fields_override)
        self.camera = hconfig.camera(self.fields)
        self.settings = None       # every SLAMConfig value, set by the entry
        self.records = []          # one per window step
        self.in_window = False
        self.checks = []           # sampled frames' snapshots
        self.trace_snaps = []      # the traced tail's snapshots
        self.profile = None        # profile.Tail of the traced tail
        # how the judge samples, in the mix
        self.sampling = self.mix["check"]
        self.entry = importlib.import_module(
            f"benchmark.entries.{self.config['entry']}").Entry(self)
        self._n_checked = 0

    def after_render(self):
        """Called by an entry once its set-up frames exist: the peak memory
        reading starts here, with the program."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats(self.device)

    def want_check(self, i: int) -> bool:
        """Whether window step i is sampled for the judge: drawn from the
        seed at the mix's rate, the window's second step always, at most
        the mix's `max` steps."""
        c = self.sampling
        want = self._n_checked < c["max"] and (
            i == 1 or _frac(self.seed, i, "frame") < c["rate"])
        self._n_checked += want
        return want

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


def execute(run: Run, readers: dict) -> dict:
    """Set-up, window, traced tail and judging of one run; returns what the
    result line and the checks are made from."""
    entry = run.entry
    entry.setup()
    run.sync()
    setup_s = process_age()
    c0 = entry.counters()
    undo = [r.install(run) for r in readers.values()
            if hasattr(r, "install")]
    run.in_window = True
    t0 = time.perf_counter()
    i = 0
    while time.perf_counter() - t0 < run.seconds:
        run.frame_index = i
        keep = run.checks if run.want_check(i) else None
        run.records.append(entry.step(keep=keep))
        i += 1
    wall = run.window_s = time.perf_counter() - t0
    run.in_window = False
    c1 = entry.counters()
    for u in undo:
        if u is not None:
            u()
    occupancy = entry.occupancy()
    if run.trace and run.device.type == "cuda":
        run.profile = profile.tail(run, int(run.sampling["trace_frames"]))
    peak = torch.cuda.max_memory_allocated(run.device) \
        if run.device.type == "cuda" else 0
    entry.release()
    run.sync()
    if run.device.type == "cuda":
        torch.cuda.empty_cache()
    run.reference = judge.Reference(run.settings, run.device)
    with judge.precision("fp32"):
        rows = entry.judge(run.reference)
        values = {}
        for name, r in readers.items():
            v = r.read(run)
            if v is not None:
                values[name] = v
    return dict(setup_s=setup_s, wall=wall, counters=(c0, c1), peak=peak,
                rows=rows, values=values, occupancy=occupancy)


def cell_limits(name: str) -> dict:
    """The limits of a cell's compared numbers."""
    path = LIMITS_DIR / f"{name}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def checks_of(run: Run, out: dict) -> dict:
    """Each number compared, with its limit: the cell's limits
    (`benchmark/limits/<cell>.json`) against the readings over the sampled
    frames (`judge.summary`), and the run's own conditions
    (no capture and no growth inside the window, the mix's keyframe share,
    something compared). A number with a limit and no reading fails."""
    limits = cell_limits(run.cell["name"])
    readings = judge.summary(out["rows"])
    checks = {k: {"value": readings.get(k), "limit": lim}
              for k, lim in sorted(limits.items())}
    c0, c1 = out["counters"]
    checks["captures_in_window"] = {"value": c1["captures"]
                                    - c0["captures"], "limit": 0}
    checks["growths_in_window"] = {"value": c1["growths"] - c0["growths"],
                                   "limit": 0}
    recs = run.records
    steps = max(len(recs), 1)
    share = sum(r["kf"] for r in recs) / steps
    ks = run.mix.get("keyframe_share", {})
    if "below" in ks:
        checks["keyframe_share_below"] = {"value": share,
                                          "limit": ks["below"]}
    if "above" in ks:
        checks["keyframe_share_above"] = {"value": share,
                                          "limit": ks["above"]}
    checks["frames_compared"] = {"value": len(out["rows"]), "limit": 1}
    return checks


def passed(name: str, c: dict) -> bool:
    """A number passes at or under its limit; a share `_below` strictly
    under it, `_above` strictly over it; `frames_compared` at least it. A
    number without a limit or without a reading fails."""
    v, lim = c["value"], c["limit"]
    if lim is None or v is None:
        return False
    if name == "frames_compared":
        return v >= lim
    if name.endswith("_above"):
        return v > lim
    if name.endswith("_below"):
        return v < lim
    return v <= lim


def result(run: Run, out: dict, metrics: list) -> tuple:
    """(result dict, checks) of a finished run."""
    recs = run.records
    frames = sum(r["frames"] for r in recs)
    failed = sum(r["lost"] for r in recs)
    values = {}
    for m in metrics:
        n = m["name"]
        if n == "setup_s":
            values[n] = out["setup_s"]
        elif n == "frames_per_s":
            values[n] = frames / out["wall"]
        elif n == "frame_ms_p95":
            values[n] = float(np.percentile(
                [1e3 * r["latency_s"] for r in recs], 95))
        elif n in out["values"]:
            values[n] = out["values"][n]
    checks = checks_of(run, out)
    dev = run.device
    device = {"platform": "gpu" if dev.type == "cuda" else dev.type,
              "kind": torch.cuda.get_device_name(dev)
              if dev.type == "cuda" else "cpu",
              "count": int(run.cell["chips"]),
              "memory_peak_bytes": int(out["peak"])}
    res = {"correct": all(passed(k, c) for k, c in checks.items()),
           "attempted": frames, "failed": failed,
           "metrics": {k: {"value": v, "unit": next(
               m["unit"] for m in metrics if m["name"] == k)}
               for k, v in values.items()},
           "device": device}
    if run.profile is not None:
        device["busy_s"] = run.profile.busy_s
        device["window_s"] = run.profile.window_s
        res["breakdown"] = run.profile.breakdown()
    res["checks"] = checks
    return res, checks


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in sys.modules}
                  & set(FORBIDDEN))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench = load_benchmark()
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        print(f"unknown workload {args.workload!r}", file=sys.stderr)
        return 2
    cell = cells[args.workload]
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        print(f"needs {cell['chips']} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    # one host thread: intra-op threads spinning beside the loop on a
    # shared host only take cores from it
    torch.set_num_threads(1)
    trace = bool(args.trace)
    metrics = cell_metrics(bench, cell["name"], trace)
    readers = {m["name"]: load_reader(m["name"]) for m in metrics} \
        if trace else {}
    run = Run(cell, args.seed, args.seconds, trace, "cuda")
    out = execute(run, readers)
    res, checks = result(run, out, metrics)
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {', '.join(bad)}: the benchmark and the "
              f"program may import none of {', '.join(FORBIDDEN)}",
              file=sys.stderr)
        return 3
    report(run, out, res)
    print(json.dumps(res))
    for k, c in checks.items():
        print(f"check {k}: {c['value']!r} limit {c['limit']!r} "
              f"{'ok' if passed(k, c) else 'FAIL'}", file=sys.stderr)
    return 0


def report(run: Run, out: dict, res: dict):
    """The earlier lines: counts of the window, keyframe share, the
    readings compared, occupancy."""
    c0, c1 = out["counters"]
    recs = run.records
    steps = len(recs)
    print(f"cell {run.cell['name']} seed {run.seed}: {steps} steps, "
          f"{sum(r['frames'] for r in recs)} {run.entry.label} in "
          f"{out['wall']:.3f} s; setup {out['setup_s']:.3f} s")
    print(f"window: keyframe share "
          f"{sum(r['kf'] for r in recs) / max(steps, 1):.4f}; "
          + ", ".join(f"{k} {c1[k] - c0[k]}" for k in c0))
    print("readings over the sampled frames: " + json.dumps(
        judge.summary(out["rows"])))
    print("occupancy at the window's end: "
          + ", ".join(f"{k} {v}" for k, v in out["occupancy"].items()))
    if getattr(run, "replay_spans", None):
        dev = list(profile.per_frame_ms(run).values())
        print(f"device ms inside graph replays per step: median "
              f"{statistics.median(dev):.3f}, p95 {np.percentile(dev, 95):.3f}, "
              f"max {max(dev):.3f}")
    lat = [1e3 * r["latency_s"] for r in recs]
    if lat:
        print(f"step ms: median {statistics.median(lat):.3f}, p95 "
              f"{np.percentile(lat, 95):.3f}, max {max(lat):.3f}; frames/s "
              f"{sum(r['frames'] for r in recs) / out['wall']:.4f}"
              f"{' (traced)' if run.trace else ''}")


if __name__ == "__main__":
    sys.exit(main())

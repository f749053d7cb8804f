"""The readings that a cell's limits are set from, on the card.

    python3 -m benchmark.control --workload <cell> --seeds <n> [<n> ...] \
        [--seconds <s>] [--control tf32]

For each seed, in one process: a run of the cell as `benchmark.run` makes
it (set-up, a window of `--seconds`, the reference's judgement), then the
control: the reference computed in the next precision below the
configuration's (float32 products rounded to TF32), put in the program's
place on the same sampled inputs and judged by the reference in float32.
Prints one JSON line per seed: the worst reading of each number for the
program and for the control, and whether each passes the cell's limits.
The program's readings over a dozen seeds give a limit's lower reading, the
control's its upper one (PERF.md says how each limit was set).
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from benchmark import run
from benchmark.harness import judge


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--control", default="tf32")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = run.load_benchmark()
    config, mix = args.workload.split(".", 1)
    # a cell of BENCHMARK.json, or one being calibrated before it is added
    cell = next((w for w in bench["workloads"]
                 if w["name"] == args.workload),
                {"name": args.workload, "config": config, "traffic": mix,
                 "chips": 1})
    metrics = run.cell_metrics(bench, cell["name"], False) or [
        {"name": "frames_per_s", "unit": "frames/s"}]
    for seed in args.seeds:
        r = run.Run(cell, seed, args.seconds, False, "cuda")
        out = run.execute(r, {})
        res, _ = run.result(r, out, metrics)
        with judge.precision("fp32"):
            ctrl = judge.summary(judge.control_rows(r.entry, r.reference,
                                                    args.control))
        ctrl_checks = {k: {"value": ctrl.get(k), "limit": lim}
                       for k, lim in run.cell_limits(cell["name"]).items()}
        print(json.dumps({
            "seed": seed, "correct": res["correct"],
            "program": judge.summary(out["rows"]),
            "control": ctrl,
            "control_correct": all(run.passed(k, c)
                                   for k, c in ctrl_checks.items()),
            "frames_per_s": res["metrics"].get("frames_per_s", {})
            .get("value")}), flush=True)
        del r, out
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())

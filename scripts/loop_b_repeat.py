#!/usr/bin/env python3
"""Loop (b) of `chip_smoke.py` (tests/test_loop_closure_e2e.py's box circuit
at the `SLAMConfig` defaults) with every Sim3 stage's gate counts logged:
(keyframe, candidate, matches, RANSAC inliers, LM inliers) against the
floors of 12 RANSAC inliers, 20 LM inliers and 40 matches.

- `--package port` (default): the PyTorch port on the card, `--runs` times,
  with torch's deterministic algorithms off (float atomics in BA's
  `index_add_` free to reorder), through `chip_smoke.run_system`;
- `--package jax`: the JAX package's `System` on the CPU, once.

Prints, per run, the closures, the keyframe ATEs, the stages that passed
the RANSAC floor and the highest RANSAC counts under it.

    python3 scripts/loop_b_repeat.py [--runs 2]
    JAX_PLATFORMS=cpu python scripts/loop_b_repeat.py --package jax

The port needs a CUDA device (~3 minutes per run on an H100); the JAX run
takes tens of minutes on a CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


def report(label, log, m, bad):
    passed = [s for s in log if s[3] >= 12]
    print(f"{label}: {m}; bars {'met' if not bad else bad}")
    print(f"{label}: {len(log)} Sim3 stages, {len(log) - len(passed)} under "
          f"the 12-inlier RANSAC floor; the rest as (keyframe, candidate, "
          f"matches, RANSAC inliers, LM inliers): {passed}; the 8 highest "
          f"RANSAC counts under the floor: "
          f"{sorted((s[3] for s in log if s[3] < 12), reverse=True)[:8]}",
          flush=True)


def run_jax():
    import jax
    jax.config.update("jax_platforms", "cpu")
    import chip_smoke as cs
    from plslam_tpu.models import system as jsys
    Ts, frames = cs.render_loop_sequence()
    slam = jsys.System(jsys.SLAMConfig(**dataclasses.asdict(
        cs.loop_config(small=False))))
    lc, log = slam.loop_closer, []
    stage = lc._sim3_stage

    def logged(ms, k, c, *args, **kwargs):
        out = stage(ms, k, c, *args, **kwargs)
        n_matches, n_seed, _, n_inl = out
        log.append((int(k), int(c), int(n_matches), int(n_seed), int(n_inl)))
        return out
    lc._sim3_stage = logged
    t0 = time.perf_counter()
    for i, img in enumerate(frames):
        slam.track_monocular(img, i / 30.0)
    slam.flush()
    m = cs.loop_metrics(slam, Ts)
    report(f"jax, loop (b) on the CPU ({time.perf_counter() - t0:.0f} s)",
           log, cs.format_loop(m), cs.loop_failures(m))


def run_port(runs: int):
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        sys.exit(2)
    import chip_smoke as cs
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"card: {cs.card_line()}")
    torch.use_deterministic_algorithms(False)
    Ts, frames = cs.render_loop_sequence()
    for r in range(runs):
        t0 = time.perf_counter()
        out = cs.run_system(frames, cs.loop_config(small=False),
                            record_calls=False)
        m = cs.loop_metrics(out["slam"], Ts)
        report(f"port, loop (b) run {r + 1} on the card "
               f"({time.perf_counter() - t0:.0f} s)",
               [s[:5] for s in out["sim3_log"]], cs.format_loop(m),
               cs.loop_failures(m))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "port"), default="port")
    ap.add_argument("--runs", type=int, default=2)
    args = ap.parse_args()
    if args.package == "jax":
        run_jax()
    else:
        run_port(args.runs)
    return 0


if __name__ == "__main__":
    sys.exit(main())

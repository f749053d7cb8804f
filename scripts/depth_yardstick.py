#!/usr/bin/env python3
"""The CPU yardstick of `chip_smoke.py`'s depth phases: either package's
`System` (the JAX package by default, the PyTorch port on the CPU with
`--package port`) at the phases' exact configurations
(`chip_smoke.depth_config`: the `SLAMConfig` defaults with the renderer's
camera) on

- rgbd: tests/test_depth_sensors.py's 18-frame RGB-D sequence through
  `track_rgbd` (`chip_smoke.render_rgbd_sequence`);
- stereo: its 14-frame stereo sequence, baseline 0.3, through
  `track_stereo` (`chip_smoke.render_stereo_sequence`).

Prints each run's counts, metric ATE (rigid alignment, no scale), host ms
per frame of tracking (median, p90) and whether it meets the phase's bars.

    JAX_PLATFORMS=cpu python scripts/depth_yardstick.py \\
        [--package jax|port] [--fixture rgbd|stereo]

Each fixture takes a few minutes on a CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

FIXTURES = ("rgbd", "stereo")


def make_system(package: str, cfg):
    if package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from plslam_tpu.models import system as jsys
        return jsys.System(jsys.SLAMConfig(**dataclasses.asdict(cfg)))
    from plslam_tpu_torch.models import system as tsys
    return tsys.System(cfg, device="cpu")


def run(package: str, fixture: str) -> None:
    import chip_smoke
    from plslam_tpu_torch.datasets import synthetic
    t0 = time.perf_counter()
    if fixture == "rgbd":
        Ts, frames = chip_smoke.render_rgbd_sequence()
    else:
        Ts, frames, _ = chip_smoke.render_stereo_sequence()
    slam = make_system(package, chip_smoke.depth_config(fixture))
    track = getattr(slam, f"track_{fixture}")
    init, not_ok = None, []
    for i, (a, b) in enumerate(frames):
        track(a, b, i / 30.0)
        if init is None and slam.state == "OK":
            init = i
        if slam.state != "OK":
            not_ok.append(i)
    slam.flush()
    est = {ts: np.asarray(T) for ts, T in slam.trajectory}
    idx = [i for i in range(len(Ts)) if i / 30.0 in est]
    ate = synthetic.ate_rmse(np.stack([est[i / 30.0] for i in idx]),
                             Ts[idx], align_scale=False)
    steps = 1e3 * np.asarray(slam.timings[1:])
    min_points, max_ate = chip_smoke.DEPTH_BARS[fixture]
    ok = (init == 0 and not not_ok and len(idx) == len(Ts)
          and slam.state == "OK" and slam.n_map_points() > min_points
          and ate < max_ate)
    lc = slam.loop_closer
    print(f"{package}, {fixture}: init frame {init}, frames not OK "
          f"{not_ok}, {len(idx)} poses, {slam.n_keyframes()} keyframes, "
          f"{slam.n_map_points()} points, {int(np.asarray(slam.ms.n_ln))} "
          f"lines, sensor {slam.cfg.sensor}, loops "
          f"{0 if lc is None else lc.n_loops}, global BAs {slam.n_gba_done},"
          f" growth events {slam.n_growths}; metric ATE {ate:.4f} m; host "
          f"ms per tracked frame (all stages) median "
          f"{np.median(steps):.1f} p90 {np.percentile(steps, 90):.1f}; bars "
          f"{'met' if ok else 'missed'} ({time.perf_counter() - t0:.0f} s)",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--package", choices=("jax", "port"), default="jax")
    ap.add_argument("--fixture", choices=FIXTURES)
    args = ap.parse_args()
    for fixture in FIXTURES:
        if args.fixture in (None, fixture):
            run(args.package, fixture)
    return 0


if __name__ == "__main__":
    sys.exit(main())

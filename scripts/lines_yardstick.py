#!/usr/bin/env python3
"""The CPU yardstick of `chip_smoke.py`'s lines phase (b): the JAX package's
`System` and the PyTorch port's `System` (on the CPU) over the 40-frame
line-rich sequence of tests/test_lines_help.py at that test's small widths
(256 features, 3 levels, 96 line slots), the lines-help keyframe cadence,
loop closing and map growth off, with lines on and off. Prints, per run, the
initialization frame, tracked poses, keyframes, points, lines created and
valid, line inliers per tracked frame and the ATE after Sim3 alignment.

    JAX_PLATFORMS=cpu python scripts/lines_yardstick.py [--only jax|port]

Takes a few minutes per package on one CPU core.
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


def run(make_system, frames, Ts):
    from plslam_tpu_torch.datasets import synthetic
    slam = make_system()
    t0, init = time.perf_counter(), None
    for i, img in enumerate(frames):
        slam.track_monocular(img, i / 30.0)
        if init is None and slam.state == "OK":
            init = i
    slam.flush()
    traj = {ts: np.asarray(T) for ts, T in slam.trajectory}
    idx = [i for i in range(len(frames)) if i / 30.0 in traj]
    ate = synthetic.ate_rmse(np.stack([traj[i / 30.0] for i in idx]),
                             Ts[idx]) if len(idx) >= 3 else float("nan")
    ms = slam.ms
    return dict(init=init, poses=len(idx), kf=slam.n_keyframes(),
                pts=slam.n_map_points(), ln=int(np.asarray(ms.n_ln)),
                ln_valid=int(np.asarray(ms.ln_valid).sum()),
                ln_inl=[s.get("line_inliers", 0) for s in slam.stats
                        if not s.get("lost")],
                ate=ate, seconds=time.perf_counter() - t0)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("jax", "port"))
    args = ap.parse_args()
    import chip_smoke
    Ts, frames = chip_smoke.render_lines_sequence()
    for package in ("jax", "port"):
        if args.only not in (None, package):
            continue
        for use_lines in (True, False):
            cfg = chip_smoke.lines_config(small=True, use_lines=use_lines)
            if package == "jax":
                import jax
                jax.config.update("jax_platforms", "cpu")
                from plslam_tpu.models import system as jsys
                make = lambda: jsys.System(jsys.SLAMConfig(
                    **dataclasses.asdict(cfg)))
            else:
                from plslam_tpu_torch.models import system as tsys
                make = lambda: tsys.System(cfg, device="cpu")
            r = run(make, frames, Ts)
            print(f"{package}, lines {'on' if use_lines else 'off'}: "
                  f"init frame {r['init']}, {r['poses']} poses, {r['kf']} "
                  f"keyframes, {r['pts']} points, {r['ln']} lines created, "
                  f"{r['ln_valid']} valid, line inliers per tracked frame "
                  f"{r['ln_inl']}, ATE {r['ate']:.4f} ({r['seconds']:.0f} s)",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

#!/usr/bin/env python3
"""Do lines help with the same initialization? The lines-help fixture of
`scripts/lines_yardstick.py` (tests/test_lines_help.py's 40 line-rich frames
at that test's small widths and cadence, loop closing and growth off), with
lines on and off, on

- the JAX package's `System`, and
- the PyTorch port's `System` on the CPU, its two-view initializer fed the
  minimal sets the JAX package draws for the same match mask
  (`twoview.sample_minimal_sets(PRNGKey(seed), ...)`, as
  tests/test_torch_twoview.py feeds them), instead of the port's own.

Prints each run's initialization frame, keyframes, points, lines and ATE
after Sim3 alignment, and each package's ATE ratio lines on / off.

    JAX_PLATFORMS=cpu python scripts/lines_same_init.py [--only jax|port]

A few minutes per run on a CPU.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))


def jax_sets_initializer(slam, seed: int):
    """The port System's two-view step, on the JAX package's minimal sets
    for the same match mask."""
    import jax
    import jax.numpy as jnp
    import torch
    from plslam_tpu.solvers import twoview as jtv
    from plslam_tpu_torch.geometry import camera
    from plslam_tpu_torch.solvers import twoview as ttv
    K = camera.intrinsics(slam.cam, slam.device)

    def init(generator, uv1, uv2, ok):
        sets = jtv.sample_minimal_sets(jax.random.PRNGKey(seed), ok.shape[0],
                                       jnp.asarray(ok.cpu().numpy()), 200)
        return ttv.initialize_two_view(
            None, uv1, uv2, ok, K,
            idx=torch.from_numpy(jax.device_get(sets)).long().to(ok.device))
    return init


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--only", choices=("jax", "port"))
    args = ap.parse_args()
    import jax
    jax.config.update("jax_platforms", "cpu")
    import chip_smoke
    from lines_yardstick import run
    from plslam_tpu.models import system as jsys
    from plslam_tpu_torch.models import system as tsys
    Ts, frames = chip_smoke.render_lines_sequence()
    ate = {}
    for package in ("jax", "port"):
        if args.only not in (None, package):
            continue
        for use_lines in (True, False):
            cfg = chip_smoke.lines_config(small=True, use_lines=use_lines)
            if package == "jax":
                make = lambda: jsys.System(jsys.SLAMConfig(
                    **dataclasses.asdict(cfg)))
            else:
                def make():
                    slam = tsys.System(cfg, device="cpu")
                    slam._init_two_view = jax_sets_initializer(slam, cfg.seed)
                    return slam
            r = run(make, frames, Ts)
            ate[package, use_lines] = r["ate"]
            print(f"{package}{' (JAX sets)' if package == 'port' else ''}, "
                  f"lines {'on' if use_lines else 'off'}: init frame "
                  f"{r['init']}, {r['poses']} poses, {r['kf']} keyframes, "
                  f"{r['pts']} points, {r['ln']} lines created, "
                  f"{r['ln_valid']} valid, ATE {r['ate']:.4f} "
                  f"({r['seconds']:.0f} s)", flush=True)
        print(f"{package}: ATE ratio lines on / off "
              f"{ate[package, True] / ate[package, False]:.3f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

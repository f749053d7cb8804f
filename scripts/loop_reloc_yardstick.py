#!/usr/bin/env python3
"""The CPU yardstick of `chip_smoke.py`'s relocalization and loop phases:
either package's `System` (the JAX package by default, the PyTorch port on
the CPU with `--package port`) on

- reloc: the kidnap of tests/test_reloc_e2e.py at the `SLAMConfig` defaults
  with that test's cadence pins (`chip_smoke.reloc_config`);
- loop_a: the box circuit of tests/test_loop_closure_e2e.py at its widths
  (`chip_smoke.loop_config()`);
- loop_b: the same circuit at the default widths
  (`chip_smoke.loop_config(small=False)`).

Prints each run's counts, ATEs and whether it meets the phase's bars.

    JAX_PLATFORMS=cpu python scripts/loop_reloc_yardstick.py \
        [--package jax|port] [--fixture reloc|loop_a|loop_b]

Each fixture takes several minutes (loop_b tens of minutes) on a CPU.
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

FIXTURES = ("reloc", "loop_a", "loop_b")


def make_system(package: str, cfg):
    if package == "jax":
        import jax
        jax.config.update("jax_platforms", "cpu")
        from plslam_tpu.models import system as jsys
        return jsys.System(jsys.SLAMConfig(**dataclasses.asdict(cfg)))
    from plslam_tpu_torch.models import system as tsys
    return tsys.System(cfg, device="cpu")


def kidnap(package: str):
    import chip_smoke
    xi = np.array(chip_smoke.KIDNAP_XI, np.float32)
    if package == "jax":
        import jax.numpy as jnp
        from plslam_tpu.geometry import se3

        def apply(slam):
            slam.velocity = jnp.eye(4)
            slam.T_last = se3.se3_exp(jnp.asarray(xi))
        return apply
    import torch
    from plslam_tpu_torch.geometry import se3

    def apply(slam):
        slam.velocity = torch.eye(4)
        slam.T_last = se3.se3_exp(torch.from_numpy(xi))
    return apply


def run(package: str, fixture: str) -> None:
    import chip_smoke
    t0 = time.perf_counter()
    if fixture == "reloc":
        Ts, frames = chip_smoke.render_reloc_sequence()
        slam = make_system(package, chip_smoke.reloc_config())
        r = chip_smoke.run_kidnap(slam, frames, Ts, kidnap(package))
        bad = chip_smoke.reloc_failures(r)
        print(f"{package}, reloc: {r['n_kf_before']} keyframes before the "
              f"kidnap; relocalizations (frame, inliers, anchor) "
              f"{r['relocs']}; state {r['state']} at the end, {r['kf']} "
              f"keyframes, {r['pts']} points; ATE over frames >= "
              f"{chip_smoke.RELOC_ATE_FROM} {r['ate']:.4f} over {r['poses']} "
              f"poses; bars {'met' if not bad else 'missed: ' + '; '.join(bad)}"
              f" ({time.perf_counter() - t0:.0f} s)", flush=True)
        return
    Ts, frames = chip_smoke.render_loop_sequence()
    slam = make_system(package, chip_smoke.loop_config(fixture == "loop_a"))
    for i, img in enumerate(frames):
        slam.track_monocular(img, i / 30.0)
    slam.flush()
    m = chip_smoke.loop_metrics(slam, Ts)
    bad = chip_smoke.loop_failures(m)
    print(f"{package}, {fixture}: {chip_smoke.format_loop(m)}; bars "
          f"{'met' if not bad else 'missed: ' + '; '.join(bad)} "
          f"({time.perf_counter() - t0:.0f} s)", flush=True)


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

#!/usr/bin/env python3
"""Host time of the port's tracking slice in two checkouts, in turns, on one
GPU.

    python3 compare_torch_slice.py PARENT_DIR CHANGE_DIR [--pairs 4] [--system]

Each run is a fresh process started in its checkout that renders the slice
and runs `chip_smoke.run_slice` there (48 frames, 640x480, the repository's
configuration); it prints the median step and tracking ms and K1's launch
count. With `--system` a run is instead `chip_smoke.run_system` over the
60-frame system sequence at `system_config()`, eager (the system phase's
way), and prints the median ms of its eager stages: tracking, the keyframe
chain and the local BA inside it. Pairs alternate which side runs first
(parent, change, change, parent, ...), so that the host's drift falls on
both sides alike. Needs a CUDA device.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

RUN = """
import numpy as np
import chip_smoke as cs
Ts, frames, depths = cs.render_sequence()
out = cs.run_slice(frames, depths)
step = out["ext"] + out["trk"]
print("step median %.2f ms, tracking median %.2f ms, K1 launches %d"
      % (1e3 * np.median(step), 1e3 * np.median(out["trk"]), out["launches"]))
"""

RUN_SYSTEM = """
import numpy as np
import chip_smoke as cs
Ts, frames = cs.render_system_sequence()
out = cs.run_system(frames, record_calls=False, use_graphs=False)
med = lambda k: 1e3 * np.median(out["times"][k])
print("tracking median %.2f ms, keyframe chain median %.2f ms, local BA "
      "median %.2f ms, K1 launches %d"
      % (med("track"), med("keyframe"), med("local_ba"), out["launches"]))
"""


def run(checkout: Path, code: str = RUN) -> str:
    """One run of `code` in `checkout`; returns its summary line."""
    proc = subprocess.run([sys.executable, "-c", code], cwd=checkout,
                          capture_output=True, text=True, timeout=900)
    if proc.returncode != 0:
        raise RuntimeError(f"{checkout}: exit {proc.returncode}\n"
                           f"{proc.stderr[-2000:]}")
    return proc.stdout.strip().splitlines()[-1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("parent", type=Path)
    ap.add_argument("change", type=Path)
    ap.add_argument("--pairs", type=int, default=4)
    ap.add_argument("--system", action="store_true",
                    help="the eager system phase instead of the slice")
    args = ap.parse_args()
    code = RUN_SYSTEM if args.system else RUN
    sides = [("parent", args.parent), ("change", args.change)]
    for i in range(args.pairs):
        for name, path in sides if i % 2 == 0 else sides[::-1]:
            print(f"pair {i + 1} {name}: {run(path.resolve(), code)}",
                  flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

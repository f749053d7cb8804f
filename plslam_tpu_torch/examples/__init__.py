"""Example drivers, the twins of the JAX package's `examples/*.py` (the
reference's `Examples/` programs): `mono_tum`, `mono_kitti`, `mono_euroc`,
`rgbd_tum` and `stereo_kitti`, each run as
`python -m plslam_tpu_torch.examples.<name> <settings.yaml> <sequence> ...
[--device D]` (cuda unless D names another) and callable as `main(argv)`.
They write their outputs, as the JAX drivers do, into the working
directory unless a path is given."""
from __future__ import annotations

import sys
from typing import Optional, Sequence


def parse_args(argv: Optional[Sequence[str]], n_required: int,
               flags: Sequence[str] = ("--device",)):
    """(positional arguments, {flag: value}) of a driver's command line, or
    None when fewer than `n_required` positional arguments are given. Each
    flag takes one value."""
    argv = list(sys.argv[1:] if argv is None else argv)
    pos, opts = [], {}
    i = 0
    while i < len(argv):
        a = argv[i]
        if a in flags:
            if i + 1 >= len(argv):
                raise SystemExit(f"{a} needs a value")
            opts[a] = argv[i + 1]
            i += 2
        elif a.startswith("--"):
            raise SystemExit(f"unknown option {a}; known: {', '.join(flags)}")
        else:
            pos.append(a)
            i += 1
    return (pos, opts) if len(pos) >= n_required else None


def make_system(settings: str, device: str):
    """`System(SLAMConfig.from_yaml(settings), device)`."""
    from ..models.system import SLAMConfig, System
    return System(SLAMConfig.from_yaml(settings), device=device)


def print_times(times, mean: bool = True) -> None:
    """The reference's summary: median (and mean) tracking time."""
    import numpy as np
    times = sorted(times)
    print(f"median tracking time: {times[len(times) // 2] * 1000:.1f} ms")
    if mean:
        print(f"mean tracking time:   {np.mean(times) * 1000:.1f} ms")

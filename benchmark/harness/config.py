"""A configuration's data file in, the program's settings out.

A configuration (`benchmark/configs/<config>.json`) holds the upstream
settings it comes from under their own keys (`settings`, the schema of
PL-SLAM's `Examples/Monocular/*.yaml`), the system's own choices
(`system`: sensor, features on or off, map capacities) and the entry
that drives it (`benchmark/entries/<entry>.py`). `slam_fields`
maps them onto the port's `SLAMConfig` fields by the rules of the port's
`SLAMConfig.from_yaml` (copied here: the card's machine may lack PyYAML, and
the mapping is part of the deployment the benchmark fixes); `camera` gives
the renderer its intrinsics, distortion, size and frame rate.
"""
from __future__ import annotations

import json
from pathlib import Path

CONFIG_DIR = Path(__file__).resolve().parents[1] / "configs"


def load(name: str) -> dict:
    """The configuration `name` from its data file."""
    with open(CONFIG_DIR / f"{name}.json") as f:
        return json.load(f)


def slam_fields(config: dict) -> dict:
    """`SLAMConfig` keyword arguments of a configuration: its upstream
    settings as `SLAMConfig.from_yaml` reads them (feature budgets rounded
    up to the port's static multiples), then its `system` choices."""
    d = config["settings"]
    g = lambda k, default: d.get(k, default)
    fx = g("Camera.fx", 517.3)
    bf = float(g("Camera.bf", 0.0))
    th_depth_units = float(g("ThDepth", 40.0))
    dmf = float(g("DepthMapFactor", 1.0))
    out = dict(
        fx=fx, fy=g("Camera.fy", 516.5),
        cx=g("Camera.cx", 318.6), cy=g("Camera.cy", 255.3),
        k1=g("Camera.k1", 0.0), k2=g("Camera.k2", 0.0),
        p1=g("Camera.p1", 0.0), p2=g("Camera.p2", 0.0),
        k3=g("Camera.k3", 0.0),
        width=int(g("Camera.width", 640)),
        height=int(g("Camera.height", 480)),
        fps=g("Camera.fps", 30.0),
        rgb_order=bool(int(g("Camera.RGB", 1))),
        baseline=(bf / fx) if bf > 0 else 0.08,
        th_depth=bf * th_depth_units / fx if bf > 0 else 40.0,
        depth_map_factor=dmf if dmf > 0 else 1.0,
        n_features=-(-int(g("ORBextractor.nFeatures", 1000)) // 256) * 256,
        n_levels=int(g("ORBextractor.nLevels", 8)),
        scale_factor=g("ORBextractor.scaleFactor", 1.2),
        th_fast_high=g("ORBextractor.iniThFAST", 20.0),
        th_fast_low=g("ORBextractor.minThFAST", 7.0),
        subpixel=bool(int(g("ORBextractor.subpixel", 0))),
        n_lf=-(-int(g("LINEextractor.nFeatures", 200)) // 64) * 64,
        line_n_levels=int(g("LINEextractor.nLevels", 1)),
        line_scale=g("LINEextractor.scaleFactor", 1.2),
        min_line_length=float(g("LINEextractor.min_line_length", 0.0)),
    )
    out.update(config.get("system", {}))
    return out


def camera(fields: dict) -> dict:
    """The renderer's camera: intrinsics, distortion, size, frame rate."""
    return {k: fields[k] for k in ("fx", "fy", "cx", "cy", "k1", "k2", "p1",
                                   "p2", "k3", "width", "height", "fps")}

"""Map checkpoints and the numpy converter.

`from_numpy` turns a dict of numpy arrays (one per `MapState` field, e.g.
`np.asarray` of each field of a JAX `MapState`) into the port's `MapState`;
`to_numpy` is its inverse. `save_map` writes the npz of
`plslam_tpu.mapstate.checkpoint.save_map`, field for field, so each
package's loader reads the other's files; `load_map` reads it, with the JAX
loader's defaults for fields added after a checkpoint was written.
`save_point_cloud` writes the JAX package's ASCII PLY of the valid points.
"""
from __future__ import annotations

import numpy as np
import torch

from .state import FIELDS, MapConfig, MapState, field_specs

_NP_DTYPE = {torch.float32: np.float32, torch.uint8: np.uint8,
             torch.bool: np.bool_, torch.int32: np.int32}


def _capacities(arrays) -> MapConfig:
    K, N = arrays["kf_pt_idx"].shape
    return MapConfig(max_kf=K, max_pt=arrays["pt_xyz"].shape[0],
                     max_ln=arrays["ln_valid"].shape[0], n_kp=N,
                     n_lf=arrays["kf_ln_idx"].shape[1])


def from_numpy(arrays, device) -> MapState:
    """{field: np.ndarray} -> MapState on `device`.

    Raises ValueError on a missing or extra field, or on a dtype or shape
    that differs from the JAX package's."""
    missing = set(FIELDS) - set(arrays)
    extra = set(arrays) - set(FIELDS)
    if missing or extra:
        raise ValueError(f"map fields: missing {sorted(missing)}, "
                         f"extra {sorted(extra)}")
    specs = field_specs(_capacities(arrays))
    out = {}
    for name in FIELDS:
        a = np.asarray(arrays[name])
        shape, dtype = specs[name]
        if name == "kf_bow":
            shape = (shape[0], a.shape[1])
        if a.dtype != _NP_DTYPE[dtype]:
            raise ValueError(f"{name}: dtype {a.dtype}, expected "
                             f"{np.dtype(_NP_DTYPE[dtype])}")
        if a.shape != shape:
            raise ValueError(f"{name}: shape {a.shape}, expected {shape}")
        out[name] = torch.from_numpy(np.array(a, order="C")).to(device)
    return MapState(**out)


def to_numpy(ms: MapState) -> dict:
    """MapState -> {field: np.ndarray}, one host copy per field."""
    return {name: getattr(ms, name).cpu().numpy() for name in FIELDS}


def save_map(ms: MapState, path):
    """Write the map as the JAX package's compressed npz checkpoint."""
    np.savez_compressed(path, **to_numpy(ms))


def save_point_cloud(ms: MapState, path):
    """ASCII PLY of the valid map points (`System::SavePointCloud`), the
    text the JAX package's writer produces."""
    pts = ms.pt_xyz.cpu().numpy()[ms.pt_valid.cpu().numpy()]
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(pts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        f.write("end_header\n")
        for p in pts:
            f.write(f"{p[0]:.6f} {p[1]:.6f} {p[2]:.6f}\n")


def load_map(path, device) -> MapState:
    """Read a `plslam_tpu` map checkpoint (npz) onto `device`."""
    with np.load(path) as data:
        arrays = {f: data[f] for f in data.files}
    defaults = {
        "pt_desc_acc": lambda: np.asarray(arrays["pt_desc"], np.uint8),
        "pt_desc_cnt": lambda: (arrays["pt_n_obs"] > 0).astype(np.int32),
        "ln_cond": lambda: np.ones(arrays["ln_valid"].shape[0], np.float32),
        "kf_ur": lambda: np.full(arrays["kf_pt_idx"].shape, -1.0, np.float32),
    }
    for name, make in defaults.items():
        if name not in arrays:
            arrays[name] = make()
    return from_numpy(arrays, device)

"""The map as the reference reads it: a namespace of the port's map fields,
copied from the program's map at a frame (`MapState(**fields)`)."""
from __future__ import annotations

from types import SimpleNamespace


class MapState(SimpleNamespace):
    """Fields by name (`pt_xyz`, `kf_pt_idx`, `n_kf`, ...), each a tensor
    with the port's shape and dtype."""

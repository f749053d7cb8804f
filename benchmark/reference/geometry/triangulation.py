"""A 2-D line through two pixels.

Frozen copy of the port's `geometry/triangulation.line_from_endpoints_2d`,
the one function of that module that line detection and tracking use.
"""
from __future__ import annotations

import torch


def line_from_endpoints_2d(uv_a, uv_b):
    """Homogeneous 2-D line (...,3) through two pixels, scaled so that
    (l0, l1) is a unit normal."""
    one = torch.ones_like(uv_a[..., :1])
    l = torch.linalg.cross(torch.cat([uv_a, one], -1),
                           torch.cat([uv_b, one], -1))
    return l / torch.linalg.vector_norm(l[..., :2], dim=-1,
                                        keepdim=True).clamp_min(1e-12)

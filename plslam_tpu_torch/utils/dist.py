"""Contiguous ranges of an axis, and the sum over the ranks of a mesh.

The low layer under `optim.local_ba` (its landmark ranges and the
all-reduce of its camera system and costs) and `parallel/mesh.py` (a
rank's share of an axis, the gather). A mesh here is anything with a
`group` attribute, the `torch.distributed` process group to reduce over
(None: the default group), as `parallel.mesh.Mesh` has; None stands for
one process.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def ranges(n: int, k: int) -> list:
    """n items cut into k contiguous ranges [lo, hi) of ceil(n / k), the
    last ones shorter: a mesh's ranks' shares, and the ranges one process
    reduces in turn (`optim.local_ba`)."""
    step = -(-n // k)
    return [(min(i * step, n), min((i + 1) * step, n)) for i in range(k)]


def psum(mesh, *xs: torch.Tensor) -> tuple:
    """The sums of `xs` (one dtype) over the ranks of `mesh`, in one
    all-reduce; `xs` unchanged without a mesh."""
    if mesh is None:
        return xs
    flat = torch.cat([x.reshape(-1) for x in xs])
    dist.all_reduce(flat, group=mesh.group)
    out, at = [], 0
    for x in xs:
        out.append(flat[at:at + x.numel()].view(x.shape))
        at += x.numel()
    return tuple(out)

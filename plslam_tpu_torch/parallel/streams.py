"""Multi-stream tracking and edge-sharded normal equations.

Port of `plslam_tpu/parallel/streams.py`. The JAX package's scale-out axis
is a leading `stream` batch dimension (`jax.vmap`, sharded over a device
mesh); here it is `torch.func.vmap` on each rank's card, the stream axis of
every tensor batched in place, and K1 one launch per batched search
(`ops/gated_match.py`). A mesh (`make_mesh`, `parallel/mesh.py`) is a
`torch.distributed` process group, one process per rank: `shard_streams`
keeps a rank's contiguous share of the stream axis and `gather_streams`
brings the shares back to every rank, as the JAX package's global array
reads whole on every device.

The edge-sharded pose system reduces each rank's share of the edges to
H (6, 6) and b (6,) and all-reduces them (the JAX package's `psum`). In one
process `sharded_pose_normal_equations` cuts the edge axis into `n_shards`
ranges and reduces them in turn, a running sum in place of the all-reduce.
"""
from __future__ import annotations

from functools import partial

import torch
from torch.utils import _pytree

from ..models import tracking
from ..optim import residuals
from .mesh import (Mesh, gather, init_process, make_mesh,  # noqa: F401
                   psum, share, spawn)


def batched_track_step(cam, scale_factors, sigma2_levels, n_levels, scale):
    """`track_local_map` under `torch.func.vmap` over a leading stream
    axis: a function (ms_batch, feats_batch, T_pred_batch) -> TrackResult
    batch, every field with the stream axis in front."""
    f = partial(tracking.track_local_map, cam,
                scale_factors=scale_factors, sigma2_levels=sigma2_levels,
                n_levels=n_levels, scale=scale)
    return torch.func.vmap(f)


def shard_streams(mesh: Mesh, tree):
    """This rank's contiguous share of a stream-batched pytree (every
    tensor of at least one dimension cut along its leading stream axis,
    which the world size must divide), on the rank's device; scalars and
    other leaves stay as they are, replicated."""
    def cut(x):
        if not torch.is_tensor(x):
            return x
        if x.dim() == 0:
            return x.to(mesh.device)
        if x.shape[0] % mesh.world:
            raise ValueError(f"{x.shape[0]} streams over {mesh.world} ranks")
        lo, hi = share(mesh, x.shape[0])
        return x[lo:hi].to(mesh.device)
    return _pytree.tree_map(cut, tree)


def gather_streams(mesh: Mesh, x: torch.Tensor) -> torch.Tensor:
    """The ranks' shares of the stream axis of `x`, in stream order, on
    every rank."""
    return gather(mesh, x, 0)


def _normal_equations(cam, T, xyz, uv, w):
    r, J, _, z = residuals.point_residual(cam, T, xyz, uv)
    Jm = J * (w * (z > 0))[:, None, None]
    return (torch.einsum("nij,nik->jk", Jm, J),
            -torch.einsum("nij,ni->j", Jm, r))


def sharded_pose_normal_equations(*args, n_shards: int = 1):
    """H (6, 6) and b (6,) of a pose-only Gauss-Newton step over the edges
    (pt_xyz (E, 3), pt_uv (E, 2), pt_w (E,)), in one of two forms.

    `(mesh, cam, T, pt_xyz, pt_uv, pt_w)`, the JAX package's: every rank
    holds the edges, reduces its share (the edge axis cut into `world`
    ranges as `tensor_split` cuts it) and all-reduces the blocks.
    `(cam, T, pt_xyz, pt_uv, pt_w, n_shards=1)`: one process reduces the
    `n_shards` ranges in turn and sums their blocks."""
    if isinstance(args[0], Mesh):
        mesh, cam, T, *edges = args
        return psum(mesh, *_normal_equations(
            cam, T, *(e.tensor_split(mesh.world)[mesh.rank] for e in edges)))
    cam, T, pt_xyz, pt_uv, pt_w = args[:5]
    n_shards = args[5] if len(args) > 5 else n_shards
    H = b = None
    for xyz, uv, w in zip(pt_xyz.tensor_split(n_shards),
                          pt_uv.tensor_split(n_shards),
                          pt_w.tensor_split(n_shards)):
        H_i, b_i = _normal_equations(cam, T, xyz, uv, w)
        H, b = (H_i, b_i) if H is None else (H + H_i, b + b_i)
    return H, b

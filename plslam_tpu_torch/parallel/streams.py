"""Multi-stream tracking and edge-sharded normal equations on one card.

Port of `plslam_tpu/parallel/streams.py`. The JAX package's scale-out axis
is a leading `stream` batch dimension (`jax.vmap`, sharded over a device
mesh); here it is `torch.func.vmap` on one card, the stream axis of every
tensor batched in place, and K1 one launch per batched search
(`ops/gated_match.py`).

The JAX package's edge-sharded pose system reduces each device's share of
the edges and `psum`s the 6 x 6 blocks over the mesh. On one card
`sharded_pose_normal_equations` cuts the edge axis into `n_shards` ranges
and reduces them in turn, a running sum in place of the `psum`.

`make_mesh` and `shard_streams` place arrays on a device mesh. One card has
none, so they have no counterpart here: they wait for a multi-card need
(torch.distributed over NCCL, ROADMAP).
"""
from __future__ import annotations

from functools import partial

import torch

from ..models import tracking
from ..optim import residuals


def batched_track_step(cam, scale_factors, sigma2_levels, n_levels, scale):
    """`track_local_map` under `torch.func.vmap` over a leading stream
    axis: a function (ms_batch, feats_batch, T_pred_batch) -> TrackResult
    batch, every field with the stream axis in front."""
    f = partial(tracking.track_local_map, cam,
                scale_factors=scale_factors, sigma2_levels=sigma2_levels,
                n_levels=n_levels, scale=scale)
    return torch.func.vmap(f)


def sharded_pose_normal_equations(cam, T, pt_xyz, pt_uv, pt_w,
                                  n_shards: int = 1):
    """H (6, 6) and b (6,) of a pose-only Gauss-Newton step over the edges
    (pt_xyz (E, 3), pt_uv (E, 2), pt_w (E,)), the edge axis reduced in
    `n_shards` ranges whose blocks are summed in turn."""
    H = b = None
    for xyz, uv, w in zip(pt_xyz.tensor_split(n_shards),
                          pt_uv.tensor_split(n_shards),
                          pt_w.tensor_split(n_shards)):
        r, J, _, z = residuals.point_residual(cam, T, xyz, uv)
        Jm = J * (w * (z > 0))[:, None, None]
        H_i = torch.einsum("nij,nik->jk", Jm, J)
        b_i = -torch.einsum("nij,ni->j", Jm, r)
        H, b = (H_i, b_i) if H is None else (H + H_i, b + b_i)
    return H, b

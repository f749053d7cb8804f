"""Landmark-sharded bundle adjustment on one card.

Port of `plslam_tpu/parallel/sharded_ba.py`. The JAX package shards the
landmark axes of a `BAProblem` over a device mesh: each device reduces its
landmarks' Schur blocks into the camera system, one `psum` per LM iteration
assembles it, and the small dense solve runs replicated. On one card the
landmark axes are cut into `n_shards` ranges that `optim.local_ba` reduces
in turn (a running sum in place of the `psum`), so the accept/reject
decisions use the summed cost as in the JAX code, and the peak memory of
the per-landmark blocks falls with `n_shards`.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..optim import local_ba
from ..optim.local_ba import BAProblem, BAResult


def prepare_problem(prob: BAProblem, n_shards: int) -> BAProblem:
    """Pad the landmark axes to a multiple of `n_shards` (padded landmarks
    masked out, their observation variances 1) and make the per-line
    information an (L,) tensor, as the JAX package prepares a problem for
    its mesh."""
    Pn = prob.pt_mask.shape[0]
    Ln = prob.ln_mask.shape[0]

    def pad_to(x, n, axis, fill=0):
        want = -(-n // n_shards) * n_shards
        if want == n:
            return x
        pad = [0, 0] * (x.dim() - axis - 1) + [0, want - n]
        return F.pad(x, pad, value=fill)

    ln_info = prob.ln_info
    if not torch.is_tensor(ln_info) or ln_info.dim() == 0:
        ln_info = torch.full((Ln,), float(ln_info),
                             device=prob.ln_mask.device)
    if prob.obs_ur is not None:
        prob = prob._replace(obs_ur=pad_to(prob.obs_ur, Pn, 1))
    return prob._replace(
        pt_xyz=pad_to(prob.pt_xyz, Pn, 0),
        pt_mask=pad_to(prob.pt_mask, Pn, 0),
        obs_uv=pad_to(prob.obs_uv, Pn, 1),
        obs_mask=pad_to(prob.obs_mask, Pn, 1),
        obs_sigma2=pad_to(prob.obs_sigma2.clamp_min(1e-6), Pn, 1, fill=1.0),
        ln_xyz=pad_to(prob.ln_xyz, Ln, 0),
        ln_mask=pad_to(prob.ln_mask, Ln, 0),
        ln_obs_l2d=pad_to(prob.ln_obs_l2d, Ln, 1),
        ln_obs_mask=pad_to(prob.ln_obs_mask, Ln, 1),
        ln_info=pad_to(ln_info, Ln, 0),
    )


def sharded_bundle_adjust(prob: BAProblem, cam, n_shards: int,
                          iters_a: int = 5, iters_b: int = 10) -> BAResult:
    """The staged BA (robust rounds -> demotion -> rounds -> verdicts) with
    the landmark axes reduced in `n_shards` ranges. `prob` is prepared with
    `prepare_problem` (its landmark axes divisible by `n_shards`)."""
    return local_ba.bundle_adjust(prob, cam, iters_a=iters_a,
                                  iters_b=iters_b, n_shards=n_shards)

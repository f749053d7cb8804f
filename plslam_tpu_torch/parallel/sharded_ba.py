"""Landmark-sharded bundle adjustment over a mesh, or in one process.

Port of `plslam_tpu/parallel/sharded_ba.py`. The JAX package shards the
landmark axes of a `BAProblem` over a device mesh: each device reduces its
landmarks' Schur blocks into the camera system, one `psum` per LM iteration
assembles it, and the small dense solve runs replicated. Here a mesh is a
`torch.distributed` process group (`parallel/mesh.py`): `shard_problem`
keeps a rank's landmark range (cameras, `bf` replicated), `optim.local_ba`
all-reduces the camera system and the costs, so every rank takes the same
accept / reject decisions, and `gather_result` brings the landmarks back
to every rank. Rank r's range is the r-th of `local_ba`'s ranges, so a
world of W ranks and one process reducing W ranges in turn (a running sum
in place of the all-reduce) reduce the same landmarks; in one process the
peak memory of the per-landmark blocks falls with the number of ranges.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..optim import local_ba
from ..optim.local_ba import BAProblem, BAResult
from .mesh import Mesh, gather, share

AXIS = "lm"


def prepare_problem(prob: BAProblem, n_shards: int) -> BAProblem:
    """Pad the landmark axes to a multiple of `n_shards` (the world size of
    a mesh; padded landmarks masked out, their observation variances 1) and
    make the per-line information an (L,) tensor, as the JAX package
    prepares a problem for its mesh."""
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


def shard_problem(mesh: Mesh, prob: BAProblem) -> BAProblem:
    """This rank's share of a prepared problem (`prepare_problem`) on its
    device: the landmark axes cut to the rank's range, the cameras and
    `bf` replicated."""
    P, L = prob.pt_mask.shape[0], prob.ln_mask.shape[0]
    if P % mesh.world or L % mesh.world:
        raise ValueError(f"{P} points and {L} lines over {mesh.world} ranks:"
                         f" prepare the problem for the mesh first")
    sub = local_ba._shard(prob, *share(mesh, P), *share(mesh, L))
    return sub._replace(**{k: v.to(mesh.device)
                           for k, v in sub._asdict().items()
                           if torch.is_tensor(v)})


def gather_result(mesh: Mesh, res: BAResult) -> BAResult:
    """Every rank's landmarks of a result on every rank (the cameras and
    the cost are already replicated)."""
    return res._replace(pt_xyz=gather(mesh, res.pt_xyz, 0),
                        ln_xyz=gather(mesh, res.ln_xyz, 0),
                        obs_inlier=gather(mesh, res.obs_inlier, 1),
                        ln_obs_inlier=gather(mesh, res.ln_obs_inlier, 1))


def sharded_bundle_adjust(mesh, prob: BAProblem, cam, iters_a: int = 5,
                          iters_b: int = 10) -> BAResult:
    """The staged BA (robust rounds -> demotion -> rounds -> verdicts) of a
    prepared problem (`prepare_problem`, its landmark axes divisible by the
    world size), the JAX package's signature. `mesh`: a `Mesh`, every rank
    holding the whole problem and returning the whole result, each
    reducing its landmark range with one all-reduce of the camera system
    per LM iteration; or an int n, one process reducing n ranges in
    turn."""
    if not isinstance(mesh, Mesh):
        return local_ba.bundle_adjust(prob, cam, iters_a=iters_a,
                                      iters_b=iters_b, n_shards=mesh)
    res = local_ba.bundle_adjust(shard_problem(mesh, prob), cam,
                                 iters_a=iters_a, iters_b=iters_b, mesh=mesh)
    return gather_result(mesh, res)

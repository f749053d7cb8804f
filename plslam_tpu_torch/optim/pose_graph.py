"""Sim3 essential-graph optimization (`Optimizer::OptimizeEssentialGraph`).

Port of `plslam_tpu/optim/pose_graph.py`: 7-dof similarity poses per
keyframe, relative Sim3 edges (spanning tree, strong covisibility, loop
edges), Levenberg-Marquardt over a dense (7K, 7K) system. The edge residual
is ``e_ij = log(S_ij_meas o S_j o S_i^-1)`` with left-multiplied updates on
both nodes; its two 7x7 Jacobians come from `torch.func.jacfwd` under
`torch.func.vmap` over the edges.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd, vmap

from ..geometry import sim3 as sim3_mod
from ..geometry.sim3 import Sim3


class PoseGraphEdges(NamedTuple):
    """Fixed-size edge set. i / j: (E,) node ids; meas: the Sim3
    measurements S_ij = S_i o S_j^-1; mask: (E,) validity; weight: (E,)."""
    i: torch.Tensor
    j: torch.Tensor
    meas: Sim3
    mask: torch.Tensor
    weight: torch.Tensor


def _edge_residual(xi_i, xi_j, S_i: Sim3, S_j: Sim3, meas: Sim3):
    Si = sim3_mod.compose(sim3_mod.expmap(xi_i), S_i)
    Sj = sim3_mod.compose(sim3_mod.expmap(xi_j), S_j)
    err = sim3_mod.compose(meas, sim3_mod.compose(Sj, sim3_mod.inverse(Si)))
    return sim3_mod.logmap(err)                                    # (..., 7)


def _per_edge(si_s, si_R, si_t, sj_s, sj_R, sj_t, m_s, m_R, m_t):
    """(r (7,), dr/dxi_i (7, 7), dr/dxi_j (7, 7)) of one edge at zero. The
    edge runs as a batch of one: forward-mode AD gives a 0-d tensor
    combined with a Python scalar a float64 tangent."""
    one = lambda s, R, t: Sim3(s[None], R[None], t[None])
    Si, Sj, M = one(si_s, si_R, si_t), one(sj_s, sj_R, sj_t), \
        one(m_s, m_R, m_t)
    zero = torch.zeros(1, 7, dtype=si_t.dtype, device=si_t.device)
    f = lambda a, b: _edge_residual(a, b, Si, Sj, M)[0]
    Ji, Jj = jacfwd(f, argnums=(0, 1))(zero, zero)               # (7, 1, 7)
    return f(zero, zero), Ji[:, 0], Jj[:, 0]


def _gather(S: Sim3, idx) -> Sim3:
    return Sim3(S.s[idx], S.R[idx], S.t[idx])


def optimize_essential_graph(nodes: Sim3, node_mask, fixed_mask,
                             edges: PoseGraphEdges, iters: int = 20,
                             fix_scale: bool = False) -> Sim3:
    """nodes: Sim3 with batch (K,); node_mask / fixed_mask: (K,) bool.
    Returns the optimized Sim3 (K,)."""
    K = nodes.s.shape[0]
    device = nodes.s.device
    ei, ej = edges.i.long(), edges.j.long()
    w = (edges.mask & node_mask[ei] & node_mask[ej]).to(torch.float32) \
        * edges.weight
    free = (node_mask & ~fixed_mask).to(torch.float32)
    F = free[:, None] * free[None, :]
    eye7 = torch.eye(7, device=device)
    ar = torch.arange(K, device=device)

    def total_cost(S: Sim3):
        zeros = torch.zeros((ei.shape[0], 7), device=device)
        r = _edge_residual(zeros, zeros, _gather(S, ei), _gather(S, ej),
                           edges.meas)
        return torch.sum(torch.sum(r * r, -1) * w)

    S, lam = nodes, torch.full((), 1e-8, device=device)
    for _ in range(iters):
        Si, Sj = _gather(S, ei), _gather(S, ej)
        r, Ji, Jj = vmap(_per_edge)(Si.s, Si.R, Si.t, Sj.s, Sj.R, Sj.t,
                                    edges.meas.s, edges.meas.R, edges.meas.t)
        Jiw, Jjw = Ji * w[:, None, None], Jj * w[:, None, None]
        H = torch.zeros((K, K, 7, 7), device=device)
        H.index_put_((ei, ei), torch.einsum("eab,eac->ebc", Jiw, Ji),
                     accumulate=True)
        H.index_put_((ej, ej), torch.einsum("eab,eac->ebc", Jjw, Jj),
                     accumulate=True)
        Hij = torch.einsum("eab,eac->ebc", Jiw, Jj)
        H.index_put_((ei, ej), Hij, accumulate=True)
        H.index_put_((ej, ei), Hij.transpose(-1, -2), accumulate=True)
        b = torch.zeros((K, 7), device=device)
        b.index_add_(0, ei, -torch.einsum("eab,ea->eb", Jiw, r))
        b.index_add_(0, ej, -torch.einsum("eab,ea->eb", Jjw, r))
        H = H * F[:, :, None, None]
        b = b * free[:, None]
        diag = H[ar, ar].diagonal(dim1=-2, dim2=-1)                 # (K, 7)
        H[ar, ar] += (lam * diag.clamp_min(1e-6)[:, :, None] * eye7
                      + (1.0 - free)[:, None, None] * eye7 + 1e-8 * eye7)
        Hd = H.permute(0, 2, 1, 3).reshape(K * 7, K * 7)
        dx = torch.linalg.solve_ex(Hd, b.reshape(K * 7, 1),
                                   check_errors=False).result.reshape(K, 7)
        if fix_scale:
            dx = torch.cat([dx[:, :6], torch.zeros_like(dx[:, 6:])], 1)
        dx = dx * free[:, None]
        S_new = sim3_mod.compose(sim3_mod.expmap(dx), S)
        c_old, c_new = total_cost(S), total_cost(S_new)
        ok = (c_new < c_old) & torch.isfinite(c_new)
        S = Sim3(torch.where(ok, S_new.s, S.s), torch.where(ok, S_new.R, S.R),
                 torch.where(ok, S_new.t, S.t))
        lam = torch.where(ok, (lam * 0.5).clamp_min(1e-16),
                          (lam * 4.0).clamp_max(1e8))
    return S

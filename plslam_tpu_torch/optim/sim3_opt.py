"""Sim3 refinement between two keyframes (`Optimizer::OptimizeSim3`).

Port of `plslam_tpu/optim/sim3_opt.py`: one Sim3 vertex, fixed matched
landmark pairs, forward and inverse projection residuals, Huber IRLS and a
chi2 re-selection between two LM passes. The Jacobian of the (2N, 2)
residuals in the 7-dim tangent comes from `torch.func.jacfwd` (7 JVPs per
iteration); the LM loops are Python loops whose accept tests are
`torch.where`, so nothing here waits for the device.
"""
from __future__ import annotations

from typing import NamedTuple

import torch
from torch.func import jacfwd

from ..geometry import sim3 as sim3_mod
from ..geometry.sim3 import Sim3

CHI2 = 10.0  # th2 of `OptimizeSim3` (`src/LoopClosing.cc:326`)


class Sim3OptResult(NamedTuple):
    S12: Sim3
    inliers: torch.Tensor
    n_inliers: torch.Tensor


def _select(ok, a: Sim3, b: Sim3) -> Sim3:
    return Sim3(torch.where(ok, a.s, b.s), torch.where(ok, a.R, b.R),
                torch.where(ok, a.t, b.t))


def optimize_sim3(cam, S12_init: Sim3, X1, X2, uv1, uv2, mask,
                  sigma2_1=None, sigma2_2=None, iters: int = 10,
                  fix_scale: bool = False) -> Sim3OptResult:
    """S12 maps keyframe-2 camera coordinates into keyframe 1's: X1 ~
    S12(X2) for the `mask` pairs, observed at uv1 / uv2."""
    N = X1.shape[0]
    device = X1.device
    if sigma2_1 is None:
        sigma2_1 = torch.ones(N, device=device)
    if sigma2_2 is None:
        sigma2_2 = torch.ones(N, device=device)

    def project(Xc):
        z = Xc[..., 2].clamp_min(1e-6)
        return torch.stack([cam.fx * Xc[..., 0] / z + cam.cx,
                            cam.fy * Xc[..., 1] / z + cam.cy], -1)

    def residuals(xi, S_ref: Sim3):
        S = sim3_mod.compose(sim3_mod.expmap(xi), S_ref)
        if fix_scale:
            S = Sim3(S_ref.s, S.R, S.t)
        r1 = project(sim3_mod.apply(S, X2)) - uv1
        r2 = project(sim3_mod.apply(sim3_mod.inverse(S), X1)) - uv2
        return torch.cat([r1 / torch.sqrt(sigma2_1)[:, None],
                          r2 / torch.sqrt(sigma2_2)[:, None]], 0)  # (2N, 2)

    def chi2_of(S: Sim3):
        e1 = torch.sum((project(sim3_mod.apply(S, X2)) - uv1) ** 2,
                       -1) / sigma2_1
        e2 = torch.sum((project(sim3_mod.apply(sim3_mod.inverse(S), X1))
                        - uv2) ** 2, -1) / sigma2_2
        return e1, e2

    def huber_cost(r):
        """Huber-robustified chi2 per residual row (delta^2 = CHI2)."""
        c = torch.sum(r * r, -1)
        return torch.where(c <= CHI2, c,
                           2.0 * torch.sqrt(CHI2 * c.clamp_min(0.0)) - CHI2)

    m2 = torch.cat([mask, mask])
    # the Sim3 runs as a batch of one: forward-mode AD gives a 0-d tensor
    # combined with a Python scalar a float64 tangent
    zero = torch.zeros(1, 7, device=device)
    eye7 = torch.eye(7, device=device)

    def lm_pass(S: Sim3, inl) -> Sim3:
        lam = torch.full((), 1e-3, device=device)
        use = m2 & inl
        for _ in range(iters):
            J = jacfwd(lambda xi: residuals(xi, S))(zero)[:, :, 0]  # (2N,2,7)
            r = residuals(zero, S)
            c_row = torch.sum(r * r, -1)
            hub = torch.clamp(torch.sqrt(CHI2 / c_row.clamp_min(1e-9)),
                              max=1.0)
            Jw = J * (use.to(torch.float32) * hub)[:, None, None]
            H = torch.einsum("nia,nib->ab", Jw, J)
            b = -torch.einsum("nia,ni->a", Jw, r)
            Hd = H + lam * torch.diag(torch.diag(H)) + 1e-6 * eye7
            dx = torch.linalg.solve_ex(Hd, b[:, None],
                                       check_errors=False).result.T  # (1,7)
            S_new = sim3_mod.compose(sim3_mod.expmap(dx), S)
            if fix_scale:
                S_new = Sim3(S.s, S_new.R, S_new.t)
            c_old = torch.where(use, huber_cost(r), 0.0).sum()
            c_new = torch.where(use, huber_cost(residuals(zero, S_new)),
                                0.0).sum()
            ok = (c_new < c_old) & torch.isfinite(c_new)
            S = _select(ok, S_new, S)
            lam = torch.where(ok, (lam * 0.5).clamp_min(1e-9),
                              (lam * 4.0).clamp_max(1e6))
        return S

    S = lm_pass(Sim3(S12_init.s[None], S12_init.R[None], S12_init.t[None]),
                m2)
    # chi2 re-selection, then a second pass (the reference's two passes)
    e1, e2 = chi2_of(S)
    good = mask & (e1 < CHI2) & (e2 < CHI2)
    S = lm_pass(S, torch.cat([good, good]))
    e1, e2 = chi2_of(S)
    good = mask & (e1 < CHI2) & (e2 < CHI2)
    return Sim3OptResult(Sim3(S.s[0], S.R[0], S.t[0]), good,
                         good.sum(dtype=torch.int32))

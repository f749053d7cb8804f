"""Local/global bundle adjustment: batched Schur-complement Levenberg-Marquardt.

Port of `plslam_tpu/optim/local_ba.py`. The window has fixed shape: K camera
slots, P point slots, L line slots (two endpoint landmarks each), with the
observations as dense (K, P) / (K, L) grids and validity masks. Landmark
blocks are eliminated by a batched Schur complement with closed-form 3x3
inverses, and the reduced (6K, 6K) camera system is solved densely. The LM
schedule (robust rounds -> chi2 demotion -> more rounds -> final verdicts) is
a Python loop over tensor ops that accepts or rejects each step with
`torch.where`, so nothing waits for the device.

The three-operand contractions of the JAX einsums are split into pairwise
products (torch contracts einsum operands left to right). With `obs_ur` (a
depth sensor's right-image columns) every point cell has C = 3 residual
components, the third zero for monocular observations, and stereo cells are
gated at chi2 7.815 instead of 5.991.

With `n_shards` > 1 the landmark axes (points and lines) are cut into that
many ranges, the one-card form of the JAX package's landmark-sharded BA
(`plslam_tpu/parallel/sharded_ba.py`): each range's Schur blocks are
reduced in turn into the camera system and its right-hand side, a running
sum in place of the `psum`, and formed again for the back-substitution, so
only one range's (K, P / n_shards, 6, 3) blocks are alive at a time. The
costs that decide each step are summed over the ranges the same way.

With a `mesh` (a rank of `parallel/mesh.py`) the window holds this rank's
landmark range (`parallel/sharded_ba.shard_problem`): its ranges are summed
as above, then the camera system and its right-hand side are all-reduced
once per LM iteration, and each cost once (`utils/dist.psum`, the JAX
package's `_psum`). The
camera solve and the accept / reject decisions then run replicated on
identical values; the back-substitution stays local to the rank.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..geometry import se3
from ..geometry.triangulation import inv3x3
from ..utils.dist import psum, ranges
from . import residuals

CHI2_POINT = 5.991
CHI2_STEREO = 7.815  # 3-dof stereo point edges
CHI2_LINE = 3.84  # per endpoint residual
# max landmark move per LM iteration, in map units (mono maps are
# median-depth-normalized to ~1 by the initializer)
LANDMARK_MAX_STEP = 0.25


class BAProblem(NamedTuple):
    """Fixed-shape BA window: K cameras, P points, L lines."""

    kf_T: torch.Tensor         # (K, 4, 4) world->cam
    kf_fixed: torch.Tensor     # (K,) bool, pose held constant
    kf_mask: torch.Tensor      # (K,) bool, slot populated
    pt_xyz: torch.Tensor       # (P, 3)
    pt_mask: torch.Tensor      # (P,) bool
    obs_uv: torch.Tensor       # (K, P, 2) observed undistorted pixels
    obs_mask: torch.Tensor     # (K, P) bool
    obs_sigma2: torch.Tensor   # (K, P) per-observation variance
    ln_xyz: torch.Tensor       # (L, 2, 3) endpoint world positions
    ln_mask: torch.Tensor      # (L,) bool
    ln_obs_l2d: torch.Tensor   # (K, L, 3) observed 2D line (unit normal)
    ln_obs_mask: torch.Tensor  # (K, L) bool
    ln_info: object = 0.5      # scalar or (L,) tensor information weight
    # stereo: (K, P) right-image column per observation, <= 0 for a
    # monocular one; None keeps the 2-component monocular cells
    obs_ur: Optional[torch.Tensor] = None
    bf: float = 0.0            # fx * baseline


class BAResult(NamedTuple):
    kf_T: torch.Tensor
    pt_xyz: torch.Tensor
    ln_xyz: torch.Tensor
    obs_inlier: torch.Tensor     # (K, P) bool, post-BA chi2 verdict
    ln_obs_inlier: torch.Tensor  # (K, L) bool
    cost: torch.Tensor
    accepted: Optional[torch.Tensor] = None  # int64, `LMState.accepted`


def _point_terms(prob: BAProblem, kf_T, pt_xyz, cam):
    """Residuals/Jacobians of every (camera, point) cell: r (K,P,C),
    Jc (K,P,C,6), Jp (K,P,C,3), chi2 (K,P), depth (K,P) and the chi2 gate,
    with C = 2, or 3 when the window carries stereo observations."""
    K, P = prob.obs_mask.shape
    T = kf_T[:, None].expand(K, P, 4, 4)
    Xw = pt_xyz[None].expand(K, P, 3)
    if prob.obs_ur is None:
        r, Jc, Jp, z = residuals.point_residual(cam, T, Xw, prob.obs_uv)
        gate = CHI2_POINT
    else:
        r, Jc, Jp, z = residuals.point_residual_stereo(
            cam, prob.bf, T, Xw, prob.obs_uv, prob.obs_ur)
        gate = torch.where(prob.obs_ur > 0, CHI2_STEREO, CHI2_POINT)
    chi2 = torch.sum(r * r, dim=-1) / prob.obs_sigma2
    return r, Jc, Jp, chi2, z, gate


def _ln_w(prob: BAProblem):
    """Line information as a (K, L, 2)-broadcastable weight."""
    w = prob.ln_info
    return w[None, :, None] if torch.is_tensor(w) and w.dim() else w


def _line_terms(prob: BAProblem, kf_T, ln_xyz, cam):
    """Per (camera, line, endpoint): r (K,L,2), Jc (K,L,2,6), Jp (K,L,2,3),
    chi2 (K,L,2), z (K,L,2)."""
    K, L = prob.ln_obs_mask.shape
    r, Jc, Jp, z = residuals.line_endpoint_residual(
        cam, kf_T[:, None, None].expand(K, L, 2, 4, 4),
        ln_xyz[None].expand(K, L, 2, 3),
        prob.ln_obs_l2d[:, :, None, :].expand(K, L, 2, 3))
    return r, Jc, Jp, r * r * _ln_w(prob), z


def _huber(chi2, gate, robust: bool):
    return residuals.huber_weight(chi2, gate) if robust else 1.0


def _shard(prob: BAProblem, a: int, b: int, c: int, d: int) -> BAProblem:
    """The window with its points cut to [a, b) and its lines to [c, d)."""
    info = prob.ln_info
    return prob._replace(
        pt_xyz=prob.pt_xyz[a:b], pt_mask=prob.pt_mask[a:b],
        obs_uv=prob.obs_uv[:, a:b], obs_mask=prob.obs_mask[:, a:b],
        obs_sigma2=prob.obs_sigma2[:, a:b],
        obs_ur=None if prob.obs_ur is None else prob.obs_ur[:, a:b],
        ln_xyz=prob.ln_xyz[c:d], ln_mask=prob.ln_mask[c:d],
        ln_obs_l2d=prob.ln_obs_l2d[:, c:d],
        ln_obs_mask=prob.ln_obs_mask[:, c:d],
        ln_info=info[c:d] if torch.is_tensor(info) and info.dim() else info)


def _sharded(prob: BAProblem, n_shards: int, pt_xyz, ln_xyz, obs_in,
             ln_in):
    """[(sub-window, pt_xyz, ln_xyz, obs_in, ln_in)] cut to each landmark
    shard's ranges."""
    if n_shards == 1:
        return [(prob, pt_xyz, ln_xyz, obs_in, ln_in)]
    return [(_shard(prob, a, b, c, d), pt_xyz[a:b], ln_xyz[c:d],
             obs_in[:, a:b], ln_in[:, c:d])
            for (a, b), (c, d) in zip(ranges(prob.pt_mask.shape[0], n_shards),
                                      ranges(prob.ln_mask.shape[0], n_shards))]


def _landmark_blocks(prob, cam, kf_T, pt_xyz, ln_xyz, obs_in, ln_in, lam,
                     robust: bool):
    """The normal-equation blocks of one landmark range: the camera blocks
    (Hcc, bc), the damped inverse landmark blocks with their right-hand
    sides and camera cross blocks (Hpp_inv, bp, Hcp, Hll_inv, bl, Hcl)."""
    dev = kf_T.device
    r, Jc, Jp, chi2, z, gate = _point_terms(prob, kf_T, pt_xyz, cam)
    m = ((prob.obs_mask & obs_in & (z > 0)).to(torch.float32)
         / prob.obs_sigma2 * _huber(chi2, gate, robust))        # (K,P)
    Jcm = Jc * m[..., None, None]
    Jpm = Jp * m[..., None, None]
    Hcc = torch.einsum("kpia,kpib->kab", Jcm, Jc)              # (K,6,6)
    bc = -torch.einsum("kpia,kpi->ka", Jcm, r)                  # (K,6)
    Hpp = torch.einsum("kpia,kpib->pab", Jpm, Jp)              # (P,3,3)
    bp = -torch.einsum("kpia,kpi->pa", Jpm, r)                  # (P,3)
    Hcp = torch.einsum("kpia,kpib->kpab", Jcm, Jp)             # (K,P,6,3)

    # line endpoint landmarks, treated exactly like 3-dof points
    rl, Jcl, Jpl, chi2l, zl = _line_terms(prob, kf_T, ln_xyz, cam)
    ml = ((prob.ln_obs_mask[:, :, None] & ln_in[:, :, None] & (zl > 0))
          .to(torch.float32) * _ln_w(prob) * _huber(chi2l, CHI2_LINE, robust))
    Jclm = Jcl * ml[..., None]
    Jplm = Jpl * ml[..., None]
    Hcc = Hcc + torch.einsum("klea,kleb->kab", Jclm, Jcl)
    bc = bc - torch.einsum("klea,kle->ka", Jclm, rl)
    Hll = torch.einsum("klea,kleb->leab", Jplm, Jpl)           # (L,2,3,3)
    bl = -torch.einsum("klea,kle->lea", Jplm, rl)               # (L,2,3)
    Hcl = torch.einsum("klea,kleb->kleab", Jclm, Jpl)          # (K,L,2,6,3)

    # damping; closed-form 3x3 inverses; fixed landmarks masked out
    eye3 = torch.eye(3, device=dev)
    tr_p = torch.diagonal(Hpp, dim1=-2, dim2=-1).sum(-1)
    Hpp_d = Hpp + lam * eye3 * (tr_p[:, None, None] / 3.0).clamp_min(1e-6) \
        + 1e-6 * eye3
    tr_l = torch.diagonal(Hll, dim1=-2, dim2=-1).sum(-1)
    Hll_d = Hll + lam * eye3 * (tr_l[..., None, None] / 3.0).clamp_min(1e-6) \
        + 1e-6 * eye3
    Hpp_inv = inv3x3(Hpp_d) * prob.pt_mask[:, None, None]
    Hll_inv = inv3x3(Hll_d) * prob.ln_mask[:, None, None, None]
    return Hcc, bc, Hpp_inv, bp, Hcp, Hll_inv, bl, Hcl


def _reduced_camera_system(blocks):
    """One landmark range's share of the Schur complement, S (K, K, 6, 6)
    and bs (K, 6): S[k,q] = Hcc[k] delta_kq - sum_p Hcp[k,p] Hpp_inv[p]
    Hcp[q,p]^T (+ lines)."""
    Hcc, bc, Hpp_inv, bp, Hcp, Hll_inv, bl, Hcl = blocks
    K = Hcc.shape[0]
    HcpHi = torch.einsum("kpab,pbc->kpac", Hcp, Hpp_inv)       # (K,P,6,3)
    HclHi = torch.einsum("kleab,lebc->kleac", Hcl, Hll_inv)
    eyeK = torch.eye(K, device=Hcc.device)[:, :, None, None]
    S = (eyeK * Hcc[:, None]
         - torch.einsum("kpac,qpdc->kqad", HcpHi, Hcp)
         - torch.einsum("kleac,qledc->kqad", HclHi, Hcl))
    bs = (bc - torch.einsum("kpac,pc->ka", HcpHi, bp)
          - torch.einsum("kleac,lec->ka", HclHi, bl))
    return S, bs


def _back_substitute(prob, blocks, dc):
    """The landmark steps (dp, dl) of one range given the camera step dc,
    each held to the per-landmark trust region."""
    _, _, Hpp_inv, bp, Hcp, Hll_inv, bl, Hcl = blocks
    dp = torch.einsum("pab,pb->pa", Hpp_inv,
                      bp - torch.einsum("kpab,ka->pb", Hcp, dc))
    dl = torch.einsum("leab,leb->lea", Hll_inv,
                      bl - torch.einsum("kleab,ka->leb", Hcl, dc))
    dp = dp * prob.pt_mask[:, None]
    dl = dl * prob.ln_mask[:, None, None]

    def clamp(d):
        n = torch.linalg.vector_norm(d, dim=-1, keepdim=True)
        return d * torch.clamp(LANDMARK_MAX_STEP / n.clamp_min(1e-12),
                               max=1.0)
    return clamp(dp), clamp(dl)


def _solve_lm_step(prob, cam, kf_T, pt_xyz, ln_xyz, obs_in, ln_in, lam,
                   robust: bool, n_shards: int = 1, mesh=None):
    """One damped normal-equations solve with Schur elimination of the
    landmarks, their ranges reduced in turn (`n_shards`) and, with a
    `mesh`, summed over the ranks; returns the stepped (kf_T, pt_xyz,
    ln_xyz)."""
    K = prob.kf_T.shape[0]
    dev = kf_T.device
    shards = _sharded(prob, n_shards, pt_xyz, ln_xyz, obs_in, ln_in)
    blocks = lambda sh: _landmark_blocks(sh[0], cam, kf_T, *sh[1:], lam,
                                         robust)
    kept = S = bs = None
    for sh in shards:
        b = blocks(sh)
        S_i, bs_i = _reduced_camera_system(b)
        S, bs = (S_i, bs_i) if S is None else (S + S_i, bs + bs_i)
        kept = b if n_shards == 1 else None
    S, bs = psum(mesh, S, bs)

    # fixed cameras: zero rows/cols, identity diagonal; damp the diagonal
    free_c = (prob.kf_mask & ~prob.kf_fixed).to(torch.float32)
    S = S * (free_c[:, None] * free_c[None, :])[:, :, None, None]
    bs = bs * free_c[:, None]
    eyeK = torch.eye(K, device=dev)[:, :, None, None]
    eye6 = torch.eye(6, device=dev)
    diagS = torch.diagonal(torch.diagonal(S, dim1=0, dim2=1),
                           dim1=0, dim2=1)                      # (K, 6)
    damp = lam * diagS.clamp_min(1e-6)[:, :, None] * eye6
    S = S + eyeK * (damp + (1.0 - free_c)[:, None, None] * eye6
                    + 1e-6 * eye6)[:, None]
    Sd = S.permute(0, 2, 1, 3).reshape(K * 6, K * 6)
    dc = torch.linalg.solve_ex(Sd, bs.reshape(K * 6, 1),
                               check_errors=False).result.reshape(K, 6)
    dc = dc * free_c[:, None]

    # back-substitute the landmarks, range by range
    steps = [_back_substitute(sh[0], kept if kept is not None
                              else blocks(sh), dc) for sh in shards]
    dp = torch.cat([d for d, _ in steps]) if n_shards > 1 else steps[0][0]
    dl = torch.cat([d for _, d in steps]) if n_shards > 1 else steps[0][1]
    kf_T_new = torch.where((prob.kf_mask & ~prob.kf_fixed)[:, None, None],
                           se3.se3_exp(dc) @ kf_T, kf_T)
    return kf_T_new, pt_xyz + dp, ln_xyz + dl


def _rho(chi2, gate, robust: bool):
    if not robust:
        return chi2
    return torch.where(chi2 > gate,
                       2.0 * torch.sqrt(gate * chi2.clamp_min(0.0)) - gate,
                       chi2)


def _total_cost(prob, cam, kf_T, pt_xyz, ln_xyz, obs_in, ln_in,
                robust: bool, n_shards: int = 1, mesh=None):
    """The (robust) cost of the window, a running sum over the landmark
    shards, summed over the ranks of `mesh`."""
    cost = None
    for sh in _sharded(prob, n_shards, pt_xyz, ln_xyz, obs_in, ln_in):
        c = _range_cost(sh[0], cam, kf_T, *sh[1:], robust)
        cost = c if cost is None else cost + c
    return psum(mesh, cost)[0]


def _range_cost(prob, cam, kf_T, pt_xyz, ln_xyz, obs_in, ln_in,
                robust: bool):
    _, _, _, chi2, z, gate = _point_terms(prob, kf_T, pt_xyz, cam)
    c = torch.where(prob.obs_mask & obs_in & (z > 0),
                    _rho(chi2, gate, robust), 0.0).sum()
    _, _, _, chi2l, zl = _line_terms(prob, kf_T, ln_xyz, cam)
    return c + torch.where(
        prob.ln_obs_mask[:, :, None] & ln_in[:, :, None] & (zl > 0),
        _rho(chi2l, CHI2_LINE, robust), 0.0).sum()


class LMState(NamedTuple):
    """Resumable LM solver state (the unit at which a BA can stop)."""
    kf_T: torch.Tensor
    pt_xyz: torch.Tensor
    ln_xyz: torch.Tensor
    obs_in: torch.Tensor
    ln_in: torch.Tensor
    lam: torch.Tensor
    cost: torch.Tensor
    # the accept / reject decisions, one bit per LM iteration since
    # `ba_init`, the newest lowest (int64: the last 63 iterations)
    accepted: torch.Tensor


def ba_init(prob: BAProblem, cam, robust: bool = True,
            n_shards: int = 1, mesh=None) -> LMState:
    c0 = _total_cost(prob, cam, prob.kf_T, prob.pt_xyz, prob.ln_xyz,
                     prob.obs_mask, prob.ln_obs_mask, robust, n_shards, mesh)
    return LMState(prob.kf_T, prob.pt_xyz, prob.ln_xyz, prob.obs_mask,
                   prob.ln_obs_mask, torch.full_like(c0, 1e-4), c0,
                   torch.zeros_like(c0, dtype=torch.int64))


def ba_rounds(prob: BAProblem, cam, st: LMState, n_iters: int,
              robust: bool = True, n_shards: int = 1, mesh=None) -> LMState:
    """`n_iters` LM iterations from `st`; a step is kept when it lowers
    the cost (summed over the landmark shards and ranks) to a finite
    value."""
    for _ in range(n_iters):
        T2, p2, l2 = _solve_lm_step(prob, cam, st.kf_T, st.pt_xyz,
                                    st.ln_xyz, st.obs_in, st.ln_in, st.lam,
                                    robust, n_shards, mesh)
        c_new = _total_cost(prob, cam, T2, p2, l2, st.obs_in, st.ln_in,
                            robust, n_shards, mesh)
        ok = (c_new < st.cost) & torch.isfinite(c_new)
        st = st._replace(
            kf_T=torch.where(ok, T2, st.kf_T),
            pt_xyz=torch.where(ok, p2, st.pt_xyz),
            ln_xyz=torch.where(ok, l2, st.ln_xyz),
            lam=torch.where(ok, (st.lam * 0.5).clamp_min(1e-9),
                            (st.lam * 4.0).clamp_max(1e8)),
            cost=torch.where(ok, c_new, st.cost),
            accepted=st.accepted * 2 + ok.to(torch.int64))
    return st


def _verdicts(prob, cam, st: LMState):
    _, _, _, chi2, z, gate = _point_terms(prob, st.kf_T, st.pt_xyz, cam)
    obs_in = prob.obs_mask & (chi2 <= gate) & (z > 0)
    _, _, _, chi2l, zl = _line_terms(prob, st.kf_T, st.ln_xyz, cam)
    lep = (chi2l <= CHI2_LINE) & (zl > 0)
    return obs_in, prob.ln_obs_mask & lep[..., 0] & lep[..., 1]


def ba_demote(prob: BAProblem, cam, st: LMState,
              n_shards: int = 1, mesh=None) -> LMState:
    """Chi2 outlier demotion between the two LM phases; resets lambda and
    the reference cost."""
    obs_in, ln_in = _verdicts(prob, cam, st)
    c0 = _total_cost(prob, cam, st.kf_T, st.pt_xyz, st.ln_xyz, obs_in,
                     ln_in, True, n_shards, mesh)
    return st._replace(obs_in=obs_in, ln_in=ln_in,
                       lam=torch.full_like(st.lam, 1e-4), cost=c0)


def ba_finalize(prob: BAProblem, cam, st: LMState,
                n_shards: int = 1, mesh=None) -> BAResult:
    """Final chi2 verdicts (the observations to erase from the map)."""
    obs_inlier, ln_obs_inlier = _verdicts(prob, cam, st)
    cost = _total_cost(prob, cam, st.kf_T, st.pt_xyz, st.ln_xyz, obs_inlier,
                       ln_obs_inlier, False, n_shards, mesh)
    return BAResult(st.kf_T, st.pt_xyz, st.ln_xyz, obs_inlier,
                    ln_obs_inlier, cost, st.accepted)


def bundle_adjust(prob: BAProblem, cam, iters_a: int = 5,
                  iters_b: int = 10, n_shards: int = 1,
                  mesh=None) -> BAResult:
    """`iters_a` robust iterations -> chi2 demotion -> `iters_b` more ->
    final verdicts (`LocalBundleAdjustmentWithLine`'s staged schedule),
    the landmark axes reduced in `n_shards` ranges (1: all at once); with
    a `mesh`, `prob` is this rank's landmark range and the result holds
    this rank's landmarks (`parallel/sharded_ba.sharded_bundle_adjust`
    gathers them)."""
    kw = dict(n_shards=n_shards, mesh=mesh)
    st = ba_init(prob, cam, **kw)
    st = ba_rounds(prob, cam, st, iters_a, robust=True, **kw)
    st = ba_demote(prob, cam, st, **kw)
    st = ba_rounds(prob, cam, st, iters_b, robust=True, **kw)
    return ba_finalize(prob, cam, st, **kw)

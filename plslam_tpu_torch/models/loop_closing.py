"""Loop closing: detection, Sim3 estimation, loop correction through the
essential graph, and search-and-fuse (the LoopClosing thread, `Run` ->
`DetectLoop` -> `ComputeSim3` -> `CorrectLoop`).

Port of `plslam_tpu/models/loop_closing.py`. Per keyframe:
1. BoW candidate scoring with the covisible-minimum-score, shared-word and
   covisibility-group rules, on the device (`_detect_inputs`); its small
   result is copied to pinned host memory without waiting and read one
   keyframe later, so detection never stalls the keyframe chain;
2. consistency across 3 consecutive keyframes, on the host;
3. for a consistent candidate: keypoint pairs with bound points through K1
   (gates off, forward and reverse for the mutual check), Horn Sim3
   RANSAC, Sim3 LM, a guided SearchBySim3 pass and a group projection
   count (both plain PyTorch: a radius per keypoint or per projected point
   is not K1's gate), the >= 20 / >= 40 acceptance and the drift gate;
   these read their counts back;
4. the correction: the essential graph built on the host from one (K, K)
   covisibility readback, solved on the device, poses and landmarks moved,
   then `_search_fuse`. The caller schedules the global BA.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..geometry import se3, sim3 as sim3_mod
from ..geometry.sim3 import Sim3
from ..mapstate import state as mstate
from ..ops import gated_match, hamming
from ..optim import pose_graph, sim3_opt
from ..solvers import horn
from ..utils.trace import no_span
from ..vocab import bow
from . import mapping
from .tracking import _row, _top

CONSISTENCY_TH = 3  # `mnCovisibilityConsistencyTh`


def _to_host_async(*tensors):
    """(host copies, event): CUDA tensors are copied into pinned host memory
    without waiting and `event` marks the copies' completion; CPU tensors
    are cloned and `event` is None."""
    if tensors[0].device.type != "cuda":
        return tuple(t.clone() for t in tensors), None
    host = tuple(torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                 for t in tensors)
    for h, t in zip(host, tensors):
        h.copy_(t, non_blocking=True)
    event = torch.cuda.Event()
    event.record()
    return host, event


class LoopClosing:
    """Loop detection and correction for one map. `map_cfg` holds the map's
    capacities (the System replaces it when the map grows). `span` gives
    the host spans `loop_detect`, `sim3_stage` and `loop_correct`
    (`utils/trace.py`; the System sets its tracer's)."""

    span = staticmethod(no_span)

    def __init__(self, cam, map_cfg, sigma2_levels, fix_scale: bool = False,
                 max_drift_rot: float = 0.8):
        self.cam = cam
        self.map_cfg = map_cfg
        self.sigma2 = sigma2_levels
        self.fix_scale = fix_scale
        self.max_drift_rot = max_drift_rot   # rad, the drift gate
        self.consistent_groups: list[tuple[set, int]] = []
        self.last_loop_kf = -10
        self.loop_edges: list[tuple[int, int, np.ndarray]] = []
        self.n_loops = 0
        # keyframe poses just before and just after the last correction
        self.pre_correction_kf_T: Optional[np.ndarray] = None
        self.post_correction_kf_T: Optional[np.ndarray] = None
        self.last_closure: Optional[tuple[int, int]] = None
        self._pending_detect = None

    # ------------------------------------------------------------------
    def _detect_inputs(self, ms, k: int, n_cand: int = 8, n_pre: int = 16):
        """Candidate selection for keyframe k on the device
        (`DetectLoop` + `KeyFrameDatabase::DetectLoopCandidates`): L1 BoW
        scores at or above the lowest score among k's covisible keyframes
        (>= 15 shared points; 0.05 without any, floored at 0.015), more
        than 0.8 x the most shared words with k, excluding k's covisible
        keyframes and k-5..k; the top `n_pre` accumulate the scores of
        their 10 best covisible neighbours that also pass the shared-word
        filter; groups >= 0.75 x the best survive. Needs n_pre + 1
        covisibility rows, never the (K, K) matrix.

        Returns (top ids (n_cand,), their group scores (-1 = none), group
        rows (n_cand, K) bool)."""
        K = ms.kf_valid.shape[0]
        kt = torch.full((1,), k, dtype=torch.long, device=ms.kf_bow.device)
        q = _row(ms.kf_bow, kt)
        scores = bow.l1_score(q, ms.kf_bow)
        ids = torch.arange(K, device=scores.device)
        valid = ms.kf_valid & (ids < ms.n_kf)
        covis = (mstate.covis_rows(ms, kt)[0] >= 15) & valid
        min_score = torch.where(covis, scores, torch.inf).amin()
        min_score = torch.where(torch.isfinite(min_score), min_score, 0.05)
        exclude = covis | ~valid | ((ids >= k - 5) & (ids <= k))
        th = min_score.clamp_min(0.015)
        cw = ((q > 0)[None, :] & (ms.kf_bow > 0)).sum(-1, dtype=torch.int32)
        cw = torch.where(exclude, 0, cw)
        share08 = ~exclude & (cw.to(torch.float32)
                              > 0.8 * cw.amax().to(torch.float32))
        eligible = share08 & (scores >= th)
        n_pre = min(n_pre, K)
        pre_sc, pre_id = _top(torch.where(eligible, scores, -1.0), n_pre)
        pre_rows = mstate.covis_rows(ms, pre_id)                   # (n_pre, K)
        nb_w, nb_i = _top(pre_rows, min(10, K))                    # (n_pre, 10)
        nb_contrib = (nb_w > 0) & share08[nb_i]
        acc = scores[pre_id] + torch.where(nb_contrib, scores[nb_i],
                                           0.0).sum(-1)
        pre_ok = pre_sc > 0
        best_acc = torch.where(pre_ok, acc, -torch.inf).amax()
        keep = pre_ok & (acc >= 0.75 * best_acc)
        top_sc, top_j = _top(torch.where(keep, acc, -1.0), min(n_cand, n_pre))
        top_id = pre_id[top_j]
        group_rows = (pre_rows[top_j] > 0) | (ids[None, :] == top_id[:, None])
        return top_id, top_sc, group_rows

    # ------------------------------------------------------------------
    def _match_pairs(self, ms, k: int, c: int):
        """Keypoints of keyframes k and c that are both bound to map points,
        matched by Hamming distance with ratio 0.75, <= 50 and the mutual
        check (`ORBmatcher::SearchByBoW(KF, KF)`): K1 with its gates off,
        k's bound keypoints against c's, then c's against k's for the
        reverse best (the column argmin of the masked matrix; both pick the
        lowest index on ties and 0 when nothing passes).

        Returns (idx in c (N,), ok (N,), X1 in camera k (N,3), X2 in camera
        c (N,3), uv1, uv2, sigma2_1, sigma2_2)."""
        P = ms.pt_xyz.shape[0]
        N = ms.kf_uv.shape[1]
        dev = ms.pt_xyz.device
        pk, pc = ms.kf_pt_idx[k], ms.kf_pt_idx[c]
        bound1, bound2 = pk >= 0, pc >= 0
        zuv = torch.zeros((N, 2), device=dev)
        zoct = torch.zeros(N, dtype=torch.int32, device=dev)
        search = lambda a, va, b, vb: gated_match.gated_hamming_best2(
            ms.kf_desc[a], zuv, zoct, va, ms.kf_desc[b],
            torch.zeros((N, 2), device=dev), torch.zeros(N, device=dev),
            zoct, vb, gated=False)
        idx, best, second = search(k, bound1, c, bound2)
        rev, _, _ = search(c, bound2, k, bound1)
        ok = ((best <= 50) & (best.to(torch.float32)
                              < 0.75 * second.to(torch.float32))
              & (rev[idx] == torch.arange(N, device=dev)))
        p1 = pk.clamp(0, P - 1).long()
        p2 = pc[idx].clamp(0, P - 1).long()
        X1 = se3.transform(ms.kf_T[k], ms.pt_xyz[p1])
        X2 = se3.transform(ms.kf_T[c], ms.pt_xyz[p2])
        s2_1 = self.sigma2[ms.kf_octave[k].long()]
        s2_2 = self.sigma2[ms.kf_octave[c][idx].long()]
        return idx, ok, X1, X2, ms.kf_uv[k], ms.kf_uv[c][idx], s2_1, s2_2

    def _project(self, Xc):
        z = Xc[..., 2].clamp_min(1e-6)
        return torch.stack([self.cam.fx * Xc[..., 0] / z + self.cam.cx,
                            self.cam.fy * Xc[..., 1] / z + self.cam.cy], -1)

    def _sim3_stage(self, ms, k: int, c: int, group, generator, sets=None):
        """`ComputeSim3` for the pair (k, c): `_match_pairs`, Horn RANSAC
        (1024 hypotheses drawn from `generator`, or `sets`), Sim3 LM; then
        SearchBySim3 (c's bound points moved into camera k, matched to k's
        bound keypoints within 7.5 x 1.2^octave px, Hamming <= 100, mutual
        best) added to the pairs and the LM re-run; finally the loop
        group's points (`group` (K,) bool) projected into k, counted where
        a keypoint within 10 x 1.2^octave px is <= 50 bits away.

        Returns (total matches, RANSAC inliers, S12, LM inliers) as 0-d
        tensors and a Sim3."""
        idx, ok, X1, X2, uv1, uv2, s2_1, s2_2 = self._match_pairs(ms, k, c)
        rr = horn.ransac_sim3(generator, X1, X2, uv1, uv2, ok, self.cam,
                              s2_1, s2_2, fix_scale=self.fix_scale,
                              sets=sets)
        res = sim3_opt.optimize_sim3(self.cam, rr.S12, X1, X2, uv1, uv2,
                                     ok & rr.inliers, s2_1, s2_2,
                                     fix_scale=self.fix_scale)
        # SearchBySim3: a wider, guided pass between the two keyframes
        P = ms.pt_xyz.shape[0]
        pk, pc = ms.kf_pt_idx[k], ms.kf_pt_idx[c]
        X2_all = se3.transform(ms.kf_T[c], ms.pt_xyz[pc.clamp(0, P - 1)
                                                     .long()])
        X2in1 = sim3_mod.apply(res.S12, X2_all)
        d_px = torch.linalg.vector_norm(
            ms.kf_uv[k][:, None, :] - self._project(X2in1)[None, :, :],
            dim=-1)                                                  # (N, N)
        radius = 7.5 * torch.full_like(d_px[0], 1.2).pow(
            ms.kf_octave[c].to(torch.float32))
        gmask = ((pk >= 0)[:, None] & (pc >= 0)[None, :]
                 & (X2in1[:, 2] > 0)[None, :] & (d_px < radius[None, :]))
        gidx, gbest, _, mutual = hamming.mutual_best(
            hamming.distance_matrix(ms.kf_desc[k], ms.kf_desc[c]), gmask)
        use_g = (gbest <= 100) & mutual & ~ok
        idx2 = torch.where(use_g, gidx, idx)
        ok2 = ok | use_g
        X2u = se3.transform(ms.kf_T[c], ms.pt_xyz[pc[idx2].clamp(0, P - 1)
                                                  .long()])
        res2 = sim3_opt.optimize_sim3(
            self.cam, res.S12, X1, X2u, uv1, ms.kf_uv[c][idx2], ok2, s2_1,
            self.sigma2[ms.kf_octave[c][idx2].long()],
            fix_scale=self.fix_scale)
        # the loop group's points projected into k through the refined S12
        grp_rows = torch.where(group[:, None], ms.kf_pt_idx, -1)
        grp_pts = mstate.row_bitmap(grp_rows.reshape(1, -1), P)[0] \
            & ms.pt_valid
        Xg = sim3_mod.apply(res2.S12, se3.transform(ms.kf_T[c], ms.pt_xyz))
        d_g = torch.linalg.vector_norm(
            ms.kf_uv[k][:, None, :] - self._project(Xg)[None, :, :],
            dim=-1)                                                  # (N, P)
        rad_k = 10.0 * torch.full_like(d_g[:, 0], 1.2).pow(
            ms.kf_octave[k].to(torch.float32))
        pmask = (grp_pts[None, :] & (Xg[:, 2] > 0)[None, :]
                 & (d_g < rad_k[:, None]))
        _, pbest, _ = hamming.masked_best2(
            hamming.distance_matrix(ms.kf_desc[k], ms.pt_desc), pmask)
        n_total = (ok2 | (pbest <= 50)).sum(dtype=torch.int32)
        return n_total, rr.n_inliers, res2.S12, res2.n_inliers

    # ------------------------------------------------------------------
    def _apply_graph(self, ms, nodes: Sim3, edges, fixed_mask):
        """Solve the essential graph and move the map, in place: poses
        ``[R | t/s]`` of the optimized Sim3s, points and line endpoints
        through their reference keyframe's old -> new correction."""
        K = ms.kf_T.shape[0]
        opt = pose_graph.optimize_essential_graph(
            nodes, ms.kf_valid, fixed_mask, edges, fix_scale=self.fix_scale)
        new_T = torch.where(ms.kf_valid[:, None, None], sim3_mod.to_se3(opt),
                            ms.kf_T)
        pick = lambda S, i: Sim3(S.s[i], S.R[i], S.t[i])
        ref = ms.pt_first_kf.clamp(0, K - 1).long()
        corr = lambda S_old, S_new, X: sim3_mod.apply(
            sim3_mod.inverse(S_new), sim3_mod.apply(S_old, X))
        Xw = corr(pick(nodes, ref), pick(opt, ref), ms.pt_xyz)
        lref = ms.ln_first_kf.clamp(0, K - 1).long()
        S_old_l, S_new_l = pick(nodes, lref), pick(opt, lref)
        ln = torch.stack([corr(S_old_l, S_new_l, ms.ln_xyz[:, 0]),
                          corr(S_old_l, S_new_l, ms.ln_xyz[:, 1])], 1)
        ms.kf_T.copy_(new_T)
        ms.pt_xyz.copy_(torch.where(ms.pt_valid[:, None], Xw, ms.pt_xyz))
        ms.ln_xyz.copy_(torch.where(ms.ln_valid[:, None, None], ln,
                                    ms.ln_xyz))
        return ms

    # ------------------------------------------------------------------
    def detect(self, ms, k: int) -> list:
        """Dispatch keyframe k's candidate selection with its copy to the
        host, and resolve the previous keyframe's (whose copy has landed
        by now): the reference's loop thread consumes its queue with the
        same lag. Within 10 keyframes of the last closure nothing runs and
        the pending selection is dropped (the map just moved).

        Returns [(kf_id, candidate_id, group_row), ...] for the previous
        keyframe."""
        if k - self.last_loop_kf < 10:
            self._pending_detect = None
            return []
        pending = self._pending_detect
        self._pending_detect = (k, *_to_host_async(
            *self._detect_inputs(ms, k)))
        return self._consistency(pending)

    def _consistency(self, pending) -> list:
        """Resolve one dispatched selection: the candidates whose group
        shares a keyframe with groups of CONSISTENCY_TH - 1 consecutive
        earlier keyframes."""
        if pending is None:
            return []
        pk, (tid, tsc, rows), event = pending
        if event is not None:
            event.synchronize()
        top_id, top_sc, group_rows = tid.numpy(), tsc.numpy(), rows.numpy()
        new_groups, consistent = [], []
        for i, j in enumerate(top_id):
            if top_sc[i] <= 0:
                continue
            group = set(np.nonzero(group_rows[i])[0].tolist()) | {int(j)}
            count = 0
            for prev_group, prev_count in self.consistent_groups:
                if group & prev_group:
                    count = max(count, prev_count + 1)
            new_groups.append((group, count))
            if count + 1 >= CONSISTENCY_TH:
                consistent.append((pk, int(j), group_rows[i]))
        self.consistent_groups = new_groups
        return consistent

    def finish(self, ms, seed: int = 0):
        """Resolve the pending detection (flush / shutdown). Returns (ms,
        closed)."""
        pending, self._pending_detect = self._pending_detect, None
        if pending is None:
            return ms, False
        with self.span("loop_detect"):
            candidates = self._consistency(pending)
        return self._try_close(ms, pending[0], candidates, seed)

    # ------------------------------------------------------------------
    def _search_fuse(self, ms, k: int, c: int):
        """`SearchAndFuse` after the correction: the points keyframe c
        observes fuse with replace semantics into keyframe k and its 3
        predecessors (radius 4), then duplicate rows are freed."""
        P, K = ms.pt_xyz.shape[0], ms.kf_T.shape[0]
        pc = ms.kf_pt_idx[c]
        cand = mstate.row_bitmap(pc[None], P)[0] & ms.pt_valid
        for back in range(4):
            mapping.loop_fuse(self.cam, ms, min(max(k - back, 0), K - 1),
                              cand, radius=4.0)
        return mapping.dedup_kf_point_rows(self.cam, ms)

    # ------------------------------------------------------------------
    def process_keyframe(self, ms, k: int, seed: int = 0):
        """A loop-closing attempt at keyframe k. Returns (ms, closed); on a
        closure the correction and search-and-fuse have run and the caller
        schedules the global BA."""
        with self.span("loop_detect"):
            candidates = self.detect(ms, k)
        return self._try_close(ms, k, candidates, seed)

    def _try_close(self, ms, k: int, candidates, seed: int = 0):
        K_now = self.map_cfg.max_kf
        for pk, c, group_row in candidates:
            # resolved one keyframe late: pad if the map grew in between
            group_row = np.pad(group_row, (0, K_now - len(group_row)))
            gen = torch.Generator().manual_seed(seed + self.n_loops)
            with self.span("sim3_stage"):
                n_matches, n_seed, S12, n_inl = self._sim3_stage(
                    ms, pk, c,
                    torch.from_numpy(group_row).to(ms.pt_xyz.device), gen)
            # >= 20 LM inliers and >= 40 matches after SearchBySim3, with a
            # 12-inlier floor on the RANSAC consensus (the JAX package
            # documents why the reference's counts move after refinement)
            if int(n_seed) < 12 or int(n_inl) < 20 or int(n_matches) < 40:
                continue
            if self.drift_angle(ms, pk, c, S12) > self.max_drift_rot:
                continue
            self.pre_correction_kf_T = ms.kf_T.cpu().clone().numpy()
            self.last_closure = (pk, c)
            with self.span("loop_correct"):
                ms = self.correct(ms, pk, c, S12)
                self.post_correction_kf_T = ms.kf_T.cpu().clone().numpy()
                ms = self._search_fuse(ms, k, c)
            self.last_loop_kf = k
            self.n_loops += 1
            return ms, True
        return ms, False

    @staticmethod
    def drift_angle(ms, k: int, c: int, S12: Sim3) -> float:
        """The drift gate's angle (rad) between S12's rotation and the map's
        own relative rotation of keyframes k and c: a true closure differs
        by the drift only."""
        R_map = (ms.kf_T[k][:3, :3] @ ms.kf_T[c][:3, :3].T).cpu().numpy()
        R_err = R_map @ S12.R.cpu().numpy().T
        return float(np.arccos(np.clip((np.trace(R_err) - 1.0) / 2.0,
                                       -1.0, 1.0)))

    # ------------------------------------------------------------------
    def correct(self, ms, k: int, c: int, S_kc: Sim3):
        """Essential-graph correction (`CorrectLoop`), in place. Edges are
        built on the host from one (K, K) covisibility readback: the
        spanning tree (parent = the earlier keyframe sharing the most
        points, >= 15, else the previous one), pairs sharing >= 100 points
        two or more apart, the earlier loop edges and the new one (weight
        2); keyframe c is fixed. The relative measurements of the tree and
        covisibility edges come from the current poses in one batched call;
        the loop edges carry their Sim3."""
        K = ms.kf_T.shape[0]
        n_kf = int(ms.n_kf)
        dev = ms.kf_T.device
        W = mstate.covisibility(ms).cpu().numpy()
        low = np.tril(W[:n_kf, :n_kf], -1)
        par = low.argmax(axis=1)
        par = np.where(low[np.arange(n_kf), par] < 15, np.arange(n_kf) - 1,
                       par)
        ei, ej = list(range(1, n_kf)), [int(p) for p in par[1:]]
        ew = [1.0] * (n_kf - 1)
        iu, ju = np.nonzero(np.triu(W[:n_kf, :n_kf] >= 100, 2))
        ei += iu.tolist()
        ej += ju.tolist()
        ew += [1.0] * len(iu)
        n_rel = len(ei)
        for i, j, _ in self.loop_edges:
            ei.append(i)
            ej.append(j)
            ew.append(2.0)
        ei.append(k)
        ej.append(c)
        ew.append(2.0)
        E = len(ei)
        to_dev = lambda a: torch.from_numpy(np.asarray(a)).to(dev)
        edge_i = to_dev(np.array(ei, np.int64))
        edge_j = to_dev(np.array(ej, np.int64))
        kf_S = sim3_mod.from_se3(ms.kf_T)
        pick = lambda S, i: Sim3(S.s[i], S.R[i], S.t[i])
        rel = sim3_mod.compose(pick(kf_S, edge_i),
                               sim3_mod.inverse(pick(kf_S, edge_j)))
        loops = [sim3_mod.expmap(to_dev(S7)) for _, _, S7 in self.loop_edges]
        loops.append(S_kc)
        meas = Sim3(*(torch.cat([x[:n_rel]] + [getattr(S, f)[None]
                                                for S in loops])
                      for f, x in zip(Sim3._fields, rel)))
        self.loop_edges.append((k, c, sim3_mod.logmap(S_kc).cpu().numpy()))
        edges = pose_graph.PoseGraphEdges(
            edge_i, edge_j, meas, torch.ones(E, dtype=torch.bool, device=dev),
            to_dev(np.array(ew, np.float32)))
        fixed = np.zeros(K, bool)
        fixed[c] = True
        return self._apply_graph(ms, kf_S, edges, to_dev(fixed))

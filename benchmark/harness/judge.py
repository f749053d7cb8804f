"""What decides `correct`: the program's outputs on frames of the window,
against the frozen plain reference (`benchmark/reference`) run on the same
inputs once the window has closed.

Tracking is chaotic at float32 noise, so the reference does not replay the
whole run. It follows the program step by step from the program's own
state: for each sampled frame the harness copied the map as tracking reads
it, the tracking state (last pose, velocity, local-map anchor) and the
frame's pixels before the call, and the program's outputs after it. The
reference then extracts the frame's features from the pixels itself,
detects its lines, and tracks it against that map copy; the numbers
compared are the worst over the sampled frames.

`precision` runs the reference in another precision (the control): "tf32"
lets float32 matrix products round their inputs to TF32.
"""
from __future__ import annotations

import contextlib

import torch

from ..reference import mapstate as rmap
from ..reference.geometry import camera, triangulation
from ..reference.models import tracking
from ..reference.ops import extract, gated_match, lines

# map fields that tracking reads (and the two counters it updates)
TRACK_FIELDS = ("pt_xyz", "pt_desc", "pt_normal", "pt_min_dist",
                "pt_max_dist", "pt_valid", "pt_n_obs", "pt_found",
                "pt_visible", "ln_xyz", "ln_desc", "ln_valid", "ln_cond",
                "kf_T", "kf_valid", "kf_pt_idx", "kf_ln_idx", "n_kf", "n_pt",
                "n_ln")


@contextlib.contextmanager
def precision(kind: str):
    """float32 products in IEEE float32 ("fp32") or rounded to TF32."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    on = kind == "tf32"
    torch.backends.cuda.matmul.allow_tf32 = on
    torch.backends.cudnn.allow_tf32 = on
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def copy_fields(ms, names) -> dict:
    """The named map fields as device copies."""
    return {n: getattr(ms, n).clone() for n in names}


def to_host(tree):
    """Tensors of a nested dict / list on the host."""
    if torch.is_tensor(tree):
        return tree.cpu()
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_host(v) for v in tree)
    return tree


class Reference:
    """The plain reference for one configuration's settings (`fields`, the
    `SLAMConfig` values) on `device`. It undistorts keypoints and line
    endpoints through the configuration's camera before tracking."""

    def __init__(self, fields: dict, device):
        self.f = fields
        self.device = torch.device(device)
        c = fields
        self.cam = camera.Camera.create(c["fx"], c["fy"], c["cx"], c["cy"],
                                        c["k1"], c["k2"], c["p1"], c["p2"],
                                        c["k3"], c["width"], c["height"])
        self.ext_cfg = extract.ExtractorConfig(
            n_features=c["n_features"], n_levels=c["n_levels"],
            scale=c["scale_factor"], th_fast_high=c["th_fast_high"],
            th_fast_low=c["th_fast_low"], subpixel=c["subpixel"],
            level_map=c["level_map"], sel_order=c["sel_order"],
            desc_pattern=c["desc_pattern"], sel_cap=c["sel_cap"])
        self.sf, self.sigma2 = extract.scale_factors(self.ext_cfg,
                                                     self.device)
        self.extractor = extract.PointExtractor(
            self.ext_cfg, c["height"], c["width"]).to(self.device)
        self.lines = lines.LineDetector(
            c["height"], c["width"], n_out=c["n_lf"],
            block=c["ln_detect_block"],
            min_length=max(c["ln_detect_min_length"], c["min_line_length"]
                           * min(c["width"], c["height"]))
        ).to(self.device) if c["use_lines"] else None

    def features(self, img):
        """(point features, line features or None) of a uint8 frame."""
        img = img.to(self.device).to(torch.float32)
        f = self.extractor(img)
        f = f._replace(uv_un=camera.undistort_pixels(self.cam, f.uv))
        if self.lines is None:
            return f, None
        lf = self.lines(img, None)
        ua = camera.undistort_pixels(self.cam, lf.uv_a)
        ub = camera.undistort_pixels(self.cam, lf.uv_b)
        return f, lf._replace(uv_a=ua, uv_b=ub,
                              l2d=triangulation.line_from_endpoints_2d(ua, ub))

    def track(self, snap, k1_calls=None):
        """(point features, TrackResult) of a sampled frame tracked against
        its map copy; with a list `k1_calls`, each search's inputs are
        appended to it."""
        dev = self.device
        c = self.f
        f, lf = self.features(snap["img"])
        ms = rmap.MapState(**{k: v.to(dev) for k, v in snap["map"].items()})
        anchor = snap.get("anchor")
        search = gated_match.gated_hamming_best2
        if k1_calls is not None:
            def recording(*args, gated=True):
                k1_calls.append((args, gated))
                return search(*args, gated=gated)
            tracking.gated_match.gated_hamming_best2 = recording
        try:
            res = tracking.track_local_map(
                self.cam, ms, f, snap["T_last"].to(dev),
                scale_factors=self.sf, sigma2_levels=self.sigma2, lfeats=lf,
                n_levels=c["n_levels"], scale=c["scale_factor"],
                line_info=c["track_line_info"],
                velocity=snap["velocity"].to(dev), update_stats=False,
                anchor_kf=None if anchor is None else torch.tensor(
                    anchor, device=dev),
                max_step_t=c["max_step_t"], max_step_r=c["max_step_r"])
        finally:
            tracking.gated_match.gated_hamming_best2 = search
        return f, res


def _center(T):
    T = T.to(torch.float64)
    return -(T[..., :3, :3].transpose(-1, -2) @ T[..., :3, 3:])[..., 0]


def pose_gaps(Ta, Tb) -> tuple:
    """(camera-centre distance, rotation angle in radians) between two
    world->camera poses."""
    Ta, Tb = Ta.to(torch.float64), Tb.to(torch.float64)
    dt = float(torch.linalg.vector_norm(_center(Ta) - _center(Tb)))
    R = Ta[:3, :3] @ Tb[:3, :3].T
    w = torch.stack([R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
    return dt, float(torch.atan2(0.5 * torch.linalg.vector_norm(w),
                                 0.5 * (torch.trace(R) - 1)))


def _share(diff, among) -> float:
    n = int(among.sum())
    return float((diff & among).sum()) / n if n else 0.0


def frame_numbers(out: dict, feats, res) -> dict:
    """The numbers of one frame: the program's outputs `out` (its features,
    K1's matches, the pose and the scalars) against the reference's
    features and TrackResult."""
    p = out["feats"]
    uv = feats.uv.cpu()
    same_kp = ((p["valid"] == feats.valid.cpu())
               & (~p["valid"] | ((p["uv"] == uv).all(-1)
                                 & (p["octave"] == feats.octave.cpu()))))
    either = p["valid"] | feats.valid.cpu()
    both = same_kp & p["valid"]
    bits = p["desc"] != feats.desc.cpu()
    n_bits = int(both.sum()) * bits.shape[1]
    mp, mr = out["matched_pt"], res.matched_pt.cpu()
    dt, dr = pose_gaps(out["T"], res.T.cpu())
    return {"kp_mismatch": _share(~same_kp, either),
            "desc_bit_mismatch": float(bits[both].sum()) / n_bits
            if n_bits else 0.0,
            "match_mismatch": _share(mp != mr, (mp >= 0) | (mr >= 0)),
            "pose_dt": dt, "pose_dr": dr,
            "inlier_gap": abs(int(out["scalars"][0]) - int(res.n_inliers))}


def summary(rows) -> dict:
    """Each number's worst (largest) reading over the rows."""
    out = {}
    for r in rows:
        for k, v in r.items():
            out[k] = max(out.get(k, v), v)
    return out


def as_output(feats, res) -> dict:
    """The reference's features and TrackResult in the form of a program
    output (the control put in the program's place)."""
    return {"T": res.T.cpu(), "scalars": res.scalars.cpu(),
            "matched_pt": res.matched_pt.cpu(),
            "feats": {k: getattr(feats, k).cpu()
                      for k in ("uv", "octave", "desc", "valid")}}


def control_rows(entry, ref, kind: str = "tf32") -> list:
    """The entry's sampled frames with the reference run in `kind`
    precision in the program's place, judged against the reference in
    float32."""
    rows = []
    for snap in entry.run.checks:
        f, res = ref.track(snap)
        with precision(kind):
            f2, res2 = ref.track(snap)
        rows.append(frame_numbers(as_output(f2, res2), f, res))
    return rows

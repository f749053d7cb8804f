"""The flagship per-frame program with its example arguments: the port of
`__graft_entry__.entry()`.

`entry(device)` returns `(step, (img, ms, T_pred))`. `step(img, ms,
T_pred)` is extraction (512 features, 3 levels, 240x320) ->
`camera.undistort_pixels` -> `tracking.track_local_map` against the map
`ms`, and returns `(T, n_inliers)`. On CUDA the step is a CUDA graph
(`models/step_graph`) bound to `ms` by address, the port's counterpart of
the `jax.jit` around the JAX step; `step.fn` is the same step eager. The
example arguments are the JAX entry's own draws from
`np.random.default_rng(0)`, in its order: a uniform-noise image, then 2048
random map points and their depths. Their descriptors are all zero, so no
pair passes the Hamming gate and the step returns its prediction.

    python -m plslam_tpu_torch.entry [--device cpu]

runs the step once and prints the shapes of its outputs. The dry run over
many cards is `python -m plslam_tpu_torch.parallel.multichip`.
"""
from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from .geometry import camera
from .mapstate import state as mstate
from .models import step_graph, tracking
from .ops import extract

HEIGHT, WIDTH = 240, 320


def _build(device, n_feats=512, n_levels=3, max_pt=2048, max_kf=8, h=HEIGHT,
           w=WIDTH):
    """The entry's camera, extractor, map capacities and level scales
    (`__graft_entry__._build`)."""
    cam = camera.Camera.create(fx=250.0, fy=250.0, cx=w / 2, cy=h / 2,
                               width=w, height=h)
    ext_cfg = extract.ExtractorConfig(n_features=n_feats, n_levels=n_levels)
    map_cfg = mstate.MapConfig(max_kf=max_kf, max_pt=max_pt, max_ln=64,
                               n_kp=n_feats, n_lf=32, n_levels=n_levels)
    sf, s2 = extract.scale_factors(ext_cfg, device)
    return cam, ext_cfg, map_cfg, sf, s2


def random_point_map(map_cfg, rng, device):
    """A map of `max_pt` valid random points 3-8 m ahead, no keyframe (the
    entry's, the dry run's and tests/test_parallel.py's tracking maps)."""
    P = map_cfg.max_pt
    pts = rng.uniform(-2, 2, (P, 3)).astype(np.float32)
    pts[:, 2] = rng.uniform(3, 8, P)
    normal = -pts / np.maximum(np.linalg.norm(pts, axis=-1, keepdims=True),
                               1e-6)
    ms = mstate.allocate(map_cfg, device)
    ms.pt_xyz.copy_(torch.from_numpy(pts))
    ms.pt_valid.fill_(True)
    ms.pt_max_dist.fill_(10.0)
    ms.pt_min_dist.fill_(0.5)
    ms.pt_normal.copy_(torch.from_numpy(normal))
    return ms


def entry(device=None):
    """(step, (img, ms, T_pred)) on `device`, `cuda` unless it names
    another; without a card it raises unless the caller asks for the CPU
    (which runs K1's plain version and no graph)."""
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("entry() needs a CUDA device; pass device='cpu' "
                           "for the kernels' plain versions")
    cam, ext_cfg, map_cfg, sf, s2 = _build(device)
    extractor = extract.PointExtractor(ext_cfg, HEIGHT, WIDTH).to(device)

    def fn(img, ms, T_pred):
        feats = extractor(img)
        feats = feats._replace(uv_un=camera.undistort_pixels(cam, feats.uv))
        res = tracking.track_local_map(
            cam, ms, feats, T_pred, scale_factors=sf, sigma2_levels=s2,
            n_levels=ext_cfg.n_levels, scale=ext_cfg.scale)
        return res.T, res.n_inliers

    step = step_graph.StepGraphs(device).step(fn, bound=1)
    rng = np.random.default_rng(0)
    img = torch.from_numpy(rng.uniform(0, 255, (HEIGHT, WIDTH))
                           .astype(np.float32)).to(device)
    ms = random_point_map(map_cfg, rng, device)
    return step, (img, ms, torch.eye(4, device=device))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda unless given (cpu: the kernels' plain "
                         "versions)")
    args = ap.parse_args(argv)
    step, example = entry(args.device)
    T, n_inliers = step(*example)
    print(f"entry() run OK: T {tuple(T.shape)}, n_inliers "
          f"{tuple(n_inliers.shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

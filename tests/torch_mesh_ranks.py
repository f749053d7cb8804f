"""Rank functions of the port's mesh tests (spawned processes: this module
imports neither jax nor plslam_tpu, and neither does anything it imports).

Every function takes the rank's `Mesh` first and returns numpy."""
import numpy as np
import torch

from plslam_tpu_torch.geometry import camera
from plslam_tpu_torch.mapstate import state as mstate
from plslam_tpu_torch.models import tracking
from plslam_tpu_torch.ops import extract
from plslam_tpu_torch.optim import local_ba
from plslam_tpu_torch.parallel import multichip, sharded_ba, streams

CAM = camera.Camera.create(fx=300.0, fy=300.0, cx=160.0, cy=120.0,
                           width=320, height=240)
CAM_BA = camera.Camera.create(fx=500.0, fy=500.0, cx=320.0, cy=240.0,
                              width=640, height=480)
# tests/test_parallel.py's batched-streams scenario
SCENE_CFG = extract.ExtractorConfig(n_features=128, n_levels=2)
SCENE_MAP = mstate.MapConfig(max_kf=4, max_pt=256, max_ln=16, n_kp=128,
                             n_lf=8, n_levels=2)


def torch_problem(prob: dict) -> local_ba.BAProblem:
    """A `BAProblem` of numpy fields (bf a float)."""
    return local_ba.BAProblem(**{k: v if k == "bf" or v is None
                                 else torch.from_numpy(np.array(v))
                                 for k, v in prob.items()})


def ba_and_edges(mesh, prob: dict, edges: tuple):
    """The window `prob` through the mesh BA (5 + 10 iterations, its
    decisions too: `multichip.timed_bundle_adjust`) and the edges
    (T, xyz, uv, w) through the mesh's pose system."""
    sp = sharded_ba.prepare_problem(torch_problem(prob), mesh.world)
    out = multichip.timed_bundle_adjust(mesh, sp, CAM_BA, 5, 10)
    T, *e = (torch.from_numpy(x) for x in edges)
    H, b = streams.sharded_pose_normal_equations(mesh, CAM, T, *e)
    out.update(H=H.numpy(), b=b.numpy())
    return out


def scene_step(cam, sf, s2):
    """tests/test_parallel.py's per-stream step (extraction, undistorted
    pixels taken as the raw ones, tracking from the identity): a function
    (img, ms) -> (T, scalars)."""
    extractor = extract.PointExtractor(SCENE_CFG, 240, 320)

    def one(img, ms):
        f = extractor(img)
        f = f._replace(uv_un=f.uv)
        r = tracking.track_local_map(cam, ms, f, torch.eye(4),
                                     scale_factors=sf, sigma2_levels=s2,
                                     n_levels=2, scale=1.2)
        return r.T, r.scalars
    return one


def scene_maps(pts: np.ndarray) -> mstate.MapState:
    """The stacked maps of tests/test_parallel.py's streams, one per row of
    `pts` (S, 256, 3): every point valid, 0.1-10 m, facing the camera."""
    maps = []
    for p in pts:
        ms = mstate.allocate(SCENE_MAP, "cpu")
        ms.pt_xyz.copy_(torch.from_numpy(p))
        ms.pt_valid.fill_(True)
        ms.pt_max_dist.fill_(10.0)
        ms.pt_min_dist.fill_(0.1)
        ms.pt_normal.copy_(torch.from_numpy(
            -p / np.linalg.norm(p, axis=-1, keepdims=True)))
        maps.append(ms)
    return mstate.stack(maps)


def streams_and_tracker(mesh, imgs, pts, tracker_args):
    """The scenario's stream-sharded step (every stream's T and scalars,
    gathered), and `multichip.lockstep_rank(mesh, *tracker_args)`."""
    sf, s2 = extract.scale_factors(SCENE_CFG)
    one = scene_step(CAM, sf, s2)
    img, ms = streams.shard_streams(mesh, (torch.from_numpy(imgs),
                                           scene_maps(pts)))
    T, sc = (streams.gather_streams(mesh, x)
             for x in torch.func.vmap(one)(img, ms))
    return dict(T=T.numpy(), scalars=sc.numpy(),
                tracker=multichip.lockstep_rank(mesh, *tracker_args))

#!/usr/bin/env python3
"""Loop (b)'s Sim3 stage for keyframe 28 and candidate 2, the JAX package
against the port, stage by stage, on the CPU, on the same map and the same
RANSAC minimal sets.

1. Runs the JAX package's `System` over loop (b) of `chip_smoke.py` (the
   box circuit of tests/test_loop_closure_e2e.py at the `SLAMConfig`
   defaults) until its loop closer resolves keyframe 28's candidates, and
   saves that map (the map the stage sees, keyframe 29 inserted), the
   candidates' group rows and the RANSAC seed to `--map` (reused when the
   file exists).
2. Runs the JAX package's `_sim3_stage_impl` and the port's `_sim3_stage`
   on that map (carried over with `mapstate.checkpoint.from_numpy`), the
   port on the JAX package's minimal sets, and prints per stage: the pair
   matches, the RANSAC inliers and S12, the first Sim3 LM's inliers and
   S12, the SearchBySim3 pairs (the second LM's mask), the second LM's
   inliers and S12, and the group count.
3. Runs the port's RANSAC and each port LM again on the JAX package's own
   inputs to that stage, so that a gap is pinned to one stage.

    JAX_PLATFORMS=cpu python scripts/loop_b_stage.py [--k 28 --c 2]

Step 1 takes a few minutes on a CPU, step 2 seconds.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))


class _Stop(Exception):
    pass


def build_map(path: Path, k: int):
    """Run the JAX System until its closer resolves keyframe k's
    candidates; save the map, the pending selection and the seed."""
    import jax
    jax.config.update("jax_platforms", "cpu")
    import chip_smoke as cs
    from plslam_tpu.models import system as jsys

    _, frames = cs.render_loop_sequence()
    slam = jsys.System(jsys.SLAMConfig(**dataclasses.asdict(
        cs.loop_config(small=False))))
    lc = slam.loop_closer
    consistency = lc._consistency

    def watched(pending):
        if pending is not None and int(pending[0]) == k:
            pk, tid, tsc, rows = pending
            out = {f"ms_{n}": np.asarray(v)
                   for n, v in slam.ms._asdict().items()}
            np.savez(path, top_id=np.asarray(tid), top_sc=np.asarray(tsc),
                     rows=np.asarray(rows),
                     seed=np.int64(slam.cfg.seed + lc.n_loops), **out)
            raise _Stop
        return consistency(pending)
    lc._consistency = watched
    try:
        for i, img in enumerate(frames):
            slam.track_monocular(img, i / 30.0)
    except _Stop:
        print(f"saved the map at keyframe {k}'s Sim3 stage (frame {i}) to "
              f"{path}")
        return
    raise SystemExit(f"keyframe {k}'s candidates were never resolved")


def _recorder(module, name, log, key):
    """Wraps module.name so that each call appends (args, output) to
    log[key]; returns a function that restores it."""
    fn = getattr(module, name)

    def wrapper(*args, **kwargs):
        out = fn(*args, **kwargs)
        log.setdefault(key, []).append((args, kwargs, out))
        return out
    setattr(module, name, wrapper)
    return lambda: setattr(module, name, fn)


def compare(path: Path, k: int, c: int):
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch
    import chip_smoke as cs
    from plslam_tpu.geometry import camera as jcam
    from plslam_tpu.mapstate import state as jst
    from plslam_tpu.models import loop_closing as jlc
    from plslam_tpu.ops import extract as jext
    from plslam_tpu.optim import sim3_opt as jso
    from plslam_tpu.solvers import horn as jhorn
    from plslam_tpu_torch.geometry import camera as tcam, sim3 as tsim3
    from plslam_tpu_torch.mapstate import checkpoint, state as tst
    from plslam_tpu_torch.models import loop_closing as tlc
    from plslam_tpu_torch.ops import extract as text
    from plslam_tpu_torch.optim import sim3_opt as tso
    from plslam_tpu_torch.solvers import horn as thorn

    data = np.load(path)
    arrays = {n[3:]: data[n] for n in data.files if n.startswith("ms_")}
    top_id = data["top_id"].tolist()
    if c not in top_id:
        raise SystemExit(f"candidate {c} is not among keyframe {k}'s "
                         f"candidates {top_id}")
    group = data["rows"][top_id.index(c)]
    seed = int(data["seed"])
    cfg = cs.loop_config(small=False)
    ms_j = jst.MapState(**{n: jnp.asarray(v) for n, v in arrays.items()})
    ms_t = checkpoint.from_numpy(arrays, "cpu")
    map_cfg = jst.MapConfig(
        max_kf=arrays["kf_T"].shape[0], max_pt=arrays["pt_xyz"].shape[0],
        max_ln=arrays["ln_xyz"].shape[0], n_kp=arrays["kf_uv"].shape[1],
        n_lf=arrays["kf_ln_valid"].shape[1], n_levels=cfg.n_levels,
        scale=cfg.scale_factor)
    ecfg = dict(n_features=cfg.n_features, n_levels=cfg.n_levels,
                scale=cfg.scale_factor)
    _, s2_j = jext.scale_factors(jext.ExtractorConfig(**ecfg))
    _, s2_t = text.scale_factors(text.ExtractorConfig(**ecfg))
    cam_args = (cfg.fx, cfg.fy, cfg.cx, cfg.cy, 0, 0, 0, 0, 0, cfg.width,
                cfg.height)
    lj = jlc.LoopClosing(jcam.Camera.create(*cam_args), map_cfg, s2_j, None,
                         use_jit=False)
    lt = tlc.LoopClosing(tcam.Camera.create(*cam_args),
                         tst.MapConfig(*map_cfg), s2_t)

    # the JAX stage, recording its pieces and its minimal sets
    logj, logt = {}, {}
    undo = [_recorder(jhorn, "ransac_sim3", logj, "ransac"),
            _recorder(jso, "optimize_sim3", logj, "lm"),
            _recorder(lj, "_match_pairs_impl", logj, "pairs")]
    try:
        out_j = lj._sim3_stage_impl(ms_j, jnp.int32(k), jnp.int32(c),
                                    jnp.asarray(group),
                                    jax.random.PRNGKey(seed))
    finally:
        for u in undo:
            u()
    (key, X1, X2, uv1, uv2, mask, *_), _, _ = logj["ransac"][0]
    g = jax.random.gumbel(key, (1024, X1.shape[0]))
    sets = np.array(jax.lax.top_k(jnp.where(mask[None, :], g, -jnp.inf),
                                   3)[1])

    undo = [_recorder(thorn, "ransac_sim3", logt, "ransac"),
            _recorder(tso, "optimize_sim3", logt, "lm"),
            _recorder(lt, "_match_pairs", logt, "pairs")]
    try:
        with torch.no_grad():
            out_t = lt._sim3_stage(ms_t, k, c, torch.from_numpy(group), None,
                                   sets=torch.from_numpy(sets))
    finally:
        for u in undo:
            u()

    n = lambda x: x.detach().numpy() if torch.is_tensor(x) else np.asarray(x)
    s3 = lambda S: (float(n(S.s)), n(S.R), n(S.t))

    def s3_gap(a, b):
        a, b = s3(a), s3(b)
        return max(abs(a[0] - b[0]), float(np.abs(a[1] - b[1]).max()),
                   float(np.abs(a[2] - b[2]).max()))

    rows = []
    pj, pt = logj["pairs"][0][2], logt["pairs"][0][2]
    rows.append(("pair matches (mutual, ratio 0.75, <= 50)",
                 int(n(pj[1]).sum()), int(n(pt[1]).sum()),
                 f"ok masks differ in {int((n(pj[1]) != n(pt[1])).sum())}"))
    rj, rt = logj["ransac"][0][2], logt["ransac"][0][2]
    rows.append(("RANSAC inliers", int(n(rj.n_inliers)), int(n(rt.n_inliers)),
                 f"S12 max gap {s3_gap(rj.S12, rt.S12):.2e}"))
    for i, name in enumerate(("first LM", "second LM")):
        aj, _, oj = logj["lm"][i]
        at, _, ot = logt["lm"][i]
        rows.append((f"{name} mask", int(n(aj[6]).sum()), int(n(at[6]).sum()),
                     f"masks differ in {int((n(aj[6]) != n(at[6])).sum())}"))
        rows.append((f"{name} inliers", int(n(oj.n_inliers)),
                     int(n(ot.n_inliers)),
                     f"S12 max gap {s3_gap(oj.S12, ot.S12):.2e}"))
    rows.append(("group count (total matches)", int(n(out_j[0])),
                 int(n(out_t[0])), ""))
    print(f"Sim3 stage ({k}, {c}) on the JAX map, seed {seed}: JAX | port "
          f"(the port on the JAX package's sets)")
    for name, a, b, note in rows:
        print(f"  {name:42s} {a:5d} | {b:5d}  {note}")

    # each stage again, the port on the JAX package's inputs to it
    to_t = lambda x: torch.from_numpy(np.array(x))
    cam_t = lt.cam
    with torch.no_grad():
        args = logj["ransac"][0][0]
        rr = thorn.ransac_sim3(None, *map(to_t, args[1:6]), cam_t,
                               *map(to_t, args[7:9]),
                               fix_scale=lt.fix_scale, sets=to_t(sets))
        print(f"  port RANSAC on JAX's pairs: {int(rr.n_inliers)} inliers "
              f"(JAX {int(n(rj.n_inliers))}), S12 max gap "
              f"{s3_gap(rr.S12, rj.S12):.2e}, inlier masks differ in "
              f"{int((n(rr.inliers) != n(rj.inliers)).sum())}")
        for i, name in enumerate(("first LM", "second LM")):
            a, _, oj = logj["lm"][i]
            S = tsim3.Sim3(*(to_t(x) for x in a[1]))
            ot = tso.optimize_sim3(cam_t, S, *map(to_t, a[2:9]),
                                   fix_scale=lt.fix_scale)
            print(f"  port {name} on JAX's inputs: {int(ot.n_inliers)} "
                  f"inliers (JAX {int(n(oj.n_inliers))}), S12 max gap "
                  f"{s3_gap(ot.S12, oj.S12):.2e}, inlier masks differ in "
                  f"{int((n(ot.inliers) != n(oj.inliers)).sum())}")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=28)
    ap.add_argument("--c", type=int, default=2)
    ap.add_argument("--map", type=Path,
                    default=ROOT / "build" / "loop_b_kf28.npz")
    args = ap.parse_args()
    if not args.map.exists():
        args.map.parent.mkdir(parents=True, exist_ok=True)
        build_map(args.map, args.k)
    compare(args.map, args.k, args.c)
    return 0


if __name__ == "__main__":
    sys.exit(main())

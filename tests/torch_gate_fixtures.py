"""The JAX package's end-to-end gates as data, for either package's System.

Each gate is the fixture of a slow JAX test (scene, trajectory, frame count,
`SLAMConfig` fields) and its bars, each bar beside the file and line it
comes from. `tests/test_torch_gates.py` holds the port to them on the card;
`scripts/gates_yardstick.py` runs either package on the CPU on the same
frames. Frames come from the port's renderer (`plslam_tpu_torch.datasets`,
the JAX package's renderer copied), in worker processes. This module imports
neither jax nor plslam_tpu: a caller passes its package's `System` and
`SLAMConfig`.

G1 tests/test_loop_closure_default_cfg.py  explicit loop at the defaults
G2 tests/test_gba_e2e.py                   global BA cuts focal drift
G3 tests/test_loop_e2e.py                  an out-and-back sweep
G4 tests/test_line_cond_gate.py            short baseline: lines gated
G5 tests/test_line_cond_gate.py            healthy baseline: lines pass
G6 tests/test_growth.py                    growth past tiny caps
"""
from __future__ import annotations

import multiprocessing
import time
from concurrent.futures import ProcessPoolExecutor

import numpy as np

CAM = dict(fx=500.0, fy=500.0, cx=320.0, cy=240.0, k1=0, k2=0, p1=0, p2=0,
           k3=0)
# tests/test_line_cond_gate.py:25-34, `_cfg`'s base
LINE_COND_BASE = dict(CAM, n_features=256, n_levels=2, max_kf=24,
                      max_pt=2048, max_ln=128, n_lf=64, ba_window=5,
                      ba_points=1024, ba_lines=64, use_lines=True,
                      track_line_info=1.0, use_loop_closing=False)

# name: (JAX test, scene (kind, kwargs), trajectory (n, kind, amplitude),
# frames taken, SLAMConfig fields)
GATES = {
    "G1": dict(
        test="tests/test_loop_closure_default_cfg.py:29-68",
        scene=("photo", dict(seed=5, fx=500.0, fy=500.0, layout="room")),
        traj=(420, "circle", 3.0), n=420,
        cfg=dict(CAM, fx=512.0, fy=512.0,       # 2.4% bias (:36)
                 n_features=512, n_levels=3, max_kf=64, max_pt=8192,
                 max_ln=256, n_lf=64, ba_window=5, ba_points=1536,
                 kf_max_interval=3, kf_min_interval=2,
                 use_loop_closing=True, grow_map=True)),
    "G2": dict(
        test="tests/test_gba_e2e.py:12-51",
        scene=("scene", dict(seed=4)), traj=(72, "loop", 1.6), n=72,
        cfg=dict(CAM, fx=510.0, fy=510.0,       # 2% focal error (:17-18)
                 n_features=512, n_levels=3, max_kf=28, max_pt=6144,
                 ba_window=5, ba_points=1536, kf_max_interval=4,
                 kf_ref_ratio=2.0, kf_min_interval=4, level_map=0,
                 tri_covis=False, use_loop_closing=True)),
    "G3": dict(
        test="tests/test_loop_e2e.py:12-40",
        scene=("scene", dict(seed=4)), traj=(44, "loop", 1.0), n=44,
        cfg=dict(CAM, n_features=512, n_levels=3, max_kf=20, max_pt=4096,
                 ba_window=5, ba_points=1024, kf_max_interval=4,
                 use_loop_closing=True)),
    "G4": dict(
        test="tests/test_line_cond_gate.py:38-72",
        scene=("scene", dict(seed=9)), traj=(240, "orbit", 0.8), n=70,
        cfg=dict(LINE_COND_BASE, kf_max_interval=2, kf_min_interval=2,
                 kf_ref_ratio=2.0, grow_map=False)),
    "G5": dict(
        test="tests/test_line_cond_gate.py:75-96",
        scene=("scene", dict(seed=9, n_lines=24)), traj=(40, "orbit", 1.0),
        n=40,
        cfg=dict(LINE_COND_BASE, n_levels=3, max_pt=4096, max_ln=256,
                 n_lf=96, ba_points=1024, ba_lines=128, kf_max_interval=3,
                 kf_min_interval=3, kf_ref_ratio=2.0, min_init_matches=60)),
    "G6": dict(
        test="tests/test_growth.py:52-81",
        scene=("scene", dict(seed=2)), traj=(48, "orbit", 1.0), n=48,
        cfg=dict(CAM, n_features=512, n_levels=3, max_kf=6, max_pt=1024,
                 max_ln=64, ba_window=4, ba_points=1024, kf_max_interval=3,
                 kf_min_interval=3, kf_ref_ratio=2.0,
                 use_loop_closing=False)),
}

# the JAX package on the CPU on the same frames (scripts/gates_yardstick.py),
# printed beside the port's
JAX_NOTES = {
    "G1": "JAX at SLAMConfig.seed 0-4 (JAX_G1): passes at 0 (closure "
          "(44, 0), kf ATE 0.0186), misses at 1-4 (kf ATE 1.01 / 0.416 / "
          "2.88 / 1.83)",
    "G2": "JAX: kf ATE 0.0386 -> 0.0100 after global BA; with its "
          "ba_select fault mended 0.0084 -> 0.0063 (RECORDED)",
    "G3": "JAX: 43 frames tracked, ATE 0.0310, no loop",
    "G4": "JAX: no initialization in the 70 frames (RECORDED)",
    "G5": "JAX: 11 lines, median ln_cond 1.0",
    "G6": "JAX: 7 growths, 16 keyframes, 376 points",
}

# G1 over these `SLAMConfig.seed` values (the random draws of two-view
# initialization, relocalization and the loop closer's RANSAC). The JAX
# package passes its test's bars at seed 0 only (its fixture's) and misses
# them at 1-4 (ROADMAP Queue 3: both packages accept a loop closure whose
# rotation agrees with the map's and whose translation or scale does not).
# The port draws from another generator, so a seed of one package is not
# the same draw in the other: tests/test_torch_gates.py holds the port's
# count of passes over the seeds to at least the JAX package's (`passes`).
G1_SEEDS = (0, 1, 2, 3, 4)
# the JAX package on the CPU on the gate's frames, one run per seed
# (scripts/gates_yardstick.py --gate G1 --seed S); JAX runs on the CPU are
# repeatable
JAX_G1 = {
    0: dict(n_kf=45, state="OK", n_loops=2, closure=(44, 0), n_gba=1,
            lost=0, ate_final=0.018588, ate_pre=0.015357),
    1: dict(n_kf=35, state="OK", n_loops=0, closure=None, n_gba=0, lost=13,
            ate_final=1.0132),
    2: dict(n_kf=41, state="OK", n_loops=2, closure=(40, 0), n_gba=1,
            lost=0, ate_final=0.41576, ate_pre=0.018663),
    3: dict(n_kf=43, state="OK", n_loops=3, closure=(42, 0), n_gba=3,
            lost=1, ate_final=2.8754, ate_pre=2.9497),
    4: dict(n_kf=35, state="OK", n_loops=0, closure=None, n_gba=0, lost=6,
            ate_final=1.8319),
}

# Gates whose JAX test turns on a filed fault of the JAX package (ROADMAP
# Queue 3), run by both packages on the same frames. The card test holds the
# port to its recorded behaviour (`recorded_failures`) in place of the JAX
# test's bars; `failures` keeps the JAX test's own.
RECORDED = {
    # The JAX package's drift here (keyframe ATE 0.0386 before global BA,
    # 0.0100 after) is its `mapping.ba_select` fault: with the fault mended
    # (scripts/gates_yardstick.py --mend-ba-select) it reads 0.0084 ->
    # 0.0063 and misses :50 and :51 as the port does (0.0090 -> 0.0072 on
    # the CPU, 544 points in both). Held: :43, no drift above :50's 0.02,
    # and global BA lowering the keyframe ATE.
    "G2": "the drift is the JAX package's ba_select fault",
    # The JAX System does not initialize in these 70 frames either
    # (tests/test_line_cond_gate.py:65 fails on the JAX package: 0 frames
    # tracked, 0 keyframes). Held: :58, and no initialization, as the JAX
    # package.
    "G4": "the JAX package does not initialize in the 70 frames",
}


def _np(x):
    """An array of either package (a torch tensor, a jax array) in numpy."""
    if hasattr(x, "detach"):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def poses(gate: str) -> np.ndarray:
    from plslam_tpu_torch.datasets import synthetic
    n_all, kind, amp = GATES[gate]["traj"]
    return synthetic.trajectory(n_all, kind, amplitude=amp)[:GATES[gate]["n"]]


def _render(args):
    """Frames (float32) of a scene at the given poses (a worker)."""
    kind, kwargs, Ts = args
    from plslam_tpu_torch.datasets import synthetic, textured
    scene = textured.make_photo_scene(**kwargs) if kind == "photo" else \
        synthetic.make_scene(**kwargs)
    return np.stack([synthetic.render(scene, T) for T in Ts])


def render_frames(scene, Ts, workers: int = 8) -> np.ndarray:
    """Frames (float32) of `scene`, a (kind, kwargs) pair ("photo" for
    `textured.make_photo_scene`, else `synthetic.make_scene`), at the poses
    `Ts`, rendered in `workers` processes."""
    jobs = [(*scene, Ts[i::workers]) for i in range(workers)]
    with ProcessPoolExecutor(workers, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        out = list(pool.map(_render, jobs))
    frames = np.empty((len(Ts),) + out[0].shape[1:], np.float32)
    for i in range(workers):
        frames[i::workers] = out[i]
    return frames


def render(gate: str):
    """(poses, frames) of a gate."""
    Ts = poses(gate)
    return Ts, render_frames(GATES[gate]["scene"], Ts)


def run(gate: str, System, SLAMConfig, frames, Ts, overrides=None,
        **system_kwargs) -> dict:
    """The gate's System (its `SLAMConfig` fields, with `overrides`) over
    its frames, flushed, and its numbers (`metrics`); G2 runs
    `run_global_ba()` after the flush, as its test."""
    slam = System(SLAMConfig(**{**GATES[gate]["cfg"], **(overrides or {})}),
                  **system_kwargs)
    t0 = time.perf_counter()
    for i, img in enumerate(frames):
        slam.track_monocular(img, i / 30.0)
    slam.flush()
    m = dict(gate=gate, host_s=None)
    if gate == "G2":
        m["ate_before"] = _kf_ate(slam, Ts)
        slam.run_global_ba()
        m["ate_after"] = _kf_ate(slam, Ts)
    m["host_s"] = round(time.perf_counter() - t0, 1)
    m.update(metrics(gate, slam, Ts))
    return m


def _kf_ate(slam, Ts) -> float:
    from plslam_tpu_torch.datasets import synthetic
    n_kf = slam.n_kf_host
    fid = _np(slam.ms.kf_frame_id)[:n_kf]
    return float(synthetic.ate_rmse(_np(slam.ms.kf_T)[:n_kf], Ts[fid]))


def _tracked(slam, n):
    """(frame indices with a trajectory row, their poses)."""
    est = {ts: _np(T) for ts, T in slam.trajectory}
    idx = [i for i in range(n) if (i / 30.0) in est]
    return idx, np.stack([est[i / 30.0] for i in idx]) if idx else None


def metrics(gate: str, slam, Ts) -> dict:
    """A gate's numbers on a flushed System of either package."""
    from plslam_tpu_torch.datasets import synthetic
    n, n_kf = len(Ts), slam.n_kf_host
    lc = slam.loop_closer
    m = dict(n_kf=n_kf, state=str(slam.state),
             n_loops=lc.n_loops if lc is not None else 0,
             closure=tuple(int(x) for x in lc.last_closure)
             if lc is not None and lc.last_closure is not None else None,
             n_gba=slam.n_gba_done, n_growths=slam.n_growths,
             points=slam.n_map_points(),
             lost=sum(1 for s in slam.stats if s.get("lost")))
    idx, est = _tracked(slam, n)
    m["tracked"] = len(idx)
    if gate == "G1":
        fid = _np(slam.ms.kf_frame_id)[:n_kf]
        gt = Ts[fid]
        m["ate_final"] = float(synthetic.ate_rmse(_np(slam.ms.kf_T)[:n_kf],
                                                  gt))
        if m["closure"] is not None:
            k = min(m["closure"][0] + 1, n_kf)
            m["ate_pre"] = float(synthetic.ate_rmse(
                _np(lc.pre_correction_kf_T)[:k], gt[:k]))
    elif gate in ("G3", "G4"):
        m["ate"] = float(synthetic.ate_rmse(est, Ts[idx])) if idx else None
        if gate == "G4":
            tracked = [i for i in idx if i > 0]
            m["first_tracked"] = tracked[0] if tracked else -1
            m["last_tracked"] = tracked[-1] if tracked else -1
            m["tracked_after_init"] = len(tracked)
            m["unbroken"] = bool(tracked) and len(tracked) == (
                tracked[-1] - tracked[0] + 1)
    if gate in ("G4", "G5"):
        v = _np(slam.ms.ln_valid)
        m["lines"] = int(v.sum())
        cond = _np(slam.ms.ln_cond)[v]
        m["ln_cond_median"] = float(np.median(cond)) if len(cond) else None
    if gate == "G6":
        m["max_kf"] = slam.map_cfg.max_kf
        P = slam.ms.pt_xyz.shape[0]
        m["bindings_in_range"] = bool((_np(slam.ms.kf_pt_idx) < P).all())
        m["last_lost"] = bool(slam.stats[-1]["lost"])
    return m


def failures(gate: str, m: dict) -> list:
    """The bars of the gate's JAX test that `m` misses (empty: passes)."""
    bad = []

    def need(ok, what):
        if not ok:
            bad.append(what)
    if gate == "G1":     # tests/test_loop_closure_default_cfg.py:49-68
        need(m["n_loops"] >= 1, "no explicit loop closure fired (:49)")
        if m["closure"] is not None:
            k, c = m["closure"]
            need(k - c >= 30, f"closure ({k}, {c}) is not the lap-end "
                              f"revisit (:51)")
        need(m["n_gba"] >= 1, "async global BA never completed (:52)")
        need(m["state"] == "OK", f"state {m['state']} (:55)")
        need(m["n_kf"] >= 35, f"only {m['n_kf']} keyframes (:57)")
        need(m["ate_final"] < 0.06, f"final kf ATE {m['ate_final']:.4f} "
                                    f">= 0.06 (:67)")
        if m.get("ate_pre") is not None:
            need(m["ate_final"] < 3.0 * m["ate_pre"],
                 f"final kf ATE {m['ate_final']:.4f} >= 3 x pre "
                 f"{m['ate_pre']:.4f} (:68)")
    elif gate == "G2":   # tests/test_gba_e2e.py:43-51
        need(m["n_kf"] >= 6, f"{m['n_kf']} keyframes (:43)")
        need(m["ate_before"] > 0.02, f"no drift accumulated "
                                     f"({m['ate_before']:.4f}) (:50)")
        need(m["ate_after"] < 0.6 * m["ate_before"],
             f"global BA took kf ATE {m['ate_before']:.4f} to "
             f"{m['ate_after']:.4f}, not below 0.6 x (:51)")
    elif gate == "G3":   # tests/test_loop_e2e.py:32-37
        need(m["tracked"] >= 36, f"tracked only {m['tracked']} (:32)")
        need(m["ate"] is not None and m["ate"] < 0.08,
             f"ATE {m['ate']} m (:37)")
    elif gate == "G4":   # tests/test_line_cond_gate.py:58-72
        need(m["lines"] <= 2, f"gate admitted {m['lines']} short-baseline "
                              f"lines (:58)")
        need(m["unbroken"] and m["last_tracked"] == 70 - 1,
             f"tracking dropped frames after init: "
             f"{m['tracked_after_init']} in [{m['first_tracked']}, "
             f"{m['last_tracked']}] (:65-68)")
        need(m["tracked_after_init"] >= 40,
             f"init too late: tracked {m['tracked_after_init']}/70 (:69)")
        need(m["ate"] is not None and m["ate"] < 0.15,
             f"full-weight ATE {m['ate']} (:72)")
    elif gate == "G5":   # tests/test_line_cond_gate.py:92-94
        need(m["lines"] >= 3, f"only {m['lines']} lines survived (:92)")
        need(m["ln_cond_median"] is not None and m["ln_cond_median"] >= 0.8,
             f"median soft weight {m['ln_cond_median']} (:94)")
    elif gate == "G6":   # tests/test_growth.py:71-81
        need(m["n_growths"] >= 2, f"{m['n_growths']} growths (:71)")
        need(m["max_kf"] > 6, f"max_kf {m['max_kf']} (:72)")
        need(m["n_kf"] > 6, f"{m['n_kf']} keyframes (:74)")
        need(m["points"] > 0, "no map point (:75)")
        need(m["bindings_in_range"], "a binding past the map (:79)")
        need(not m["last_lost"], "the last frame is LOST (:81)")
    return bad


def passes(gate: str, runs) -> int:
    """How many of the numbers `runs` (an iterable of `metrics`) meet the
    gate's JAX test's bars."""
    return sum(not failures(gate, m) for m in runs)


def recorded_failures(gate: str, m: dict) -> list:
    """What `m` misses of the port's recorded behaviour on a `RECORDED`
    gate (empty: as recorded)."""
    bad = []
    if gate == "G2":
        if m["n_kf"] < 6:
            bad.append(f"{m['n_kf']} keyframes (:43)")
        if not m["ate_before"] < 0.02:
            bad.append(f"kf ATE {m['ate_before']:.4f} before global BA, "
                       f"above the mended JAX package's regime (< 0.02)")
        if not m["ate_after"] < m["ate_before"]:
            bad.append(f"global BA took kf ATE {m['ate_before']:.4f} to "
                       f"{m['ate_after']:.4f}")
    elif gate == "G4":
        if m["lines"] > 2:
            bad.append(f"gate admitted {m['lines']} short-baseline lines "
                       f"(:58)")
        if m["n_kf"] or m["tracked"]:
            bad.append(f"initialized ({m['n_kf']} keyframes, {m['tracked']} "
                       f"frames tracked), where the JAX package does not: "
                       f"hold the port to :65-72 again")
    return bad


def photo_case(seed: int, seq, device=None) -> dict:
    """The round-5 photo campaign's case for one seed, run by the port:
    the 300-frame head-to-head sequence (`chip_smoke.photo_poses()`,
    `make_photo_scene(seed=seed)`) written as a TUM sequence under `seq`
    and run through `examples.mono_tum` (on `device`, the card by default),
    as `chip_smoke.run_photo_phase` does for seed 5. Returns its keyframe
    ATE after Sim3 alignment, the trajectory's rows, the span, the
    driver's stats and K1's launches."""
    import json
    from pathlib import Path

    import chip_smoke
    from plslam_tpu_torch.datasets import textured
    seq = Path(seq)
    Ts = chip_smoke.photo_poses()
    frames = np.clip(render_frames(("photo", dict(
        seed=seed, fx=chip_smoke.FX, fy=chip_smoke.FX)), Ts), 0, 255
    ).astype(np.uint8)
    tss = [i / 30.0 for i in range(len(Ts))]
    textured.write_tum_sequence(str(seq), frames, tss)
    (seq / "settings.yaml").write_text(chip_smoke.settings_yaml({}, 1000, 128))
    argv = [seq / "settings.yaml", seq, "CameraTrajectory.txt"]
    rc, n_k1, _ = chip_smoke.run_driver(
        "mono_tum", argv + ([] if device is None else ["--device", device]),
        seq)
    if rc != 0:
        raise RuntimeError(f"mono_tum returned {rc}")
    stats = json.loads((seq / "mono_tum_stats.json").read_text())
    ts_key = [round(t, 6) for t in tss]
    rows = {round(k, 6): v for k, v in chip_smoke.tum_centers(
        seq / "CameraTrajectory.txt").items()}
    kf_rows = {round(k, 6): v for k, v in chip_smoke.tum_centers(
        seq / "KeyFrameTrajectory.txt").items()}
    kidx, kest = chip_smoke.by_frame(kf_rows, ts_key)
    kf_ate = chip_smoke.ate_of(kest, chip_smoke.centers(Ts)[kidx], True) \
        if len(kidx) >= 3 else float("nan")
    return dict(kf_ate=kf_ate, n_kf_rows=len(kidx), rows=len(rows),
                span=chip_smoke.span_of(Ts), stats=stats, k1=n_k1)


def photo_line(package: str, seed: int, r: dict) -> str:
    """One printed line of a photo case's numbers."""
    st = r["stats"]
    return (f"photo seed {seed} ({package}): keyframe ATE {r['kf_ate']:.5f} "
            f"m over {r['n_kf_rows']} keyframes, {r['rows']} rows, "
            f"{st['lost_after_init']} LOST after init, {st['n_kf']} "
            f"keyframes, {st['map_points']} points, loops {st['n_loops']}, "
            f"median tracking {1e3 * st['median_track_s']:.2f} ms, "
            f"{st['end_to_end_fps']:.2f} frames/s end to end, K1 launches "
            f"{r['k1']}")


def line(package: str, m: dict) -> str:
    """One printed line of a gate's numbers."""
    keys = [k for k in m if k not in ("gate",)]
    vals = ", ".join(f"{k} {m[k]:.5g}" if isinstance(m[k], float)
                     else f"{k} {m[k]}" for k in keys)
    return f"gate {m['gate']} ({package}): {vals}"

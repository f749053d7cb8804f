#!/usr/bin/env python3
"""The JAX package's end-to-end gates (tests/torch_gate_fixtures.py) for
either package: the JAX package's `System` on the CPU (default) or the
PyTorch port's (`--package port`, on the card; `--device cpu` for the
comparison on a machine without one), on the same rendered frames. Prints
each run's numbers and the JAX test's bars it misses, the line that
tests/test_torch_gates.py prints for the port on the card.

    JAX_PLATFORMS=cpu python scripts/gates_yardstick.py \\
        [--package jax|port] [--gate G1 G2 ...] [--seed S ...] \\
        [--repeat N] [--mend-ba-select] [--device cpu] [--deterministic]
    python scripts/gates_yardstick.py --package port --photo 5 11 23 37 41 \\
        [--device cpu]

`--seed` runs each gate once per `SLAMConfig.seed` given (the random
draws of two-view initialization, relocalization and the loop closer's
RANSAC), `--repeat` each of those N times (the port on the card sums floats
in an order that moves from run to run; `--deterministic` turns on torch's
deterministic algorithms). Each run also prints every loop closure it
accepted: (k, c, the Sim3's scale, its translation, the map's translation
of keyframe k relative to c before the correction); for the port also the
loop closer's drift-gate readings: (k, c, angle in rad) of every candidate
that passed the Sim3 stage's counts. `--photo` runs the port's photo
campaign cases instead (`torch_gate_fixtures.photo_case`, the cases of
tests/test_torch_gates.py::test_photo_campaign) and the round-5 contract's
mean and max / min over the seeds given. `--mend-ba-select` runs the JAX
package with the fault of its `mapping.ba_select` mended in this process
(ROADMAP Queue 3: each keyframe's unselected keypoints write BA slot 0, so
its observation becomes (0, 0)): the grids are written at the selected
lanes only, as the port writes them. The package's files stay as they
are.

G1 (420 photo frames with loop closing) takes ~4 min on a CPU for the JAX
package and ~2 min on an H100 for the port, the others 1-7 min on a CPU.
The photo campaign's JAX side is scripts/ab_ours.py --cpu (one seed per
run: SCENE_SEED, SEQ_DIR).
"""
from __future__ import annotations

import argparse
import importlib
import os
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "tests")]

import torch_gate_fixtures as gates  # noqa: E402


# `ba_select`'s grid writes, each with the fault and mended: the lanes
# without a BA slot are dropped instead of writing slot 0
BA_SELECT_MENDS = (
    ("""    obs_uv = jax.vmap(lambda o, s, u, h: o.at[s].set(
        jnp.where(h[:, None], u, o[s])))(obs_uv, slot_safe, ms.kf_uv[ids_c], has)""",
     """    drop = jnp.where(has, slot_safe, p_ba)
    obs_uv = jax.vmap(lambda o, s, u: o.at[s].set(u, mode="drop"))(
        obs_uv, drop, ms.kf_uv[ids_c])"""),
    ("""    obs_s2 = jax.vmap(lambda o, s, v, h: o.at[s].set(
        jnp.where(h, v, o[s])))(obs_s2, slot_safe, s2_rows, has)""",
     """    obs_s2 = jax.vmap(lambda o, s, v: o.at[s].set(v, mode="drop"))(
        obs_s2, drop, s2_rows)"""),
    ("""    ln_obs_l2d = jax.vmap(lambda o, s, u, h: o.at[s].set(
        jnp.where(h[:, None], u, o[s])))(ln_obs_l2d, l_slot_safe,
                                         ms.kf_ln_l2d[ids_c], l_has)""",
     """    ln_obs_l2d = jax.vmap(lambda o, s, u: o.at[s].set(u, mode="drop"))(
        ln_obs_l2d, jnp.where(l_has, l_slot_safe, l_ba),
        ms.kf_ln_l2d[ids_c])"""),
)


def mend_jax_ba_select():
    """Replaces `plslam_tpu.models.mapping.ba_select` in this process by
    its source with `BA_SELECT_MENDS` applied (before any System exists,
    so every caller binds the mended function)."""
    import inspect
    from plslam_tpu.models import mapping
    src = inspect.getsource(mapping.ba_select)
    for old, new in BA_SELECT_MENDS:
        if old not in src:
            raise RuntimeError("ba_select's source changed: " + old[:60])
        src = src.replace(old, new)
    exec(compile(src, mapping.__file__, "exec"), mapping.__dict__)


def system_classes(package: str, device):
    if package == "jax":
        os.environ["JAX_PLATFORMS"] = "cpu"
        import jax
        jax.config.update("jax_platforms", "cpu")
        from plslam_tpu.models.system import SLAMConfig, System
        return System, SLAMConfig, {}
    from plslam_tpu_torch.models.system import SLAMConfig, System
    # device None: the System's own default, the card (it raises without)
    return System, SLAMConfig, {} if device is None else {"device": device}


def record_drift_gate(readings: list):
    """Appends (k, c, angle) to `readings` at every call of the port's
    drift gate (`LoopClosing.drift_angle`)."""
    from plslam_tpu_torch.models.loop_closing import LoopClosing
    angle_of = LoopClosing.drift_angle

    def drift_angle(ms, k, c, S12):
        a = angle_of(ms, k, c, S12)
        readings.append((int(k), int(c), round(a, 3)))
        return a
    LoopClosing.drift_angle = staticmethod(drift_angle)


def record_closures(package: str, closures: list):
    """Appends (k, c, scale, translation, the map's translation of k
    relative to c) to `closures` at every accepted loop closure of either
    package (`LoopClosing.correct`, called before the map is corrected)."""
    mod = importlib.import_module(
        ("plslam_tpu" if package == "jax" else "plslam_tpu_torch")
        + ".models.loop_closing")
    correct = mod.LoopClosing.correct

    def logged(self, ms, k, c, S, *args, **kwargs):
        kf_T = gates._np(ms.kf_T).astype(np.float64)
        rel = kf_T[int(k)] @ np.linalg.inv(kf_T[int(c)])
        closures.append((int(k), int(c), round(float(gates._np(S.s)), 4),
                         np.round(gates._np(S.t).astype(np.float64), 3)
                         .tolist(), np.round(rel[:3, 3], 3).tolist()))
        return correct(self, ms, k, c, S, *args, **kwargs)
    mod.LoopClosing.correct = logged


def photo(seeds, device) -> None:
    """The port's photo campaign cases for `seeds`, each printed, then the
    mean keyframe ATE and its max / min over them."""
    ates = []
    with tempfile.TemporaryDirectory() as work:
        for seed in seeds:
            r = gates.photo_case(seed, Path(work) / f"photo_s{seed}", device)
            ates.append(r["kf_ate"])
            print(gates.photo_line(f"port, {device or 'cuda'}", seed, r),
                  flush=True)
    print(f"photo campaign over seeds {list(seeds)}: mean keyframe ATE "
          f"{np.mean(ates):.5f} m, max / min {max(ates) / min(ates):.3f}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--package", default="jax", choices=("jax", "port"))
    ap.add_argument("--gate", nargs="+", default=list(gates.GATES),
                    choices=list(gates.GATES))
    ap.add_argument("--seed", type=int, nargs="+", default=[None],
                    help="SLAMConfig.seed values (default: the fixture's)")
    ap.add_argument("--repeat", type=int, default=1)
    ap.add_argument("--mend-ba-select", action="store_true",
                    help="the JAX package with ba_select's slot-0 fault "
                         "mended in this process")
    ap.add_argument("--device", default=None,
                    help="the port's device (default: cuda)")
    ap.add_argument("--deterministic", action="store_true",
                    help="the port under torch's deterministic algorithms")
    ap.add_argument("--photo", type=int, nargs="+",
                    help="the port's photo campaign cases at these scene "
                         "seeds, in place of the gates")
    args = ap.parse_args(argv)
    if args.mend_ba_select and args.package != "jax":
        ap.error("--mend-ba-select applies to --package jax")
    if (args.device is not None or args.deterministic) \
            and args.package != "port":
        ap.error("--device and --deterministic apply to --package port")
    if args.photo:
        if args.package != "port":
            ap.error("--photo applies to --package port (the JAX side: "
                     "scripts/ab_ours.py --cpu)")
        photo(args.photo, args.device)
        return 0
    System, SLAMConfig, kwargs = system_classes(args.package, args.device)
    label = args.package + (", ba_select mended" if args.mend_ba_select
                            else "")
    readings, closures = [], []
    record_closures(args.package, closures)
    if args.mend_ba_select:
        mend_jax_ba_select()
    if args.package == "port":
        label += f", {args.device or 'cuda'}" + (", deterministic"
                                       if args.deterministic else "")
        record_drift_gate(readings)
        if args.deterministic:
            import torch
            torch.use_deterministic_algorithms(True, warn_only=True)
    for gate in args.gate:
        Ts, frames = gates.render(gate)
        for seed in args.seed:
            for i in range(args.repeat):
                readings.clear()
                closures.clear()
                m = gates.run(gate, System, SLAMConfig, frames, Ts,
                              None if seed is None else {"seed": seed},
                              **kwargs)
                bad = gates.failures(gate, m)
                tag = "" if seed is None else f", seed {seed}"
                tag += f", run {i}" if args.repeat > 1 else ""
                print(gates.line(label + tag, m), flush=True)
                print(f"  closures (k, c, scale, t, the map's t): {closures}")
                if args.package == "port" and readings:
                    print(f"  drift gate (k, c, rad): {readings}")
                print(f"  {gates.GATES[gate]['test']}: "
                      f"{'passes' if not bad else 'misses ' + '; '.join(bad)}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The JAX package's slow end-to-end gates, run by the port on the card.

Each gate is the twin of a slow JAX test: the same fixture (scene seed,
trajectory, frame count, `SLAMConfig` fields) and the same bars, each cited
by file and line in `tests/torch_gate_fixtures.py`. The JAX package
passes G1 at its fixture's `SLAMConfig.seed` only, so G1 runs over seeds
0-4 and the port's count of passes must reach the JAX package's on the
same frames. Two gates turn on faults of the JAX package, which both
packages were run on with the same frames: G2's drift is its `ba_select`
fault, and it does not initialize on G4's frames. There the port is held
to its recorded behaviour (`torch_gate_fixtures.RECORDED`, ROADMAP Queue
3). Then the round-5 photo
campaign (BASELINE.md:172-218): the 300-frame head-to-head sequence of
scripts/ref_compare.py for each of the five seeds, written as a TUM sequence
and run through `examples.mono_tum`, as `chip_smoke.run_photo_phase` does
for seed 5. Every case prints one line of numbers beside the JAX package's
and the C++ reference's where the records hold them.

They need the card and take minutes, so they are `slow` and `cuda` and stay
out of the default tier. This file imports neither jax nor plslam_tpu:

    python -m pytest tests/test_torch_gates.py -m "slow and cuda" \\
        --noconftest -s
"""
import numpy as np
import pytest
import torch

import chip_smoke
import torch_gate_fixtures as gates

PHOTO_SEEDS = (5, 11, 23, 37, 41)
# the C++ reference's keyframe ATE per seed (BASELINE.md:179-180) and its
# mean; the JAX package's five-seed mean at the round-5 defaults, 1.5-2.3x
# the reference per seed (BASELINE.md:206, :215-216)
PHOTO_REF_KF_ATE = {5: 0.00679, 11: 0.00485, 23: 0.00364, 37: 0.00389,
                    41: 0.00301}
PHOTO_REF_MEAN = 0.00428
PHOTO_JAX_MEAN = 0.00692
# the JAX package on the CPU on the same files, one seed per run
# (`SCENE_SEED=s scripts/ab_ours.py --cpu`): mean 0.00692 and max / min
# 1.50, BASELINE.md:215-216's "0.00692" and "max/min spread 1.5x"
PHOTO_JAX_CPU_KF_ATE = {5: 0.00684, 11: 0.00746, 23: 0.00842, 37: 0.00626,
                        41: 0.00563}
# the round-5 contract (BASELINE.md:217-218): mean keyframe ATE <= 3 x the
# reference's mean, and max / min of the per-seed keyframe ATE <= 2.5
CONTRACT_MEAN_X, CONTRACT_SPREAD = 3.0, 2.5

_campaign: dict = {}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels have no CPU "
                    "mode")


@pytest.mark.slow
@pytest.mark.cuda
@pytest.mark.parametrize("gate", list(gates.GATES))
def test_gate(gate):
    _card()
    from plslam_tpu_torch.models.system import SLAMConfig, System
    Ts, frames = gates.render(gate)
    if gate == "G1":
        _g1_over_seeds(System, SLAMConfig, frames, Ts)
        return
    m = gates.run(gate, System, SLAMConfig, frames, Ts)
    print(f"\n{gates.line('port', m)}\n  {gates.JAX_NOTES[gate]}; "
          f"card {chip_smoke.card_line()}")
    if gate in gates.RECORDED:
        # a gate that turns on a fault of the JAX package: the port is held
        # to its recorded behaviour (tests/torch_gate_fixtures.RECORDED)
        print(f"  held to the port's recorded behaviour: "
              f"{gates.RECORDED[gate]}; the JAX test's bars miss "
              f"{gates.failures(gate, m)}")
        bad = gates.recorded_failures(gate, m)
    else:
        bad = gates.failures(gate, m)
    assert not bad, f"{gate} ({gates.GATES[gate]['test']}): {bad}"


def _g1_over_seeds(System, SLAMConfig, frames, Ts):
    """G1 at each of `G1_SEEDS`: the port passes the JAX test's bars
    (tests/test_loop_closure_default_cfg.py:49-68) at least as often as the
    JAX package does at the same seeds (`torch_gate_fixtures.JAX_G1`)."""
    runs = {}
    for seed in gates.G1_SEEDS:
        runs[seed] = m = gates.run("G1", System, SLAMConfig, frames, Ts,
                                   {"seed": seed})
        bad = gates.failures("G1", m)
        print(f"\n{gates.line(f'port, seed {seed}', m)}\n  "
              f"{'passes' if not bad else 'misses ' + '; '.join(bad)}",
              flush=True)
    n_port = gates.passes("G1", runs.values())
    n_jax = gates.passes("G1", gates.JAX_G1.values())
    print(f"G1 over SLAMConfig.seed {list(gates.G1_SEEDS)}: the port passes "
          f"{n_port}, {gates.JAX_NOTES['G1']}; card {chip_smoke.card_line()}")
    assert n_port >= n_jax, (
        f"G1 ({gates.GATES['G1']['test']}): the port passes at "
        f"{n_port} of {len(runs)} seeds, the JAX package at {n_jax}")


@pytest.mark.slow
@pytest.mark.cuda
@pytest.mark.parametrize("seed", PHOTO_SEEDS)
def test_photo_campaign(seed, tmp_path):
    """One seed through `examples.mono_tum`: >= 290 trajectory rows, no
    LOST frame after initialization, keyframe ATE after Sim3 alignment below
    5% of the span (chip_smoke.py's photo bars)."""
    _card()
    r = gates.photo_case(seed, tmp_path / f"photo_s{seed}")
    ref = PHOTO_REF_KF_ATE[seed]
    _campaign[seed] = r["kf_ate"]
    print(f"\n{gates.photo_line('port', seed, r)}; {r['kf_ate'] / ref:.2f}x "
          f"the C++ reference's {ref}, the JAX package on the CPU "
          f"{PHOTO_JAX_CPU_KF_ATE[seed]}; card {chip_smoke.card_line()}")
    assert r["rows"] >= chip_smoke.PHOTO_MIN_ROWS, r["rows"]
    assert r["stats"]["lost_after_init"] == 0, r["stats"]["lost_after_init"]
    assert r["kf_ate"] < chip_smoke.ATE_FRACTION * r["span"], (
        r["kf_ate"], r["span"])


@pytest.mark.slow
@pytest.mark.cuda
def test_photo_campaign_contract():
    """The round-5 contract over the five seeds of `test_photo_campaign`
    (run in this session, before this test)."""
    _card()
    missing = [s for s in PHOTO_SEEDS if s not in _campaign]
    assert not missing, f"no keyframe ATE for seeds {missing}"
    ates = np.array([_campaign[s] for s in PHOTO_SEEDS])
    ratios = ates / np.array([PHOTO_REF_KF_ATE[s] for s in PHOTO_SEEDS])
    mean, spread = float(ates.mean()), float(ates.max() / ates.min())
    print(f"\nphoto campaign (port): keyframe ATE per seed "
          f"{dict(zip(PHOTO_SEEDS, np.round(ates, 5).tolist()))}, mean "
          f"{mean:.5f} m ({mean / PHOTO_REF_MEAN:.2f}x the reference's "
          f"{PHOTO_REF_MEAN}; the JAX package's {PHOTO_JAX_MEAN}), max / "
          f"min {spread:.2f}; ratios to the reference "
          f"{np.round(ratios, 2).tolist()}")
    assert mean <= CONTRACT_MEAN_X * PHOTO_REF_MEAN, mean
    assert spread <= CONTRACT_SPREAD, spread

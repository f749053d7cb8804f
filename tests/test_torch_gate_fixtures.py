"""The gate fixtures of tests/test_torch_gates.py (`torch_gate_fixtures`)
against the JAX tests they copy: each gate's `SLAMConfig` fields are a valid
configuration of both packages, equal field for field; its poses are the
JAX package's own within 1e-6 and its first frame is equal; and its bars
read the recorded numbers of both packages as the JAX tests, `JAX_G1` and
`RECORDED` say."""
import dataclasses

import numpy as np
import pytest

from plslam_tpu.datasets import synthetic as jsyn, textured as jtex
from plslam_tpu.models import system as jsys
from plslam_tpu_torch.models import system as tsys
import torch_gate_fixtures as gates
from torch_threads import one_thread  # noqa: F401


@pytest.mark.parametrize("gate", list(gates.GATES))
def test_gate_fixture_is_the_jax_tests(gate):
    g = gates.GATES[gate]
    cfg_j = dataclasses.asdict(jsys.SLAMConfig(**g["cfg"]))
    cfg_t = dataclasses.asdict(tsys.SLAMConfig(**g["cfg"]))
    assert cfg_j == cfg_t
    n_all, kind, amp = g["traj"]
    Ts = gates.poses(gate)
    # the port's se3 exponential rounds differently from jnp's in the last
    # bits (circle poses are built without it and are equal)
    np.testing.assert_allclose(
        Ts, jsyn.trajectory(n_all, kind, amplitude=amp)[:g["n"]], rtol=0,
        atol=1e-6)
    kind_s, kwargs = g["scene"]
    scene = jtex.make_photo_scene(**kwargs) if kind_s == "photo" else \
        jsyn.make_scene(**kwargs)
    np.testing.assert_array_equal(gates._render((kind_s, kwargs, Ts[:1]))[0],
                                  np.asarray(jsyn.render(scene, Ts[0])))


# numbers the packages printed on the gates' frames (PERF.md)
JAX_G1 = dict(n_loops=2, closure=(44, 0), n_gba=1, state="OK", n_kf=45,
              ate_final=0.018588, ate_pre=0.015357)
JAX_G2 = dict(n_kf=19, ate_before=0.038638, ate_after=0.0099924)
PORT_G2 = dict(n_kf=19, ate_before=0.008956, ate_after=0.007178)
NO_INIT_G4 = dict(lines=0, n_kf=0, tracked=0, unbroken=False,
                  first_tracked=-1, last_tracked=-1, tracked_after_init=0,
                  ate=None)


def test_bars_read_the_recorded_numbers():
    assert gates.failures("G1", JAX_G1) == []
    assert gates.failures("G1", dict(JAX_G1, ate_final=0.07)) != []
    assert gates.failures("G2", JAX_G2) == []
    # the port's G2 misses the JAX test's bars and meets its recorded ones
    assert len(gates.failures("G2", PORT_G2)) == 2
    assert gates.recorded_failures("G2", PORT_G2) == []
    assert gates.recorded_failures("G2", JAX_G2) != []
    assert len(gates.failures("G4", NO_INIT_G4)) == 3
    assert gates.recorded_failures("G4", NO_INIT_G4) == []
    assert gates.recorded_failures("G4", dict(NO_INIT_G4, n_kf=2,
                                              tracked=40)) != []
    # the port's G1 card run that accepted the (16, 10) candidate misses
    # the bars, and its count of passes is held to the JAX package's: the
    # JAX package passes at seed 0 of G1_SEEDS only
    port_g1 = dict(n_loops=1, closure=(16, 10), n_gba=1, state="OK",
                   n_kf=43, ate_final=1.8177, ate_pre=0.01466, lost=21)
    assert len(gates.failures("G1", port_g1)) == 3
    assert set(gates.JAX_G1) == set(gates.G1_SEEDS)
    assert gates.JAX_G1[0] == {**JAX_G1, "lost": 0}
    assert [s for s, m in gates.JAX_G1.items()
            if not gates.failures("G1", m)] == [0]
    assert gates.passes("G1", [port_g1] * 5) == 0
    assert gates.passes("G1", [port_g1, JAX_G1]) == 1
    assert set(gates.RECORDED) == {"G2", "G4"}

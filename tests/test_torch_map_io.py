"""Map checkpoints across the two packages, on the CPU.

A map of a rendered frame (a keyframe and points from its depth, plus
map lines written in) goes JAX `save_map` -> port `load_map` -> port
`save_map` -> JAX `load_map`, every field bit-equal, and so does an old
checkpoint without `kf_ur` / `ln_cond` (both loaders fill the same
defaults). The port's PLY text equals the JAX writer's. `System.load_map`
binds the map and, unlike the JAX package's, refreshes its host copies of
the map counts (ROADMAP Queue 3), which a test pins: the JAX
`System.load_map` is called on a stand-in holding only `n_kf_host`, as
the method sets the map alone."""
import types

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from plslam_tpu.mapstate import checkpoint as jckpt, state as jstate
from plslam_tpu.models import system as jsys
from plslam_tpu_torch.mapstate import checkpoint as tckpt, state as tstate
from plslam_tpu_torch.models import system as tsys

from test_torch_multistream import CFG, _render, depth_map
from torch_threads import one_thread  # noqa: F401


@pytest.fixture(scope="module")
def base_map():
    _, data = _render(n_frames=1, streams=1)
    frames, depth = data[0]
    ms = depth_map(CFG, frames[0], depth)
    rng = np.random.default_rng(3)
    L = ms.ln_valid.shape[0]
    ms.ln_xyz.copy_(torch.from_numpy(rng.normal(0, 1, (L, 2, 3))
                                     .astype(np.float32)))
    ms.ln_valid[: L // 2] = True
    ms.ln_cond.copy_(torch.from_numpy(rng.uniform(0.2, 1, L)
                                      .astype(np.float32)))
    ms.n_ln.fill_(L // 2)
    return ms


def _equal(a: dict, b: dict):
    assert set(a) == set(b)
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _jax_numpy(ms):
    return {f: np.asarray(getattr(ms, f)) for f in ms._fields}


def test_checkpoints_cross_both_ways(tmp_path, base_map):
    ms = base_map
    want = tckpt.to_numpy(ms)
    jms = jstate.MapState(**{k: jnp.asarray(v) for k, v in want.items()})
    jckpt.save_map(jms, tmp_path / "jax.npz")
    port = tckpt.load_map(tmp_path / "jax.npz", "cpu")
    _equal(tckpt.to_numpy(port), want)
    tckpt.save_map(port, tmp_path / "port.npz")
    with np.load(tmp_path / "port.npz") as data:
        assert sorted(data.files) == sorted(jstate.MapState._fields)
    _equal(_jax_numpy(jckpt.load_map(str(tmp_path / "port.npz"))), want)


def test_old_checkpoint_without_new_fields(tmp_path, base_map):
    arrays = tckpt.to_numpy(base_map)
    old = {k: v for k, v in arrays.items() if k not in ("kf_ur", "ln_cond")}
    np.savez_compressed(tmp_path / "old.npz", **old)
    port = tckpt.to_numpy(tckpt.load_map(tmp_path / "old.npz", "cpu"))
    _equal(port, _jax_numpy(jckpt.load_map(str(tmp_path / "old.npz"))))
    np.testing.assert_array_equal(port["kf_ur"], -1.0)
    np.testing.assert_array_equal(port["ln_cond"], 1.0)


def test_point_cloud_is_the_jax_text(tmp_path, base_map):
    ms = base_map
    jms = jstate.MapState(**{k: jnp.asarray(v)
                             for k, v in tckpt.to_numpy(ms).items()})
    jckpt.save_point_cloud(jms, str(tmp_path / "jax.ply"))
    tckpt.save_point_cloud(ms, tmp_path / "port.ply")
    text = (tmp_path / "port.ply").read_text()
    assert text == (tmp_path / "jax.ply").read_text()
    assert f"element vertex {int(ms.pt_valid.sum())}\n" in text


def test_system_map_io_and_host_counts(tmp_path, base_map):
    """Both Systems' `save_map` / `load_map` / `save_point_cloud`; the
    port's `load_map` sets `n_kf_host`, the capacities and the occupancy
    from the map, the JAX package's leaves `n_kf_host` as it was."""
    ms = base_map
    tckpt.save_map(ms, tmp_path / "m.npz")
    cfg = dict(CFG, max_kf=4, max_pt=512)    # capacities the map does not have
    port = tsys.System(tsys.SLAMConfig(**cfg), device="cpu")
    port.load_map(str(tmp_path / "m.npz"))
    _equal(tckpt.to_numpy(port.ms), tckpt.to_numpy(ms))
    assert port.n_kf_host == int(ms.n_kf) == 1
    assert (port.map_cfg.max_kf, port.map_cfg.max_pt, port.map_cfg.max_ln) \
        == (CFG["max_kf"], CFG["max_pt"], CFG["max_ln"])
    assert port._occupancy == (int(ms.n_pt), int(ms.n_ln))
    port.save_map(str(tmp_path / "again.npz"))
    port.save_point_cloud(str(tmp_path / "port.ply"))

    jax_sys = types.SimpleNamespace(n_kf_host=0)   # a fresh System's count
    jsys.System.load_map(jax_sys, str(tmp_path / "m.npz"))
    assert jax_sys.n_kf_host == 0           # the JAX package's load_map
    _equal(_jax_numpy(jax_sys.ms), tckpt.to_numpy(ms))
    jsys.System.save_point_cloud(jax_sys, str(tmp_path / "jax.ply"))
    assert (tmp_path / "port.ply").read_text() == \
        (tmp_path / "jax.ply").read_text()
    with np.load(tmp_path / "again.npz") as data:
        _equal({k: data[k] for k in data.files}, tckpt.to_numpy(ms))

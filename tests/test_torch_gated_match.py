"""The PyTorch port's Hamming search (kernel K1's plain version and the
dedup) against plslam_tpu: exact equality throughout, since every quantity is
an integer or a float32 compare done in the same order.

The CUDA kernel itself runs only on a card: see tests/test_torch_cuda.py."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from chip_smoke import random_search_inputs
from plslam_tpu.ops import hamming as jham
from plslam_tpu_torch.ops import gated_match, hamming as tham
from torch_threads import one_thread  # noqa: F401

N, P = 200, 700   # the shape of tests/test_pallas_match.py, not tile-aligned


def _inputs(seed=0, n=N, p=P):
    return random_search_inputs(np.random.default_rng(seed), n, p)


def _torch(a, device="cpu"):
    return {k: torch.from_numpy(v).to(device) for k, v in a.items()}


def _jax_masked(a, gated=True):
    D = jham.distance_matrix(jnp.asarray(a["q_bits"]), jnp.asarray(a["d_bits"]))
    mask = a["d_visible"][None, :] & a["q_valid"][:, None]
    if gated:
        q_uv, d_uv, r = a["q_uv"], a["d_uv"], a["d_radius"]
        mask = mask & ((np.abs(q_uv[:, 0:1] - d_uv[None, :, 0]) < r[None, :])
                       & (np.abs(q_uv[:, 1:2] - d_uv[None, :, 1]) < r[None, :])
                       & (np.abs(a["q_oct"][:, None] - a["d_level"][None, :])
                          <= 1))
    return [np.asarray(x) for x in jham.masked_best2(D, jnp.asarray(mask))]


def _np(out):
    return [x.cpu().numpy() for x in out]


def test_distance_matrix():
    a = _inputs()
    dt = tham.distance_matrix(torch.from_numpy(a["q_bits"]),
                              torch.from_numpy(a["d_bits"]))
    dj = jham.distance_matrix(jnp.asarray(a["q_bits"]), jnp.asarray(a["d_bits"]))
    assert dt.dtype == torch.int32
    np.testing.assert_array_equal(dt.numpy(), np.asarray(dj))


def test_plain_matches_pallas_interpret_and_masked_best2():
    from jax.experimental.pallas import tpu as pltpu
    from plslam_tpu.ops import pallas_match

    a = _inputs()
    before = gated_match.gated_hamming_best2.launches
    idx, best, second = _np(gated_match.gated_hamming_best2(**_torch(a)))
    assert gated_match.gated_hamming_best2.launches == before  # CPU: no kernel
    ref_idx, ref_best, ref_second = _jax_masked(a)
    np.testing.assert_array_equal(best, ref_best)
    np.testing.assert_array_equal(second, ref_second)
    np.testing.assert_array_equal(idx, ref_idx)
    with pltpu.force_tpu_interpret_mode():
        pal = [np.asarray(x) for x in pallas_match.gated_hamming_best2(
            *[jnp.asarray(v) for v in a.values()])]
    for x, y in zip((idx, best, second), pal):
        np.testing.assert_array_equal(x, y)


def test_gates_off_is_masked_best2_under_separable_mask():
    a = _inputs(seed=1)
    out = _np(gated_match.gated_hamming_best2(**_torch(a), gated=False))
    for x, y in zip(out, _jax_masked(a, gated=False)):
        np.testing.assert_array_equal(x, y)


def test_all_masked_rows_give_invalid_and_index_zero():
    a = _inputs(seed=2)
    a["q_valid"][:50] = False
    a["q_uv"][50:60] = -1e4          # outside every window
    for gated in (True, False):
        idx, best, second = _np(gated_match.gated_hamming_best2(
            **_torch(a), gated=gated))
        dead = np.arange(N) < (60 if gated else 50)
        assert (best[dead] == tham.INVALID).all()
        assert (second[dead] == tham.INVALID).all()
        assert (idx[dead] == 0).all()
    a["d_visible"][:] = False
    idx, best, second = _np(gated_match.gated_hamming_best2(**_torch(a)))
    assert (best == tham.INVALID).all() and (idx == 0).all()


def test_ties_go_to_lowest_index():
    a = _inputs(seed=3)
    a["d_bits"][100:] = a["d_bits"][:P - 100]     # duplicate descriptors
    a["d_uv"][100:] = a["d_uv"][:P - 100]
    a["d_radius"][100:] = a["d_radius"][:P - 100]
    a["d_level"][100:] = a["d_level"][:P - 100]
    for gated in (True, False):
        out = _np(gated_match.gated_hamming_best2(**_torch(a), gated=gated))
        for x, y in zip(out, _jax_masked(a, gated=gated)):
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("n", [300, 2500])   # 2500 > 2047: the int32 wrap case
def test_dedup_by_target(n):
    rng = np.random.default_rng(n)
    n_targets = 97
    idx = rng.integers(0, n_targets, n).astype(np.int32)
    matched = rng.random(n) > 0.3
    best = np.where(matched, rng.integers(0, 120, n),
                    jham.INVALID).astype(np.int32)
    got = tham.dedup_by_target(torch.from_numpy(idx).long(),
                               torch.from_numpy(matched),
                               torch.from_numpy(best), n_targets).numpy()
    want = np.asarray(jham.dedup_by_target(jnp.asarray(idx), jnp.asarray(matched),
                                           jnp.asarray(best), n_targets))
    np.testing.assert_array_equal(got, want)
    assert len(set(idx[got])) == got.sum()       # injective


def test_wrapper_rejects_what_the_kernel_does_not_take():
    a = _torch(_inputs())
    with pytest.raises(TypeError):
        gated_match.gated_hamming_best2(**{**a, "q_oct": a["q_oct"].long()})
    with pytest.raises(ValueError):
        gated_match.gated_hamming_best2(**{**a, "d_radius": a["d_radius"][:-1]})
    with pytest.raises(ValueError):
        gated_match.gated_hamming_best2(**{**a, "q_uv": a["q_uv"].T.contiguous().T})
    with pytest.raises(ValueError):
        gated_match.gated_hamming_best2(**{**a, "d_uv": a["d_uv"].to("meta")})


@pytest.mark.parametrize("rows", ["random", "zeros", "ones"])
def test_row_sums_and_products_give_hamming(rows):
    """The kernel's arithmetic on {0,1} rows, in int32, against JAX's
    distance_matrix: hamming(a, b) = sum(a) + sum(b) - 2 a.b, and the form
    the kernel computes, sum(a) - (2a - 1).b, one s8 x u8 product per pair
    with no row sum of b."""
    a = _inputs()
    q, d = a["q_bits"], a["d_bits"]
    if rows != "random":
        q = np.full_like(q, rows == "ones")
        d = np.full_like(d, rows == "ones")
    qt = torch.from_numpy(q).to(torch.int32)
    dt = torch.from_numpy(d).to(torch.int32)
    sum_q = qt.sum(1, dtype=torch.int32)[:, None]
    sum_d = dt.sum(1, dtype=torch.int32)[None, :]
    want = np.asarray(jham.distance_matrix(jnp.asarray(q), jnp.asarray(d)))
    for got in (sum_q + sum_d - 2 * (qt @ dt.T), sum_q - (2 * qt - 1) @ dt.T):
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)

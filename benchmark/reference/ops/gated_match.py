"""The gated Hamming top-2 search in plain PyTorch: the reference for the
port's kernel K1 (`csrc/gated_hamming.cu`).

A copy of the plain version in the port's `ops/gated_match.py`
(`gate_mask`, `gated_hamming_best2_reference`) as it stood when the
benchmark was written: the (N, P) distance matrix and gate mask formed in
full, ties to the lowest index.
"""
from __future__ import annotations

from . import hamming


def gate_mask(q_uv, q_oct, q_valid, d_uv, d_radius, d_level, d_visible,
              gated=True):
    """(..., N, P) bool: the pairs the search may match, over any leading
    batch axes: valid query x visible map point and, with `gated`, |du| and
    |dv| under the map point's radius and octaves within 1."""
    mask = d_visible[..., None, :] & q_valid[..., :, None]
    if gated:
        du = (q_uv[..., :, 0:1] - d_uv[..., None, :, 0]).abs()
        dv = (q_uv[..., :, 1:2] - d_uv[..., None, :, 1]).abs()
        r = d_radius[..., None, :]
        mask = mask & (du < r) & (dv < r) \
            & ((q_oct[..., :, None] - d_level[..., None, :]).abs() <= 1)
    return mask


def gated_hamming_best2(q_bits, q_uv, q_oct, q_valid, d_bits, d_uv,
                        d_radius, d_level, d_visible, gated=True):
    """(best_idx, best, second) per query: int64 index, int32 distances,
    `hamming.INVALID` where nothing passes (index 0)."""
    return hamming.masked_best2(
        hamming.distance_matrix(q_bits, d_bits),
        gate_mask(q_uv, q_oct, q_valid, d_uv, d_radius, d_level, d_visible,
                  gated))

"""Hamming distance search: the plain PyTorch forms.

Frozen copy of the port's `ops/hamming.py`. With descriptors as +-1 vectors,
``hamming(a, b) = (256 - a . b) / 2``. The dot product runs in float32: every
partial sum is an integer of magnitude <= 256, so it is exact, with or without
TF32 (which rounds only the +-1 inputs). On CUDA tensors the searches of the
tracking step go through the fused kernel of `ops/gated_match.py` instead;
these functions are its yardstick.
"""
from __future__ import annotations

import torch

INVALID = 1 << 20  # sentinel distance for masked pairs


def bits_to_pm1(bits):
    """(..., 256) {0,1} -> (..., 256) int8 in {-1, +1}."""
    return (bits.to(torch.int8) * 2 - 1).to(torch.int8)


def distance_matrix(bits_q, bits_d):
    """All-pairs Hamming distances: (..., N, 256), (..., M, 256) {0,1} ->
    (..., N, M) int32 in [0, 256]."""
    a = bits_to_pm1(bits_q).to(torch.float32)
    b = bits_to_pm1(bits_d).to(torch.float32)
    return ((256.0 - a @ b.transpose(-1, -2)) * 0.5).to(torch.int32)


def masked_best2(dist, mask):
    """Best and second-best match per query row under a validity mask.

    dist: (..., N, M) int32; mask: (..., N, M) bool (True = pair allowed).
    Returns (best_idx (..., N), best (..., N), second (..., N)); disallowed
    pairs count as INVALID, and ties go to the lowest index."""
    d = torch.where(mask, dist, INVALID)
    best_idx = torch.argmin(d, dim=-1)      # first index among equal minima
    best = d.gather(-1, best_idx[..., None])[..., 0]
    second = d.scatter(-1, best_idx[..., None], INVALID).amin(dim=-1)
    return best_idx, best, second


def nanmedian(x):
    """`torch.nanquantile(x, 0.5)` of a 1-d float32 x, step for step (sort
    with NaN last, rank 0.5 x (count - 1) in float32, lerp between the two
    neighbours), in ops that `torch.func.vmap` batches."""
    s = torch.sort(x).values
    rank = (torch.full((), 0.5, device=x.device)
            * ((~torch.isnan(x)).sum() - 1)).clamp_min(0)
    below = rank.to(torch.long)
    pick = lambda i: s.gather(0, i.reshape(1))[0]
    return torch.lerp(pick(below), pick(rank.ceil().to(torch.long)),
                      rank - below)


def vector_mad(x, valid, scale: float = 1.4826):
    """Scaled median absolute deviation of x over the `valid` entries (the
    reference's `vector_mad`), 0 when fewer than 2 are valid. Medians of an
    even count average the two middle values, as `jnp.nanmedian` does
    (`torch.nanmedian` would take the lower one)."""
    xf = torch.where(valid, x.to(torch.float32), torch.nan)
    med = nanmedian(xf)
    mad = nanmedian((xf - med).abs())
    return torch.where(valid.sum() >= 2, scale * torch.nan_to_num(mad), 0.0)


def dedup_by_target(idx, matched, best, n_targets: int):
    """Make a per-query match set injective over targets: when several
    queries matched the same target, keep the one with the smallest distance
    (ties -> lowest query index) and drop the rest.

    idx: (N,) target per query; matched: (N,) bool; best: (N,) distances.
    Returns the deduplicated `matched` mask. Unmatched lanes are masked
    before the multiply (their INVALID distance times N would wrap int32 for
    N > 2047) and scatter into a dump slot past the targets."""
    n = idx.shape[0]
    lane = torch.arange(n, dtype=torch.int32, device=idx.device)
    key = torch.where(matched, best, 0).to(torch.int32) * n + lane
    big = 1 << 30
    tgt_best = torch.full((n_targets + 1,), big, dtype=torch.int32,
                          device=idx.device)
    tgt_best = tgt_best.scatter_reduce(
        0, torch.where(matched, idx, n_targets).long(),
        torch.where(matched, key, big), reduce="amin")
    return matched & (key == tgt_best[idx.clamp(0, n_targets - 1).long()])



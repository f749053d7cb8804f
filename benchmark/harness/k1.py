"""The least time the card could take for a K1 launch (the gated Hamming
top-2 search, `csrc/gated_hamming.cu`): its roofline bound.

The arithmetic of `chip_smoke.py`'s K1 check, copied so that later changes
to the program cannot move it. The bound is the larger of the bytes the
launch's inputs need (each byte read once, each output written once; a map
point that is not visible needs only its flag read) over the HBM rate, and
2 x 256 integer operations per pair that passes the gates over the int8
tensor-core rate: a pair that fails the gates needs no product. Peaks: one H100 SXM, NVIDIA's data sheet, dense, at 700 W.
"""
from __future__ import annotations

from ..reference.ops import gated_match

H100_INT8_OPS = 1979e12   # dense int8 tensor-core operations per second
H100_BYTES = 3.35e12      # HBM3 bytes per second
OUT_BYTES = 8 + 4 + 4     # per query: int64 index, int32 best and second


def launch_work(args, gated: bool) -> tuple:
    """(bytes, passing pairs) of one search with the 9 inputs `args`: every
    query's row (bits, position, octave, flag) and output, every map
    point's visibility flag, and the rest of a map point's row (bits, and
    with the gates on its projected position, radius and level) only where
    it is visible: an invisible point needs nothing more read, and with the
    gates off the positions, radii and levels are not needed at all."""
    q_bits, q_uv, q_oct, q_valid, d_bits, d_uv, d_radius, d_level, vis = args
    n = q_bits.shape[0]
    per_point = d_bits.shape[-1] * d_bits.element_size()
    if gated:
        per_point += sum(t[0].numel() * t.element_size()
                         for t in (d_uv, d_radius, d_level))
    n_vis = int(vis.sum())
    nbytes = sum(t.numel() * t.element_size()
                 for t in (q_bits, q_uv, q_oct, q_valid, vis)) \
        + n * OUT_BYTES + n_vis * per_point
    pairs = int(gated_match.gate_mask(q_uv, q_oct, q_valid, d_uv, d_radius,
                                      d_level, vis, gated=gated).sum())
    return nbytes, pairs


def bound_s(n_bytes: float, pairs: float) -> float:
    """Seconds: the larger of the bytes over the memory rate and the
    passing pairs' operations over the int8 rate."""
    return max(n_bytes / H100_BYTES, 2 * 256 * pairs / H100_INT8_OPS)

"""Spatially-uniform top-N keypoint selection on a fixed grid.

Frozen copy of the port's `ops/select.py`: per-cell top-k ranking, then a global
selection by priority. JAX's `argmax` and `lax.top_k` put the lowest index
first among equal values; `torch.topk` does not promise that, so both rankings
here are stable sorts. It matters: ``rank * 1e9 - response`` in float32 has an
ulp of 64-512 for rank >= 1, so many candidates tie and the index order
decides which are chosen.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def select_grid_topk(score, n_out: int, cell: int = 32, k_per_cell: int = 8,
                     order: str = "uniform"):
    """Select up to `n_out` peaks from a dense (H, W) score map (0 = no
    corner). `order` = "uniform" (every cell's best before any cell's
    second) or "response" (strongest first, per-cell cap only).

    Returns uv (n_out, 2) float32 (x, y), resp (n_out,), valid (n_out,)."""
    if order not in ("uniform", "response"):
        raise ValueError(f"order must be 'uniform' or 'response', got {order!r}")
    h, w = score.shape
    gy, gx = -(-h // cell), -(-w // cell)
    s = F.pad(score, (0, gx * cell - w, 0, gy * cell - h))
    cells = s.reshape(gy, cell, gx, cell).permute(0, 2, 1, 3).reshape(
        gy * gx, cell * cell)

    k = min(k_per_cell, cell * cell)
    vals, idx = torch.sort(cells, dim=1, descending=True, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]

    cid = torch.arange(gy * gx, device=score.device)[:, None]
    ys = (cid // gx) * cell + idx // cell
    xs = (cid % gx) * cell + idx % cell
    rank = torch.arange(k, device=score.device, dtype=torch.float32)[None, :]

    big = 1e9     # float32(1e9) - 1 rounds back to 1e9, as in the JAX version
    capped = vals.clamp_max(big - 1.0)
    prio = -capped if order == "response" else rank * big - capped
    prio = torch.where(vals > 0.0, prio, torch.inf).reshape(-1)

    n_take = min(n_out, prio.shape[0])
    take = torch.sort(prio, stable=True).indices[:n_take]
    uv = torch.stack([xs.reshape(-1)[take], ys.reshape(-1)[take]],
                     dim=-1).to(torch.float32)
    resp = vals.reshape(-1)[take]
    valid = torch.isfinite(prio[take])
    if n_take < n_out:
        pad = n_out - n_take
        uv = torch.cat([uv, uv.new_zeros(pad, 2)])
        resp = torch.cat([resp, resp.new_zeros(pad)])
        valid = torch.cat([valid, valid.new_zeros(pad)])
    return uv, torch.where(valid, resp, 0.0), valid

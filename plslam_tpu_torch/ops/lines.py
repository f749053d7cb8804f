"""Data-parallel line-segment detection and binary line descriptors.

Port of `plslam_tpu/ops/lines.py` (the LSD detector + LBD descriptor
contract with a parallel formulation):

1. Sobel gradients -> a structure tensor per 8x8 block;
2. coherent, strong blocks are line blocks with a principal direction;
3. each line block links to its collinear neighbour along +-direction, and
   chains form by pointer doubling (log2 steps of gathers);
4. per chain, a least-squares line fit from orientation-gated pixel moments
   (scattered by chain root), endpoints from the extremal projections of its
   blocks, then the top `n_out` chains by length;
5. the descriptor samples a 9-band x 24-sample window of the blurred image's
   gradients along the segment and binarizes band statistics with a fixed
   seeded comparison pattern into 256 bits.

The JAX version samples the gradients through 8x8 tile rows and a one-hot
float32 contraction; that returns the pixel at (int(py), int(px)), which is
gathered here directly. The sobel and blur sum in the JAX functions' order
and the per-chain scatters add in block order on the CPU; XLA's compiled
program fuses multiply-adds and approximates atan2 and cos its own way, and
the chain fit's covariance (two large moments subtracted) turns those ulps
into ~1e-2 px at the endpoints (tests/test_torch_lines.py).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch import nn

from ..geometry.triangulation import line_from_endpoints_2d
from . import pyramid


class LineFeatures(NamedTuple):
    """Fixed-capacity per-frame line features (KeyLine equivalent)."""

    uv_a: torch.Tensor      # (M, 2) endpoint A (pixels)
    uv_b: torch.Tensor      # (M, 2) endpoint B
    l2d: torch.Tensor       # (M, 3) infinite line, (l0, l1) unit normal
    angle: torch.Tensor     # (M,) direction angle in [0, pi)
    length: torch.Tensor    # (M,)
    response: torch.Tensor  # (M,) length / max(W, H)
    desc: torch.Tensor      # (M, 256) uint8 bits
    valid: torch.Tensor     # (M,) bool


N_BANDS = 9
BAND_W = 7
N_SAMPLES = 24  # samples along the line


def make_lbd_pairs(seed: int = 31415926, dim: int = N_BANDS * 8,
                   bits: int = 256) -> np.ndarray:
    """(bits, 2) int32 comparison pairs over the `dim` band statistics, from
    the JAX package's seeded numpy generator."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, dim, bits)
    b = rng.integers(0, dim, bits)
    clash = a == b
    b[clash] = (b[clash] + 1 + rng.integers(0, dim - 1, clash.sum())) % dim
    return np.stack([a, b], -1).astype(np.int32)


def sobel(img):
    """(H, W) -> gx, gy with a replicate border, summed in the JAX
    package's order."""
    h, w = img.shape
    x = torch.nn.functional.pad(img[None, None], (1, 1, 1, 1),
                                mode="replicate")[0, 0]

    def sh(dy, dx):
        return x[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    gx = ((sh(-1, 1) - sh(-1, -1)) + 2.0 * (sh(0, 1) - sh(0, -1))
          + (sh(1, 1) - sh(1, -1))) / 8.0
    gy = ((sh(1, -1) - sh(-1, -1)) + 2.0 * (sh(1, 0) - sh(-1, 0))
          + (sh(1, 1) - sh(-1, 1))) / 8.0
    return gx, gy


def _angle_diff(a, b):
    """Absolute difference of undirected angles (mod pi)."""
    d = torch.remainder((a - b).abs(), torch.pi)
    return torch.minimum(d, torch.pi - d)


def _scatter(nb: int, root, vals, fill, reduce=None):
    """(nb,) per-chain reduction of `vals` by `root` into an (nb + 1,)
    buffer whose last slot takes the non-line blocks."""
    out = torch.full((nb + 1,), fill, dtype=vals.dtype, device=vals.device)
    if reduce is None:
        out = out.index_add(0, root, vals)
    else:
        out = out.scatter_reduce(0, root, vals, reduce=reduce)
    return out[:nb]


class LineDetector(nn.Module):
    """Line segments of (height, width) float32 images.

    ``forward(img, mask=None)`` returns `LineFeatures` with `n_out` slots;
    `mask` is an optional (H, W) {0, 1} suppression mask (blocks less than
    80% unmasked are excluded, the reference's LSD mask). The 5-tap
    sigma-1.4 blur taps, the LBD comparison pairs and the block-centre and
    pixel grids are buffers; it runs on their device."""

    def __init__(self, height: int, width: int, n_out: int = 256,
                 block: int = 8, coherence_th: float = 0.7,
                 mag_th: float = 3.0, angle_tol: float = 0.30,
                 min_length: float = 24.0, perp_tol: float = 2.5):
        super().__init__()
        self.shape = (height, width)
        self.n_out, self.block = n_out, block
        self.coherence_th, self.mag_th = coherence_th, mag_th
        self.angle_tol, self.min_length, self.perp_tol = (angle_tol,
                                                          min_length, perp_tol)
        gb = (height // block, width // block)
        self.gb, self.nb = gb, gb[0] * gb[1]
        diag = float(np.hypot(gb[0], gb[1]))
        self.steps = int(np.ceil(np.log2(max(diag, 2.0)))) + 1
        f32 = np.float32
        cy = np.arange(gb[0]) * block + block // 2
        cx = np.arange(gb[1]) * block + block // 2
        buf = lambda name, a: self.register_buffer(name, torch.from_numpy(a))
        buf("blur_taps", pyramid.gaussian_kernel1d(5, 1.4))
        buf("lbd_pairs", make_lbd_pairs().astype(np.int64))
        buf("cx", np.broadcast_to(cx[None, :], gb).reshape(-1).astype(f32))
        buf("cy", np.broadcast_to(cy[:, None], gb).reshape(-1).astype(f32))
        buf("gxi", np.arange(self.nb) % gb[1])
        buf("gyi", np.arange(self.nb) // gb[1])
        buf("xs", np.arange(gb[1] * block, dtype=f32))
        buf("ys", np.arange(gb[0] * block, dtype=f32))

    def _block_sum(self, a):
        (g0, g1), b = self.gb, self.block
        return a[:g0 * b, :g1 * b].reshape(g0, b, g1, b).sum(dim=(1, 3))

    def _links(self, ang_f, is_line_f):
        """(prv (nb,), chain root (nb,)) of every block; non-line blocks
        root at the dump slot nb."""
        g0, g1 = self.gb
        ids = torch.arange(self.nb, device=ang_f.device)
        # canonical direction: dx > 0, near-vertical lines dy > 0
        dx, dy = torch.cos(ang_f), torch.sin(ang_f)
        flip = (dx < 0) | ((dx.abs() < 1e-3) & (dy < 0))
        dx, dy = torch.where(flip, -dx, dx), torch.where(flip, -dy, dy)

        def link(sign):
            nx = self.gxi + torch.round(sign * dx).to(torch.int64)
            ny = self.gyi + torch.round(sign * dy).to(torch.int64)
            ok = (nx >= 0) & (nx < g1) & (ny >= 0) & (ny < g0)
            nid = ny.clamp(0, g0 - 1) * g1 + nx.clamp(0, g1 - 1)
            same_dir = _angle_diff(ang_f, ang_f[nid]) < self.angle_tol
            off = (self.cx[nid] - self.cx) * -dy + (self.cy[nid] - self.cy) * dx
            good = (ok & is_line_f & is_line_f[nid] & same_dir
                    & (off.abs() < self.perp_tol))
            return torch.where(good, nid, ids)

        nxt, prv = link(1.0), link(-1.0)
        # mutual consistency (the next of the previous is self): no Y-joins
        root = torch.where(nxt[prv] == ids, prv, ids)
        for _ in range(self.steps):
            root = root[root]
        return torch.where(is_line_f, root, self.nb)

    def forward(self, img, mask=None) -> LineFeatures:
        H, W = self.shape
        if tuple(img.shape) != self.shape:
            raise ValueError(f"image shape {tuple(img.shape)}, detector "
                             f"built for {self.shape}")
        b, nb, (g0, g1) = self.block, self.nb, self.gb
        pi = torch.pi
        gx, gy = sobel(img)
        mag = torch.sqrt(gx * gx + gy * gy)
        if mask is not None:
            mag = mag * mask

        # structure tensor per block (gradient-energy weighted)
        Jxx = self._block_sum(gx * gx)
        Jxy = self._block_sum(gx * gy)
        Jyy = self._block_sum(gy * gy)
        tr = Jxx + Jyy
        det = Jxx * Jyy - Jxy * Jxy
        disc = torch.sqrt((tr * tr - 4.0 * det).clamp_min(0.0))
        l1, l2 = 0.5 * (tr + disc), 0.5 * (tr - disc)
        coherence = (l1 - l2) / (l1 + l2).clamp_min(1e-6)
        mean_mag = self._block_sum(mag) / (b * b)
        # the structure tensor's principal axis follows the gradient; the
        # line runs perpendicular to it
        grad_angle = 0.5 * torch.atan2(2.0 * Jxy, Jxx - Jyy)
        line_angle = torch.remainder(grad_angle + pi / 2.0, pi)
        is_line = (coherence > self.coherence_th) & (mean_mag > self.mag_th)
        if mask is not None:
            is_line = is_line & (self._block_sum(mask) / (b * b) > 0.8)
        is_line_f = is_line.reshape(-1)
        root = self._links(line_angle.reshape(-1), is_line_f)

        # per-chain pixel moments, gated on pixel gradients aligned with the
        # block's principal gradient direction (cos^2 > 0.75)
        crop = lambda a: a[:g0 * b, :g1 * b]
        px_grad_angle = crop(torch.atan2(gy, gx))
        blk_grad_angle = grad_angle.repeat_interleave(b, 0).repeat_interleave(
            b, 1)
        align = torch.cos(torch.remainder(px_grad_angle, pi)
                          - torch.remainder(blk_grad_angle, pi)) ** 2
        w = crop(mag) * torch.where(align > 0.75, align, 0.0)
        xs, ys = self.xs[None, :], self.ys[:, None]
        bs = lambda a: self._block_sum(a).reshape(-1)
        line_w = lambda v: torch.where(is_line_f, v, 0.0)
        C00, C10, C01, C20, C11, C02 = (
            _scatter(nb, root, line_w(bs(m)), 0.0) for m in (
                w, w * xs, w * ys, w * xs * xs, w * xs * ys, w * ys * ys))
        n_blocks_in = _scatter(nb, root, is_line_f.to(torch.int32), 0)

        # least-squares line: principal axis of the pixel covariance
        c00 = C00.clamp_min(1e-6)
        mx, my = C10 / c00, C01 / c00
        vxx = C20 / c00 - mx * mx
        vxy = C11 / c00 - mx * my
        vyy = C02 / c00 - my * my
        fit_angle = torch.remainder(0.5 * torch.atan2(2.0 * vxy, vxx - vyy),
                                    pi)
        fdx, fdy = torch.cos(fit_angle), torch.sin(fit_angle)

        # endpoints: extremal projections of member block centres +- half
        rsafe = root.clamp(0, nb - 1)
        proj = ((self.cx - mx[rsafe]) * fdx[rsafe]
                + (self.cy - my[rsafe]) * fdy[rsafe])
        big = 1e9
        pmin = _scatter(nb, root, torch.where(is_line_f, proj, big), big,
                        "amin") - b * 0.5
        pmax = _scatter(nb, root, torch.where(is_line_f, proj, -big), -big,
                        "amax") + b * 0.5
        is_chain = n_blocks_in > 0
        length = torch.where(is_chain, pmax - pmin, 0.0)
        ok_chain = is_chain & (length >= self.min_length)

        # top-k by length, ties to the lower index (lax.top_k's order)
        k = min(self.n_out, nb)
        vals, sel = torch.sort(torch.where(ok_chain, length, -1.0),
                               descending=True, stable=True)
        vals, sel = vals[:k], sel[:k]
        uv_a = torch.stack([mx[sel] + pmin[sel] * fdx[sel],
                            my[sel] + pmin[sel] * fdy[sel]], -1)
        uv_b = torch.stack([mx[sel] + pmax[sel] * fdx[sel],
                            my[sel] + pmax[sel] * fdy[sel]], -1)
        if k < self.n_out:
            pad = self.n_out - k
            uv_a = torch.nn.functional.pad(uv_a, (0, 0, 0, pad))
            uv_b = torch.nn.functional.pad(uv_b, (0, 0, 0, pad))
            vals = torch.nn.functional.pad(vals, (0, pad))
        valid = vals > 0
        ang = torch.remainder(torch.atan2(uv_b[:, 1] - uv_a[:, 1],
                                          uv_b[:, 0] - uv_a[:, 0]), pi)
        ll = vals.clamp_min(0.0)
        # descriptor gradients from the smoothed image
        gxs, gys = sobel(pyramid.blur(img, self.blur_taps))
        desc = lbd_descriptor(gxs, gys, uv_a, uv_b, self.lbd_pairs)
        return LineFeatures(uv_a=uv_a, uv_b=uv_b,
                            l2d=line_from_endpoints_2d(uv_a, uv_b), angle=ang,
                            length=ll, response=ll / float(max(H, W)),
                            desc=desc, valid=valid)


def detect_lines(img, n_out: int = 256, block: int = 8,
                 coherence_th: float = 0.7, mag_th: float = 3.0,
                 angle_tol: float = 0.30, min_length: float = 24.0,
                 perp_tol: float = 2.5, mask=None) -> LineFeatures:
    """Functional form: build a `LineDetector` for img's shape on img's
    device and run it once. Per-frame callers keep one `LineDetector`."""
    h, w = img.shape
    return LineDetector(h, w, n_out, block, coherence_th, mag_th, angle_tol,
                        min_length, perp_tol).to(img.device)(img, mask)


def lbd_descriptor(gx, gy, uv_a, uv_b, pairs):
    """(M, 256) uint8 bits per segment: for each of N_BANDS bands across the
    line and N_SAMPLES samples along a fixed 64-px (or shorter) window
    centred on its midpoint, the 4 one-sided gradient components in the line
    frame (nearest pixel); band means and standard deviations (ddof 0), unit
    normalized, compared pairwise by `pairs` (`make_lbd_pairs`)."""
    H, W = gx.shape
    M = uv_a.shape[0]
    d = uv_b - uv_a
    L = torch.linalg.vector_norm(d, dim=-1, keepdim=True).clamp_min(1e-6)
    dpar = d / L                                            # (M, 2)
    dperp = torch.stack([-dpar[:, 1], dpar[:, 0]], -1)
    win = L[:, 0].clamp_max(64.0)
    dev = gx.device
    t = (torch.arange(N_SAMPLES, dtype=torch.float32, device=dev) + 0.5) \
        / N_SAMPLES - 0.5
    bands = (torch.arange(N_BANDS, dtype=torch.float32, device=dev)
             - (N_BANDS - 1) / 2.0) * BAND_W
    mid = 0.5 * (uv_a + uv_b)
    base = (mid[:, None, None, :]
            + (t[None, None, :, None] * win[:, None, None, None])
            * dpar[:, None, None, :])
    pos = base + bands[None, :, None, None] * dperp[:, None, None, :]
    xi = (pos[..., 0] + 0.5).clamp(0, W - 2).to(torch.int64)   # (M, B, S)
    yi = (pos[..., 1] + 0.5).clamp(0, H - 2).to(torch.int64)
    flat = yi * W + xi
    sgx = gx.reshape(-1)[flat]
    sgy = gy.reshape(-1)[flat]
    g_par = sgx * dpar[:, None, None, 0] + sgy * dpar[:, None, None, 1]
    g_perp = sgx * dperp[:, None, None, 0] + sgy * dperp[:, None, None, 1]
    feats = torch.stack([g_perp.clamp_min(0.0), (-g_perp).clamp_min(0.0),
                         g_par.clamp_min(0.0), (-g_par).clamp_min(0.0)],
                        dim=-1)                             # (M, B, S, 4)
    mean = feats.mean(dim=2)
    c = feats - mean[:, :, None, :]
    std = torch.sqrt((c * c).mean(dim=2))
    vec = torch.cat([mean, std], -1).reshape(M, N_BANDS * 8)
    vec = vec / torch.linalg.vector_norm(vec, dim=-1,
                                         keepdim=True).clamp_min(1e-9)
    return (vec[:, pairs[:, 0]] < vec[:, pairs[:, 1]]).to(torch.uint8)

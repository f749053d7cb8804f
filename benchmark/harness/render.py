"""Frames made on the device from the seed: textured planes seen through the
configuration's camera, its lens distortion included.

The method is the plane-homography renderer of the port's
`datasets/synthetic.render`, copied here so that changes to the program
cannot move the frames: each pixel's ray meets each plane at the texture
coordinates `M^-1 ray`, with `M = [R e1 s, R e2 s, R o + t]`, and the
nearest plane in front wins. Unlike that renderer, the texture is not a
finite array: a texel's value is hashed from the seed, the plane and the
integer coordinates of its 8-texel cell, so no texture ever repeats, and it
is smoothed with `make_scene`'s [0.25, 0.5, 0.25] taps along each axis and
sampled bilinearly. Straight bright segments (the scene's lines) are drawn
into the texture, one in each block of texels that the hash selects.

The camera sees through its distortion: each pixel's undistorted ray is
worked out once, at set-up, by fixed-point inversion of the radtan model in
float64, so the port's `undistort_pixels` has real work to do.
"""
from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF


def _mix(x):
    """A 32-bit integer hash (int64 tensors holding values in [0, 2^32))."""
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & M32
    x = ((x ^ (x >> 16)) * 0x45D9F3B) & M32
    return x ^ (x >> 16)


def seed_key(seed: int, *salt: int) -> int:
    """A 32-bit key from a seed of any size and a few salts (a plane, a
    stream): the same arguments give the same key."""
    key = 0x9E3779B9
    for v in (seed & M32, (seed >> 32) & M32, *[s & M32 for s in salt]):
        key = int(_mix(torch.tensor((key ^ v) & M32, dtype=torch.int64)))
    return key


def _hash2(key: int, i, j):
    """Hash of a key and two integer tensors (any sign), in [0, 2^32)."""
    h = _mix((i & M32) ^ key)
    return _mix(h ^ (j & M32))


def undistorted_rays(cam: dict, device) -> torch.Tensor:
    """(H, W, 3) float64 unit-depth rays of the pixel centres' integer
    coordinates, through the inverse of the camera's radtan distortion
    (fixed-point iteration, as `undistort_normalized`, to convergence)."""
    H, W = int(cam["height"]), int(cam["width"])
    f64 = dict(dtype=torch.float64, device=device)
    v, u = torch.meshgrid(torch.arange(H, **f64), torch.arange(W, **f64),
                          indexing="ij")
    xd = (u - cam["cx"]) / cam["fx"]
    yd = (v - cam["cy"]) / cam["fy"]
    k1, k2, k3 = cam.get("k1", 0.0), cam.get("k2", 0.0), cam.get("k3", 0.0)
    p1, p2 = cam.get("p1", 0.0), cam.get("p2", 0.0)
    x, y = xd.clone(), yd.clone()
    for _ in range(60):
        r2 = x * x + y * y
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
        dy = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
        x, y = xd - (dx - x), yd - (dy - y)
    return torch.stack([x, y, torch.ones_like(x)], -1)


class Renderer:
    """Frames of the scene described by a traffic mix's `scene` (planes,
    texture and segment parameters) for one stream, keyed by `key`."""

    def __init__(self, cam: dict, scene: dict, key: int, device):
        self.device = torch.device(device)
        self.rays = undistorted_rays(cam, self.device)
        self.scene = scene
        self.planes = [
            {"o": torch.tensor(p["origin"], dtype=torch.float64,
                               device=self.device),
             "e1": torch.tensor(p["e1"], dtype=torch.float64,
                                device=self.device),
             "e2": torch.tensor(p["e2"], dtype=torch.float64,
                                device=self.device),
             "key": seed_key(key, n)}
            for n, p in enumerate(scene["planes"])]

    def _texture(self, key: int, a, b):
        """Texture values at continuous texel coordinates a, b (float64):
        the hashed 8-texel cells, smoothed per texel by [0.25, 0.5, 0.25]
        along each axis, sampled bilinearly, with the segments on top."""
        sc = self.scene
        cell = int(sc["cell_texels"])
        a0, b0 = torch.floor(a), torch.floor(b)
        fa, fb = (a - a0).to(torch.float32), (b - b0).to(torch.float32)
        a0, b0 = a0.to(torch.int64), b0.to(torch.int64)
        # raw texels a0-1 .. a0+2 and b0-1 .. b0+2: each its cell's value
        offs = (-1, 0, 1, 2)
        ca = [torch.div(a0 + d, cell, rounding_mode="floor") for d in offs]
        cb = [torch.div(b0 + d, cell, rounding_mode="floor") for d in offs]
        raw = [[_hash2(key, ca[i], cb[j]).to(torch.float32)
                * (255.0 / 2 ** 32) for i in range(4)] for j in range(4)]
        w = (0.25, 0.5, 0.25)
        # smoothed texels at (a0 + da, b0 + db), da, db in {0, 1}
        sm = [[sum(w[p] * w[q] * raw[db + q][da + p]
                   for p in range(3) for q in range(3))
               for da in range(2)] for db in range(2)]
        val = (sm[0][0] * (1 - fa) * (1 - fb) + sm[0][1] * fa * (1 - fb)
               + sm[1][0] * (1 - fa) * fb + sm[1][1] * fa * fb)
        # one straight segment in each block of texels the hash selects
        blk = float(sc["edge_block_texels"])
        ba, bb = torch.floor(a / blk), torch.floor(b / blk)
        h = [_hash2(seed_key(key, 7 + n), ba.to(torch.int64),
                    bb.to(torch.int64)).to(torch.float64) / 2 ** 32
             for n in range(6)]
        lo, hi = sc["edge_len_texels"]
        half = 0.5 * (lo + (hi - lo) * h[1])
        jitter = math.radians(sc["edge_jitter_deg"])
        ang = torch.where(h[2] < 0.5, 0.0, 0.5 * math.pi) \
            + (2.0 * h[3] - 1.0) * jitter
        room = 0.5 * blk - 0.5 * hi - 1.0
        ctr_a = (ba + 0.5) * blk + (2.0 * h[4] - 1.0) * room
        ctr_b = (bb + 0.5) * blk + (2.0 * h[5] - 1.0) * room
        da, db = a - ctr_a, b - ctr_b
        along = da * torch.cos(ang) + db * torch.sin(ang)
        perp = -da * torch.sin(ang) + db * torch.cos(ang)
        on = ((h[0] < sc["edge_share"]) & (along.abs() < half)
              & (perp.abs() < 0.5 * sc["edge_width_texels"]))
        return torch.where(on, float(sc["edge_value"]), val)

    def render(self, T_cw, depth: bool = False, batch: int = 8):
        """(B, H, W) uint8 frames at the (B, 4, 4) world->camera poses (and,
        with `depth`, their (B, H, W) float32 depth, 0 where nothing is),
        made `batch` frames at a time."""
        T = torch.as_tensor(np.asarray(T_cw), dtype=torch.float64,
                            device=self.device).reshape(-1, 4, 4)
        outs = [self._render(T[i:i + batch]) for i in range(0, len(T), batch)]
        frames = torch.cat([f for f, _ in outs])
        if depth:
            return frames, torch.cat([z for _, z in outs])
        return frames

    def _render(self, T):
        sc = self.scene
        s = float(sc["texel_m"])
        B = T.shape[0]
        R, t = T[:, :3, :3], T[:, :3, 3]
        shape = (B,) + self.rays.shape[:2]
        img = torch.full(shape, float(sc["background"]), dtype=torch.float32,
                         device=self.device)
        zbuf = torch.full(shape, math.inf, dtype=torch.float64,
                          device=self.device)
        for p in self.planes:
            M = torch.stack([R @ p["e1"] * s, R @ p["e2"] * s,
                             R @ p["o"] + t], -1)                  # (B, 3, 3)
            q = torch.einsum("hwk,bjk->bhwj", self.rays, torch.linalg.inv(M))
            w = q[..., 2]
            ok = w > 1e-9
            wz = torch.where(ok, w, 1.0)
            z = 1.0 / wz
            front = ok & (z > 0.05) & (z < zbuf)
            val = self._texture(p["key"], q[..., 0] / wz, q[..., 1] / wz)
            img = torch.where(front, val, img)
            zbuf = torch.where(front, z, zbuf)
        frames = torch.floor(img.clamp(0, 255) + 0.5).to(torch.uint8)
        return frames, torch.where(torch.isfinite(zbuf), zbuf,
                                   0.0).to(torch.float32)


def pose_from(center, angles) -> np.ndarray:
    """(4, 4) world->camera pose of a camera at `center` whose
    camera-to-world rotation is exp(angles) (a rotation vector, radians):
    at zero angles it looks along +z, x right, y down."""
    w = np.asarray(angles, np.float64)
    th = np.linalg.norm(w)
    K = np.array([[0, -w[2], w[1]], [w[2], 0, -w[0]], [-w[1], w[0], 0]])
    if th < 1e-12:
        R_wc = np.eye(3) + K
    else:
        R_wc = (np.eye(3) + math.sin(th) / th * K
                + (1 - math.cos(th)) / th ** 2 * K @ K)
    T = np.eye(4)
    T[:3, :3] = R_wc.T
    T[:3, 3] = -R_wc.T @ np.asarray(center, np.float64)
    return T

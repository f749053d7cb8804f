"""Photo-textured synthetic scenes: real image statistics, exact ground truth.

Port of `plslam_tpu/datasets/textured.py` (numpy), on the port's
`synthetic.Plane` and `Scene`. The block-texture scenes of :mod:`synthetic`
have unrealistically clean corner statistics; these scenes texture the same
geometry with a real photograph, so descriptors, the vocabulary and matching
meet natural image content.

The photo is matplotlib's public-domain sample `grace_hopper.jpg`, carried
here as its grayscale conversion, `np.asarray(Image.open(path).convert("L"))`
((600, 512) uint8), in `grace_hopper_gray.npz`: the port needs neither
matplotlib nor PIL, and both packages texture with the same bits.
"""
from __future__ import annotations

import os

import numpy as np

from .synthetic import Plane, Scene

PHOTO_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "grace_hopper_gray.npz")


def _load_photo() -> np.ndarray:
    """Grayscale float32 photo (600x512), values 0..255."""
    with np.load(PHOTO_PATH) as f:
        return f["photo"].astype(np.float32)


def _tile_photo(photo: np.ndarray, h: int, w: int, rng, n_aug: int = 4
                ) -> np.ndarray:
    """Tile augmented crops of the photo into an (h, w) texture. Flips +
    transposes + brightness jitter de-correlate the tiles so repeated
    content doesn't create perceptual aliasing BY CONSTRUCTION (we want to
    measure aliasing on natural statistics, not inject it)."""
    ph, pw = photo.shape
    out = np.zeros((h, w), np.float32)
    ty, tx = ph, pw
    for y0 in range(0, h, ty):
        for x0 in range(0, w, tx):
            tile = photo
            k = rng.integers(0, 4)
            if k & 1:
                tile = tile[::-1]
            if k & 2:
                tile = tile[:, ::-1]
            # (the r2 transpose branch was dead — a non-square photo can
            # never yield a (ph, pw) crop of its own transpose; flips +
            # jitter already de-correlate the tiles)
            gain = rng.uniform(0.7, 1.3)
            off = rng.uniform(-20, 20)
            t = np.clip(tile * gain + off, 0, 255)
            hh = min(ty, h - y0)
            ww = min(tx, w - x0)
            out[y0:y0 + hh, x0:x0 + ww] = t[:hh, :ww]
    return out


def make_photo_scene(seed: int = 0, width: int = 640, height: int = 480,
                     fx: float = 500.0, fy: float = 500.0,
                     n_lines: int = 32, layout: str = "open") -> Scene:
    """Room layout textured with real photographic content; same
    trajectory/rendering machinery as `synthetic.make_scene`.

    layout='open': back wall + floor + side wall (the head-to-head orbit
    fixture — camera always looks toward +z).
    layout='room': a closed 6 m box (4 walls + floor + ceiling) so a
    circular trajectory looking radially outward sees photo texture in
    EVERY heading — the photo-realistic loop-closure fixture (the circle
    breaks covisibility between opposite headings, so the final frames
    revisit the first viewpoints through place recognition only)."""
    rng = np.random.default_rng(seed)
    photo = _load_photo()
    ts = 0.01

    def plane(origin, e1, e2, hw):
        tex = _tile_photo(photo, *hw, rng=rng)
        e1 = np.asarray(e1, np.float32)
        e2 = np.asarray(e2, np.float32)
        return Plane(np.asarray(origin, np.float32),
                     e1 / np.linalg.norm(e1), e2 / np.linalg.norm(e2),
                     ts, tex)

    if layout == "room":
        h = 6.0  # half-extent of the box in x/z; walls span y in [-4, 3]
        planes = [
            plane([-h, -4.0, h], [1, 0, 0], [0, 1, 0], (700, 1200)),   # +z
            plane([h, -4.0, -h], [-1, 0, 0], [0, 1, 0], (700, 1200)),  # -z
            plane([-h, -4.0, -h], [0, 0, 1], [0, 1, 0], (700, 1200)),  # -x
            plane([h, -4.0, h], [0, 0, -1], [0, 1, 0], (700, 1200)),   # +x
            plane([-h, 3.0, -h], [1, 0, 0], [0, 0, 1], (1200, 1200)),  # floor
            plane([-h, -4.0, -h], [1, 0, 0], [0, 0, 1], (1200, 1200)),  # ceil
        ]
    else:
        planes = [
            plane([-6.0, -4.0, 9.0], [1, 0, 0], [0, 1, 0], (800, 1200)),
            plane([-6.0, 2.5, 2.0], [1, 0, 0], [0, 0.12, 1.0], (800, 1200)),
            plane([-5.5, -4.0, 2.0], [0.08, 0, 1.0], [0, 1, 0], (800, 800)),
        ]

    if layout == "room":
        # keep segments inside the box: the renderer draws segments on top
        # of planes without a z-test, so out-of-room lines would bleed
        # through walls
        la = np.stack([rng.uniform(-4.5, 4.5, n_lines),
                       rng.uniform(-3.0, 2.0, n_lines),
                       rng.uniform(-4.5, 4.5, n_lines)], -1)
    else:
        la = np.stack([rng.uniform(-3.5, 3.5, n_lines),
                       rng.uniform(-2.5, 2.5, n_lines),
                       rng.uniform(3.5, 8.0, n_lines)], -1)
    axes = np.eye(3)[rng.integers(0, 3, n_lines)]
    dirs = axes + rng.normal(0, 0.08, (n_lines, 3))
    dirs /= np.linalg.norm(dirs, axis=-1, keepdims=True)
    lb = la + dirs * rng.uniform(0.8, 2.5, (n_lines, 1))
    lines = np.concatenate([la, lb], -1).astype(np.float32)

    K = np.array([[fx, 0, width / 2.0], [0, fy, height / 2.0], [0, 0, 1]],
                 np.float32)
    pts = np.zeros((0, 3), np.float32)
    return Scene(planes, lines, pts, K, width, height)


def write_tum_sequence(out_dir: str, frames, timestamps) -> None:
    """Write frames as a TUM-format sequence (rgb/ + rgb.txt) so the
    `examples/mono_tum.py` driver — and its reference counterpart's input
    contract (`Examples/Monocular/mono_tum.cc:LoadImages`) — can run on it
    unmodified. The PNGs go through `native_loader.write_png` (cv2)."""
    from ..utils.native_loader import write_png
    os.makedirs(os.path.join(out_dir, "rgb"), exist_ok=True)
    with open(os.path.join(out_dir, "rgb.txt"), "w") as f:
        f.write("# color images\n# file: synthetic\n# timestamp filename\n")
        for ts, img in zip(timestamps, frames):
            name = f"rgb/{ts:.6f}.png"
            write_png(os.path.join(out_dir, name),
                      np.clip(img, 0, 255).astype(np.uint8))
            f.write(f"{ts:.6f} {name}\n")

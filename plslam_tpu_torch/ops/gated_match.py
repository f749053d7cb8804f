"""Fused projection-gated Hamming top-2 search (kernel K1).

Port of `plslam_tpu/ops/pallas_match.py`. `gated_hamming_best2` runs the
hand-written CUDA kernel `csrc/gated_hamming.cu` on CUDA tensors and the plain
PyTorch version, `gated_hamming_best2_reference`, on CPU tensors. There is no
fallback: on a CUDA tensor a failed build or launch raises.

The kernel is compiled with nvcc at first use into `build/plslam_tpu_torch/`
under the repository root, named by the hash of its source, so an edited
source rebuilds. It exposes a plain C entry point loaded with ctypes.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

import torch

from . import hamming

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "plslam_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]
CHUNK = 256   # map points per chunk of the second grid dimension

_lib = None


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: building the gated Hamming kernel "
                       "needs the CUDA toolkit (set CUDA_HOME)")


def build(verbose: bool = False) -> Path:
    """Compile `csrc/gated_hamming.cu` into a shared library (or find it
    already built for this source hash) and return its path."""
    src = CSRC_DIR / "gated_hamming.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    out = BUILD_DIR / f"gated_hamming_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
    if verbose:
        print(f"built {out.name} in {time.perf_counter() - t0:.1f} s\n"
              f"{proc.stderr}", end="")
    os.replace(tmp, out)
    return out


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        fn = lib.plslam_gated_hamming_best2
        fn.argtypes = ([ctypes.c_int, ctypes.c_void_p] + [ctypes.c_void_p] * 9
                       + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 6)
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def pack_bits(bits):
    """(R, 256) {0,1} uint8 -> (R, 8) int32 words holding the bits as 8 x
    uint32 (bit j of word w = bit 32 w + j)."""
    weights = torch.ones(32, dtype=torch.int64, device=bits.device) \
        << torch.arange(32, device=bits.device)
    words = (bits.view(-1, 8, 32).to(torch.int64) * weights).sum(-1)
    return words.to(torch.int32)


_SPEC = (  # name, dtype, trailing shape, query (N) or map (P) side
    ("q_bits", torch.uint8, (256,), "N"), ("q_uv", torch.float32, (2,), "N"),
    ("q_oct", torch.int32, (), "N"), ("q_valid", torch.bool, (), "N"),
    ("d_bits", torch.uint8, (256,), "P"), ("d_uv", torch.float32, (2,), "P"),
    ("d_radius", torch.float32, (), "P"), ("d_level", torch.int32, (), "P"),
    ("d_visible", torch.bool, (), "P"),
)


_PACKED = {"q_bits": ("q_desc", torch.int32, (8,)),
           "d_bits": ("d_desc", torch.int32, (8,))}


def _check(args, packed=False):
    n, p = args[0].shape[0], args[4].shape[0]
    device = args[0].device
    for t, (name, dtype, tail, side) in zip(args, _SPEC):
        if packed and name in _PACKED:
            name, dtype, tail = _PACKED[name]
        shape = ((n if side == "N" else p),) + tail
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, q_bits on {device}")
        if t.dtype != dtype:
            raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
        if tuple(t.shape) != shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")
    return n, p, device


def gated_hamming_best2_reference(q_bits, q_uv, q_oct, q_valid, d_bits, d_uv,
                                  d_radius, d_level, d_visible, gated=True):
    """Plain PyTorch version: `distance_matrix` + the gate mask +
    `masked_best2`, materializing the (N, P) matrices."""
    D = hamming.distance_matrix(q_bits, d_bits)
    mask = d_visible[None, :] & q_valid[:, None]
    if gated:
        du = (q_uv[:, 0:1] - d_uv[None, :, 0]).abs()
        dv = (q_uv[:, 1:2] - d_uv[None, :, 1]).abs()
        mask = mask & (du < d_radius[None, :]) & (dv < d_radius[None, :]) \
            & ((q_oct[:, None] - d_level[None, :]).abs() <= 1)
    return hamming.masked_best2(D, mask)


def gated_hamming_best2(q_bits, q_uv, q_oct, q_valid, d_bits, d_uv, d_radius,
                        d_level, d_visible, gated=True):
    """Projection-gated Hamming NN search.

    q_bits (N, 256) {0,1} uint8, q_uv (N, 2) float32, q_oct (N,) int32,
    q_valid (N,) bool; d_bits (P, 256) uint8, d_uv (P, 2) float32 projected
    map points, d_radius (P,) float32 window radius, d_level (P,) int32
    predicted octave, d_visible (P,) bool. With `gated=False` only the
    valid x visible mask applies. Returns (best_idx, best, second), as
    `hamming.masked_best2` under the gates: int64 index, int32 distances,
    INVALID where nothing passes (index 0), ties to the lowest index.

    CUDA tensors launch the kernel (see `launch_packed`); CPU tensors take
    the plain version."""
    args = (q_bits, q_uv, q_oct, q_valid, d_bits, d_uv, d_radius, d_level,
            d_visible)
    _, _, device = _check(args)
    if device.type == "cpu":
        return gated_hamming_best2_reference(*args, gated=gated)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    return launch_packed(pack_bits(q_bits), q_uv, q_oct, q_valid,
                         pack_bits(d_bits), d_uv, d_radius, d_level, d_visible,
                         gated)


def launch_packed(q_desc, q_uv, q_oct, q_valid, d_desc, d_uv, d_radius,
                  d_level, d_visible, gated=True):
    """Launch the kernel on CUDA tensors, with the descriptors packed by
    `pack_bits`, and count the launch in `gated_hamming_best2.launches`.
    Returns (best_idx, best, second)."""
    n, p, device = _check((q_desc, q_uv, q_oct, q_valid, d_desc, d_uv,
                           d_radius, d_level, d_visible), packed=True)
    if device.type != "cuda":
        raise ValueError(f"the kernel needs CUDA tensors, got {device}")
    fn = _load().plslam_gated_hamming_best2
    n_chunks = -(-p // CHUNK)
    part = torch.empty((3, max(n_chunks, 1), n), dtype=torch.int32,
                       device=device)
    out = torch.empty((3, n), dtype=torch.int32, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    ptr = lambda t: t.data_ptr()
    err = fn(device.index, stream,
             ptr(q_desc), ptr(q_uv), ptr(q_oct), ptr(q_valid), ptr(d_desc),
             ptr(d_uv), ptr(d_radius), ptr(d_level), ptr(d_visible),
             n, p, int(bool(gated)), CHUNK,
             ptr(part[0]), ptr(part[1]), ptr(part[2]),
             ptr(out[0]), ptr(out[1]), ptr(out[2]))
    if err != 0:
        raise RuntimeError(f"gated_hamming_best2 launch failed: CUDA error "
                           f"{err}")
    if n > 0:  # the entry point launches nothing for an empty query set
        gated_hamming_best2.launches += 1
    return out[2].long(), out[0], out[1]


gated_hamming_best2.launches = 0

"""Fused projection-gated Hamming top-2 search (kernel K1).

Port of `plslam_tpu/ops/pallas_match.py`. `gated_hamming_best2` runs the
hand-written CUDA kernel `csrc/gated_hamming.cu` on CUDA tensors, one launch
per search on the inputs as they are (its tensor-memory copies want the map
side 16-byte aligned, as fresh tensors are), and the plain PyTorch version,
`gated_hamming_best2_reference`, on CPU tensors. There is no fallback: on a
CUDA tensor a failed build or launch raises.

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
from ..models import step_graph

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "plslam_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

MAX_POINTS = 1 << 21   # the kernel's (distance, index) keys hold 22-bit indices
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
                       + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 3)
        fn.restype = ctypes.c_int
        _lib = lib
    return _lib


_SPEC = (  # name, dtype, trailing shape, query (N) or map (P) side,
           # byte alignment the kernel reads it with
    ("q_bits", torch.uint8, (256,), "N", 16),
    ("q_uv", torch.float32, (2,), "N", 8),
    ("q_oct", torch.int32, (), "N", 4), ("q_valid", torch.bool, (), "N", 1),
    ("d_bits", torch.uint8, (256,), "P", 16),
    ("d_uv", torch.float32, (2,), "P", 16),
    ("d_radius", torch.float32, (), "P", 16),
    ("d_level", torch.int32, (), "P", 16),
    ("d_visible", torch.bool, (), "P", 16),
)


def _check(args):
    n, p = args[0].shape[0], args[4].shape[0]
    device = args[0].device
    for t, (name, dtype, tail, side, _) in zip(args, _SPEC):
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


def gate_mask(q_uv, q_oct, q_valid, d_uv, d_radius, d_level, d_visible,
              gated=True):
    """(N, P) bool: the pairs the search may match (see
    `gated_hamming_best2`)."""
    mask = d_visible[None, :] & q_valid[:, None]
    if gated:
        du = (q_uv[:, 0:1] - d_uv[None, :, 0]).abs()
        dv = (q_uv[:, 1:2] - d_uv[None, :, 1]).abs()
        mask = mask & (du < d_radius[None, :]) & (dv < d_radius[None, :]) \
            & ((q_oct[:, None] - d_level[None, :]).abs() <= 1)
    return mask


def gated_hamming_best2_reference(q_bits, q_uv, q_oct, q_valid, d_bits, d_uv,
                                  d_radius, d_level, d_visible, gated=True):
    """Plain PyTorch version: `distance_matrix` + `gate_mask` +
    `masked_best2`, materializing the (N, P) matrices."""
    return hamming.masked_best2(
        hamming.distance_matrix(q_bits, d_bits),
        gate_mask(q_uv, q_oct, q_valid, d_uv, d_radius, d_level, d_visible,
                  gated))


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

    CUDA tensors launch the kernel, one launch per call, counted in
    `gated_hamming_best2.launches`; CPU tensors take the plain version."""
    args = (q_bits, q_uv, q_oct, q_valid, d_bits, d_uv, d_radius, d_level,
            d_visible)
    n, p, device = _check(args)
    if device.type == "cpu":
        return gated_hamming_best2_reference(*args, gated=gated)
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if p >= MAX_POINTS:
        raise ValueError(f"the kernel takes fewer than {MAX_POINTS} map "
                         f"points, got {p}")
    for t, (name, _, _, _, align) in zip(args, _SPEC):
        if t.data_ptr() % align:
            raise ValueError(f"{name} is not {align}-byte aligned")
    fn = _load().plslam_gated_hamming_best2
    best2 = torch.empty((2, n), dtype=torch.int32, device=device)
    idx = torch.empty(n, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = fn(device.index, stream, *(t.data_ptr() for t in args), n, p,
             int(bool(gated)), best2[0].data_ptr(), best2[1].data_ptr(),
             idx.data_ptr())
    if err != 0:
        raise RuntimeError(f"gated_hamming_best2 launch failed: CUDA error "
                           f"{err}")
    if n > 0:  # the entry point launches nothing for an empty query set
        gated_hamming_best2.launches += 1
    return idx, best2[0], best2[1]


# a replay of a captured step adds the launches its capture recorded
step_graph.counted(gated_hamming_best2)

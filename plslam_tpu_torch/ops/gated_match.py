"""Fused projection-gated Hamming top-2 search (kernel K1).

Port of `plslam_tpu/ops/pallas_match.py`. `gated_hamming_best2` runs the
hand-written CUDA kernel `csrc/gated_hamming.cu` on CUDA tensors, one launch
per search on the inputs as they are (its tensor-memory copies want the map
side 16-byte aligned, as fresh tensors are), and the plain PyTorch version,
`gated_hamming_best2_reference`, on CPU tensors. There is no fallback: on a
CUDA tensor a failed build or launch raises.

The search is a `torch.library` custom op with a vmap rule, the counterpart
of the TPU kernel under `jax.vmap`: under `torch.func.vmap` over S streams a
CUDA call is one launch for all S (grid z = the stream; an input not
batched is shared by every stream, one batched over its leading axis is
read in place; one search is S = 1 with every input shared), a CPU call
the plain version batched over a leading axis, as `gate_mask` and the
plain version take it.

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
                       + [ctypes.c_int] * 3 + [ctypes.POINTER(ctypes.c_int),
                                               ctypes.c_int]
                       + [ctypes.c_void_p] * 3)
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


def _check(args, batched=(False,) * 9):
    """(N, P, device) of one search's inputs, or of a batch of searches
    where `batched[i]` says that input i carries the stream axis in front;
    raises on a device, dtype, shape or layout the kernel does not take."""
    lead = lambda i: args[i].shape[1] if batched[i] else args[i].shape[0]
    n, p = lead(0), lead(4)
    device = args[0].device
    for t, b, (name, dtype, tail, side, _) in zip(args, batched, _SPEC):
        shape = ((t.shape[0],) if b else ()) \
            + ((n if side == "N" else p),) + tail
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
    """(..., N, P) bool: the pairs the search may match (see
    `gated_hamming_best2`), over any leading batch axes."""
    mask = d_visible[..., None, :] & q_valid[..., :, None]
    if gated:
        du = (q_uv[..., :, 0:1] - d_uv[..., None, :, 0]).abs()
        dv = (q_uv[..., :, 1:2] - d_uv[..., None, :, 1]).abs()
        r = d_radius[..., None, :]
        mask = mask & (du < r) & (dv < r) \
            & ((q_oct[..., :, None] - d_level[..., None, :]).abs() <= 1)
    return mask


def gated_hamming_best2_reference(q_bits, q_uv, q_oct, q_valid, d_bits, d_uv,
                                  d_radius, d_level, d_visible, gated=True):
    """Plain PyTorch version: `distance_matrix` + `gate_mask` +
    `masked_best2`, materializing the (N, P) matrices; inputs with a common
    leading batch axis give (S, N) outputs."""
    return hamming.masked_best2(
        hamming.distance_matrix(q_bits, d_bits),
        gate_mask(q_uv, q_oct, q_valid, d_uv, d_radius, d_level, d_visible,
                  gated))


def _check_device(args, n: int, p: int):
    """The device of a CUDA call's inputs; raises on what the kernel does
    not take (another device type, P >= 2^21, a map-side input or q_bits
    not aligned as the kernel reads it)."""
    device = args[0].device
    if device.type != "cuda":
        raise ValueError(f"unsupported device {device}")
    if p >= MAX_POINTS:
        raise ValueError(f"the kernel takes fewer than {MAX_POINTS} map "
                         f"points, got {p}")
    for t, (name, _, _, _, align) in zip(args, _SPEC):
        if t.data_ptr() % align:
            raise ValueError(f"{name} is not {align}-byte aligned")
    return device


def _launch(args, gated: bool, in_dims=(None,) * 9, S: int = 1):
    """One launch of the kernel: one search (the default), or S searches,
    each input batched over axis `in_dims[i]` (moved to the front, made
    contiguous where it is not) or shared by every stream (None). The
    base of every map-side input must be 16-byte aligned; a stream's rows
    may start anywhere. Returns (idx, best, second), each (N,) for one
    search and (S, N) for a batch."""
    args = [t if d is None else t.movedim(d, 0).contiguous()
            for t, d in zip(args, in_dims)]
    batched = tuple(d is not None for d in in_dims)
    n, p, _ = _check(args, batched)
    for t, b, (name, *_) in zip(args, batched, _SPEC):
        if b and t.shape[0] != S:
            raise ValueError(f"{name}: {t.shape[0]} streams, expected {S}")
    device = _check_device(args, n, p)
    if S * p >= 1 << 31:
        raise ValueError(f"{S} streams x {p} map points overflow the "
                         f"kernel's int32 rows")
    # each stream's gate fields and flags start 16-byte aligned (the tensor
    # maps' row stride): rows padded to a multiple of 16 points where P is
    # not one (a copy; the tracking step's maps need none)
    p_row = -(-p // 16) * 16
    if p_row != p:
        args = [torch.cat([t, t.new_zeros((S, p_row - p) + t.shape[2:])], 1)
                if b and i >= 5 else t
                for i, (t, b) in enumerate(zip(args, batched))]
    rows = (ctypes.c_int * 9)(*[0 if not b else n if side == "N" else
                                p_row if i >= 5 else p
                                for i, (b, (_, _, _, side, _)) in
                                enumerate(zip(batched, _SPEC))])
    shape = (S, n) if any(batched) else (n,)
    best = torch.empty(shape, dtype=torch.int32, device=device)
    second = torch.empty(shape, dtype=torch.int32, device=device)
    idx = torch.empty(shape, dtype=torch.int64, device=device)
    stream = torch.cuda.current_stream(device).cuda_stream
    err = _load().plslam_gated_hamming_best2(
        device.index, stream, *(t.data_ptr() for t in args), n, p, S, rows,
        int(bool(gated)), best.data_ptr(), second.data_ptr(), idx.data_ptr())
    if err != 0:
        raise RuntimeError(f"gated_hamming_best2 launch failed: CUDA error "
                           f"{err}")
    if n > 0 and S > 0:  # the entry point launches nothing for no query
        gated_hamming_best2.launches += 1
    return idx, best, second


@torch.library.custom_op("plslam_tpu_torch::gated_hamming_best2",
                         mutates_args=())
def _best2_op(q_bits: torch.Tensor, q_uv: torch.Tensor, q_oct: torch.Tensor,
              q_valid: torch.Tensor, d_bits: torch.Tensor,
              d_uv: torch.Tensor, d_radius: torch.Tensor,
              d_level: torch.Tensor, d_visible: torch.Tensor,
              gated: bool) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    args = (q_bits, q_uv, q_oct, q_valid, d_bits, d_uv, d_radius, d_level,
            d_visible)
    if q_bits.device.type == "cpu":
        return gated_hamming_best2_reference(*args, gated=gated)
    return _launch(args, gated)


@_best2_op.register_vmap
def _best2_vmap(info, in_dims, *args):
    tensors, gated = args[:9], args[9]
    S = info.batch_size
    if tensors[0].device.type == "cpu":   # the plain version, batched
        out = gated_hamming_best2_reference(
            *(t.expand((S,) + t.shape) if d is None else t.movedim(d, 0)
              for t, d in zip(tensors, in_dims)), gated=gated)
    else:
        out = _launch(tensors, gated, tuple(in_dims[:9]), S)
    return out, (0, 0, 0)


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

    CUDA tensors launch the kernel, one launch per call (under
    `torch.func.vmap`, one per batched call), counted in
    `gated_hamming_best2.launches`; CPU tensors take the plain version."""
    _check((q_bits, q_uv, q_oct, q_valid, d_bits, d_uv, d_radius, d_level,
            d_visible))
    return _best2_op(q_bits, q_uv, q_oct, q_valid, d_bits, d_uv, d_radius,
                     d_level, d_visible, bool(gated))


# a replay of a captured step adds the launches its capture recorded
step_graph.counted(gated_hamming_best2)

"""nvcc builds of the port's CUDA C++ sources with a plain C interface.

A source under `csrc/` is compiled at first use into a shared library in
`build/plslam_tpu_torch/` under the repository root, named by the hash of
its source and flags, so an edited source rebuilds; the caller loads it
with ctypes.
"""
from __future__ import annotations

import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "plslam_tpu_torch"


def nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: building the port's CUDA kernels "
                       "needs the CUDA toolkit (set CUDA_HOME)")


def build(src: Path, flags, verbose: bool = False) -> Path:
    """Compile `src` with nvcc and `flags` into a shared library (or find it
    already built for this source and these flags) and return its path."""
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode())
    out = BUILD_DIR / f"{src.stem}_{digest.hexdigest()[:16]}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    cmd = [nvcc(), *flags, *(["-Xptxas", "-v"] if verbose else []),
           "-o", tmp, str(src)]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):"
                           f"\n{proc.stderr}")
    if verbose:
        print(f"built {out.name} in {time.perf_counter() - t0:.1f} s\n"
              f"{proc.stderr}", end="")
    os.replace(tmp, out)
    return out

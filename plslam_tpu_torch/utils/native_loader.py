"""Image I/O for the drivers: the native C++ prefetching loader, with cv2
when it cannot be built, and a PNG writer (cv2).

Port of `plslam_tpu/utils/native_loader.py`. The port builds its own copy of
the loader, `csrc/plslam_loader.cpp`, with g++ at first use into
`build/plslam_tpu_torch/` under the repository root, named by the hash of
its source, as `ops/gated_match.py` builds the kernel. When the build fails
(no g++, or no libpng / libjpeg headers), frames decode through cv2, as in
the JAX package, but still ahead of the caller, on a pool of threads (cv2
releases the GIL while it decodes); `PrefetchLoader.native` says which of
the two decoders ran.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
from pathlib import Path
from typing import Iterator, Optional, Sequence

import numpy as np

CSRC = Path(__file__).resolve().parents[1] / "csrc" / "plslam_loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "plslam_tpu_torch"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]
LIBS = ["-lpng", "-ljpeg", "-lz", "-lpthread"]

_LIB: Optional[ctypes.CDLL] = None
_BUILD_ERROR: Optional[str] = None   # set once a build has failed


def build() -> Optional[Path]:
    """Compile the loader (or find it built for this source hash); None,
    with the reason in `build_error()`, when g++ or its libraries fail."""
    global _BUILD_ERROR
    digest = hashlib.sha256(CSRC.read_bytes() + " ".join(
        CXX_FLAGS + LIBS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"plslam_loader_{digest}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, str(CSRC),
                               *LIBS], capture_output=True, text=True)
    except OSError as e:
        os.unlink(tmp)
        _BUILD_ERROR = f"g++: {e}"
        return None
    if proc.returncode != 0:
        os.unlink(tmp)
        _BUILD_ERROR = proc.stderr.strip().splitlines()[0] if proc.stderr \
            else f"g++ exited {proc.returncode}"
        return None
    os.replace(tmp, out)
    return out


def build_error() -> Optional[str]:
    """Why the last build failed (None if it did not)."""
    return _BUILD_ERROR


def _lib() -> Optional[ctypes.CDLL]:
    global _LIB, _BUILD_ERROR
    if _LIB is not None or _BUILD_ERROR is not None:
        return _LIB       # a failed build is not retried in this process
    so = build()
    if so is None:
        return None
    try:
        lib = ctypes.CDLL(str(so))
    except OSError as e:    # built elsewhere, its libraries missing here
        _BUILD_ERROR = f"{so.name}: {e}"
        return None
    out_args = [ctypes.c_int64, ctypes.POINTER(ctypes.c_int),
                ctypes.POINTER(ctypes.c_int)]
    lib.loader_create.restype = ctypes.c_void_p
    lib.loader_create.argtypes = [ctypes.POINTER(ctypes.c_char_p),
                                  ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.loader_next.restype = ctypes.c_int
    lib.loader_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_uint8), *out_args]
    lib.loader_destroy.argtypes = [ctypes.c_void_p]
    lib.decode_gray.restype = ctypes.c_int
    lib.decode_gray.argtypes = [ctypes.c_char_p,
                                ctypes.POINTER(ctypes.c_uint8), *out_args]
    _LIB = lib
    return lib


def native_available() -> bool:
    """Whether the native loader is built (building it if need be)."""
    return _lib() is not None


def _cv2_read(path: str, flags_name: str) -> np.ndarray:
    import cv2
    img = cv2.imread(path, getattr(cv2, flags_name))
    if img is None:
        raise IOError(path)
    return img


class PrefetchLoader:
    """Iterate grayscale uint8 frames decoded `queue_depth` frames ahead
    by `n_threads` background threads: the native C++ loader's, or cv2 on
    Python threads when the native loader is not built."""

    MAX_BYTES = 4096 * 3072

    def __init__(self, paths: Sequence[str], queue_depth: int = 4,
                 n_threads: int = 2):
        self.paths = list(paths)
        lib = _lib()
        self.native = lib is not None
        self._h = self._pool = None
        if self.native:
            arr = (ctypes.c_char_p * len(self.paths))(
                *[p.encode() for p in self.paths])
            self._h = lib.loader_create(arr, len(self.paths), queue_depth,
                                        n_threads)
            self._lib_ref = lib
        else:
            from concurrent.futures import ThreadPoolExecutor
            self._pool = ThreadPoolExecutor(n_threads)
            self._ahead = [self._pool.submit(_cv2_read, p, "IMREAD_GRAYSCALE")
                           for p in self.paths[:queue_depth]]
        self._i = 0

    def __iter__(self) -> Iterator[np.ndarray]:
        return self

    def __next__(self) -> np.ndarray:
        if self._i >= len(self.paths):
            raise StopIteration
        self._i += 1
        if not self.native:
            nxt = self._i - 1 + len(self._ahead)
            if nxt < len(self.paths):
                self._ahead.append(self._pool.submit(
                    _cv2_read, self.paths[nxt], "IMREAD_GRAYSCALE"))
            return self._ahead.pop(0).result()
        buf = np.empty(self.MAX_BYTES, np.uint8)
        w, h = ctypes.c_int(), ctypes.c_int()
        rc = self._lib_ref.loader_next(
            self._h, buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            self.MAX_BYTES, ctypes.byref(w), ctypes.byref(h))
        if rc != 0:
            raise IOError(f"native loader error {rc} at frame {self._i - 1}")
        return buf[: w.value * h.value].reshape(h.value, w.value).copy()

    def close(self):
        if self.native and self._h:
            self._lib_ref.loader_destroy(self._h)
            self._h = None
        if self._pool is not None:
            self._pool.shutdown(cancel_futures=True)
            self._pool = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def decode_gray(path: str) -> np.ndarray:
    """One-shot decode to (H, W) uint8 gray (native; cv2 fallback)."""
    lib = _lib()
    if lib is None:
        return _cv2_read(path, "IMREAD_GRAYSCALE")
    buf = np.empty(PrefetchLoader.MAX_BYTES, np.uint8)
    w, h = ctypes.c_int(), ctypes.c_int()
    rc = lib.decode_gray(path.encode(),
                         buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                         PrefetchLoader.MAX_BYTES, ctypes.byref(w),
                         ctypes.byref(h))
    if rc != 0:
        raise IOError(f"decode_gray({path}) -> {rc}")
    return buf[: w.value * h.value].reshape(h.value, w.value).copy()


def write_png(path: str, img: np.ndarray) -> None:
    """Write an (H, W) uint8 or uint16 gray image as PNG through cv2."""
    import cv2
    if not cv2.imwrite(path, np.asarray(img)):
        raise IOError(f"cv2.imwrite({path}) failed")

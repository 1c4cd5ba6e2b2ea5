"""ctypes bindings for the native host library (``csrc/srcnn_host.cpp``)
-- port of ``libsrcnn_tpu/io/native.py``.

The device compute is PyTorch / CUDA; the native tier covers the host data
path: OpenMP color packing, double-precision contribution tables, and a
lock-free frame ring for streaming producers (:class:`FrameRing`, which
``serve.VideoUpscaler.stream_from_ring`` consumes).

The library is built from ``csrc/srcnn_host.cpp`` beside this module, the
port's own copy of the JAX package's ``native/srcnn_host.cpp`` (kept
byte-equal to it by ``tests/test_torch_native.py``), at first use with
``g++`` into ``kernels/_build/`` (git-ignored), with the flags of
``native/Makefile`` less ``-march=native``: a library built for one host's
CPU may fault on another's.  Without ``-ffast-math`` and with
``-ffp-contract=off`` the compiler neither reorders nor fuses a float sum,
so the color pack and the f64 tables stay bit-identical to the port's
torch / numpy ops.  The file name carries a hash of the source and the
flags, as ``kernels/_build`` does for nvcc, so an edited source rebuilds.
The binary in ``native/`` is never loaded and ``make`` is never run.
:func:`available` reports whether the build succeeded; every entry point
raises when it did not.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import math
import os
import subprocess
import tempfile

import numpy as np

from ..config import FilterType
from ..kernels._build import BUILD_DIR
from ..ops.filters import FILTERS

SOURCE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc", "srcnn_host.cpp")
CXX_FLAGS = ("-O3", "-fPIC", "-fopenmp", "-ffp-contract=off", "-std=c++17",
             "-shared")

#: why the last build failed ("" when it did not)
build_error = ""


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"srcnn_host-{digest.hexdigest()[:16]}.so")


def _build() -> str:
    """Build the library if it is missing; return its path."""
    path = library_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    # build to a temporary name, then rename: a concurrent build or an
    # interrupted one never leaves a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, SOURCE],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise RuntimeError(f"g++ failed for {SOURCE}:\n{proc.stderr}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)
    return path


@functools.lru_cache(maxsize=1)
def _lib():
    global build_error
    try:
        lib = ctypes.CDLL(_build())
    except (OSError, RuntimeError, subprocess.SubprocessError) as e:
        build_error = str(e)
        return None

    u8p = ctypes.POINTER(ctypes.c_uint8)
    f32p = ctypes.POINTER(ctypes.c_float)
    f64p = ctypes.POINTER(ctypes.c_double)
    i32p = ctypes.POINTER(ctypes.c_int32)

    lib.srcnn_rgb_to_ycbcr.argtypes = [u8p, f32p, ctypes.c_int64, ctypes.c_int32]
    lib.srcnn_rgb_to_ycbcr.restype = None
    lib.srcnn_ycbcr_to_rgb.argtypes = [f32p, u8p, ctypes.c_int64, ctypes.c_int32]
    lib.srcnn_ycbcr_to_rgb.restype = None
    lib.srcnn_contribution_table.argtypes = [
        ctypes.c_int32, ctypes.c_int64, ctypes.c_int64, i32p, f64p]
    lib.srcnn_contribution_table.restype = ctypes.c_int32
    lib.srcnn_ring_create.argtypes = [ctypes.c_int64, ctypes.c_int32]
    lib.srcnn_ring_create.restype = ctypes.c_void_p
    lib.srcnn_ring_destroy.argtypes = [ctypes.c_void_p]
    lib.srcnn_ring_destroy.restype = None
    lib.srcnn_ring_push.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int64]
    lib.srcnn_ring_push.restype = ctypes.c_int32
    lib.srcnn_ring_pop.argtypes = [ctypes.c_void_p, u8p, ctypes.c_int64]
    lib.srcnn_ring_pop.restype = ctypes.c_int64
    lib.srcnn_ring_size.argtypes = [ctypes.c_void_p]
    lib.srcnn_ring_size.restype = ctypes.c_int32
    lib.srcnn_host_version.argtypes = []
    lib.srcnn_host_version.restype = ctypes.c_int32
    return lib


def available() -> bool:
    """True when the native library built (or was built) and loaded."""
    return _lib() is not None


def _require_lib():
    lib = _lib()
    if lib is None:
        raise RuntimeError(
            f"native host library unavailable (building {SOURCE} with g++ "
            f"failed): {build_error}; use the torch ops in ops.color / "
            f"ops.weights_table instead")
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def rgb_to_ycbcr(img: np.ndarray) -> np.ndarray:
    """u8 [H,W,D] -> f32 planar [D,H,W], native OpenMP path."""
    lib = _require_lib()
    h, w, d = img.shape
    if d not in (3, 4):
        raise ValueError(f"expected [H,W,3|4], got {img.shape}")
    img = np.ascontiguousarray(img, dtype=np.uint8)
    out = np.empty((d, h, w), dtype=np.float32)
    lib.srcnn_rgb_to_ycbcr(_ptr(img, ctypes.c_uint8), _ptr(out, ctypes.c_float),
                           h * w, d)
    return out


def ycbcr_to_rgb(planes: np.ndarray) -> np.ndarray:
    """f32 planar [D,H,W] -> u8 [H,W,D], native OpenMP path."""
    lib = _require_lib()
    d, h, w = planes.shape
    if d not in (3, 4):
        raise ValueError(f"expected [3|4,H,W], got {planes.shape}")
    planes = np.ascontiguousarray(planes, dtype=np.float32)
    out = np.empty((h, w, d), dtype=np.uint8)
    lib.srcnn_ycbcr_to_rgb(_ptr(planes, ctypes.c_float), _ptr(out, ctypes.c_uint8),
                           h * w, d)
    return out


def contribution_table(filter_type: int, dst_size: int, src_size: int):
    """Native double-precision contribution table; same contract as
    :func:`libsrcnn_tpu_torch.ops.weights_table.contribution_table`."""
    lib = _require_lib()
    # the support width from ops.filters: the buffer sized here is written
    # by the native side BEFORE the window check below, so a drifted
    # width would corrupt the heap, not fail the check
    fw = FILTERS[FilterType(int(filter_type))][1]
    scale = dst_size / src_size
    width = fw / scale if scale < 1.0 else fw
    window = 2 * int(math.ceil(width)) + 1
    left = np.empty((dst_size,), dtype=np.int32)
    weights = np.zeros((dst_size, window), dtype=np.float64)
    got = lib.srcnn_contribution_table(int(filter_type), dst_size, src_size,
                                       _ptr(left, ctypes.c_int32),
                                       _ptr(weights, ctypes.c_double))
    if got != window:
        raise RuntimeError(f"native contribution table window {got}, expected {window}")
    return left, weights


class FrameRing:
    """Lock-free SPSC frame queue backed by the native library; feeds raw
    frames from a producer thread to the device loop
    (``serve.VideoUpscaler.stream_from_ring``)."""

    def __init__(self, frame_bytes: int, nslots: int = 8):
        if frame_bytes <= 0 or nslots <= 0:
            # the native ring indexes slots modulo nslots
            raise ValueError(f"FrameRing needs frame_bytes > 0 and nslots > 0, "
                             f"got {frame_bytes}, {nslots}")
        lib = _lib()
        if lib is None:
            raise RuntimeError(f"native library unavailable: {build_error}")
        self._lib = lib
        self._cap = int(frame_bytes)
        self._ptr = lib.srcnn_ring_create(self._cap, int(nslots))

    def push(self, frame: np.ndarray) -> bool:
        """Copy ``frame`` into the ring; False when it is full or the frame
        is larger than a slot."""
        frame = np.ascontiguousarray(frame, dtype=np.uint8)
        return bool(self._lib.srcnn_ring_push(self._ptr, _ptr(frame, ctypes.c_uint8),
                                              frame.nbytes))

    def pop(self) -> np.ndarray | None:
        """The oldest frame's bytes (flat u8), or None when the ring is empty."""
        out = np.empty((self._cap,), dtype=np.uint8)
        n = self._lib.srcnn_ring_pop(self._ptr, _ptr(out, ctypes.c_uint8), self._cap)
        if n <= 0:
            return None
        return out[:n]

    def __len__(self) -> int:
        return int(self._lib.srcnn_ring_size(self._ptr))

    def close(self) -> None:
        if self._ptr:
            self._lib.srcnn_ring_destroy(self._ptr)
            self._ptr = None

    def __del__(self):  # noqa: D105
        try:
            self.close()
        except Exception:
            pass

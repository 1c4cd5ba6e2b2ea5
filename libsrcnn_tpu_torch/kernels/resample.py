"""The band-resample kernel: one axis of the classical resize on the card.

:mod:`..ops.resize` resizes each axis of ``[..., H, W]`` f32 planes with
per-tap tables (``idx``, ``w``: ``[K, out]``).  On a CUDA tensor it calls
:func:`resample`, which applies every tap of one axis in one launch of
``csrc/resample.cu`` (``band_resample_rows`` for axis 0,
``band_resample_cols`` for axis 1) and writes only the resized planes.
The kernel computes what the plain version computes, bit for bit: the
plain version is ``ops.resize``'s own torch code (one ``index_select``,
multiply and add per tap), which a CPU tensor takes.  It replaces no TPU
kernel; the note at the top of the ``.cu`` file says why it exists and
what bounds it.

A CUDA tensor that the kernel does not take (another dtype, one that
needs a gradient) raises: nothing falls back to the torch ops.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ..utils.profiling import counts

#: the kernel's library (``csrc/resample.cu``, :mod:`._build`)
LIBRARY = "resample"
#: launches made by :func:`resample` in this process; kept out of
#: ``fused_conv.launches_by`` (``utils.profiling.counts_snapshot`` shows it
#: as ``kernels.launch.resample``)
launches = 0

_INT_MAX = 2 ** 31 - 1


def check_args(plane: torch.Tensor, idx: torch.Tensor, w: torch.Tensor | None,
               axis: int) -> None:
    """Raise on what the kernel does not take: ``plane`` must be float32
    ``[..., H, W]`` needing no gradient; ``idx`` int32 ``[K, out]`` and
    ``w`` float32 ``[K, out]`` or None (a copy, K = 1), contiguous, on the
    plane's device; ``axis`` 0 (rows) or 1 (columns).  The indices must lie
    in the resized axis's source range; the tables of ``ops.resize`` do,
    and this check reads no device memory."""
    if axis not in (0, 1):
        raise ValueError(f"axis must be 0 (rows) or 1 (columns), got {axis!r}")
    if plane.dtype != torch.float32:
        raise TypeError(f"the resample kernel takes float32 planes, got {plane.dtype}")
    if plane.requires_grad:
        raise ValueError("the resample kernel has no backward: resize a plane "
                         "that needs no gradient")
    if plane.dim() < 2 or min(plane.shape[-2:]) < 1:
        raise ValueError(f"planes must be [..., H, W] with H, W >= 1, got "
                         f"{list(plane.shape)}")
    if idx.dtype != torch.int32 or idx.dim() != 2:
        raise ValueError(f"idx must be int32 [K, out], got {idx.dtype} "
                         f"{list(idx.shape)}")
    if w is None:
        if idx.shape[0] != 1:
            raise ValueError(f"a copy (no weights) takes one tap, got {idx.shape[0]}")
    elif w.dtype != torch.float32 or w.shape != idx.shape:
        raise ValueError(f"w must be float32 {list(idx.shape)} like idx, got "
                         f"{w.dtype} {list(w.shape)}")
    for name, t in (("idx", idx), ("w", w)):
        if t is not None and (t.device != plane.device or not t.is_contiguous()):
            raise ValueError(f"{name} must be contiguous on {plane.device}")
    if max(*plane.shape[-2:], idx.shape[1], math.prod(plane.shape[:-2])) > _INT_MAX:
        raise ValueError(f"planes of {list(plane.shape)} to {idx.shape[1]} "
                         f"entries exceed the kernel's 32-bit sizes")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared.  Its load counts
    one ``kernels.libs_loaded``."""
    from . import _build

    lib = _build.load(LIBRARY)
    counts["kernels.libs_loaded"] += 1
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.resample_rows.argtypes = [ptr] * 4 + [i32] * 5 + [ptr]
    lib.resample_cols.argtypes = ([ptr] * 4 + [i32, ctypes.c_longlong, i32, i32]
                                  + [ptr])
    lib.resample_rows.restype = lib.resample_cols.restype = i32
    return lib


def resample(plane: torch.Tensor, idx: torch.Tensor, w: torch.Tensor | None,
             axis: int) -> torch.Tensor:
    """Resize ``axis`` (0: dim -2, 1: dim -1) of CUDA ``[..., H, W]`` f32
    planes with the tables ``idx`` / ``w`` (:func:`check_args`): entry ``o``
    of the new axis is ``sum_k plane[.., idx[k, o], ..] * w[k, o]`` in
    ascending ``k``, or the copy ``plane[.., idx[0, o], ..]`` when ``w`` is
    None.  One launch on the current stream; adds one to
    :data:`launches`."""
    global launches
    check_args(plane, idx, w, axis)
    if plane.device.type != "cuda":
        raise ValueError(f"the resample kernel takes CUDA tensors, got "
                         f"{plane.device}; ops.resize runs the plain version "
                         f"on the CPU")
    plane = plane.contiguous()
    h, wd = plane.shape[-2:]
    out_n = idx.shape[1]
    shape = plane.shape[:-2] + ((out_n, wd) if axis == 0 else (h, out_n))
    out = torch.empty(shape, dtype=torch.float32, device=plane.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    stream = torch.cuda.current_stream(plane.device).cuda_stream
    w_ptr = None if w is None else w.data_ptr()
    with torch.cuda.device(plane.device):
        if axis == 0:
            err = lib.resample_rows(plane.data_ptr(), out.data_ptr(), idx.data_ptr(),
                                    w_ptr, idx.shape[0], math.prod(plane.shape[:-2]),
                                    h, out_n, wd, stream)
        else:
            err = lib.resample_cols(plane.data_ptr(), out.data_ptr(), idx.data_ptr(),
                                    w_ptr, idx.shape[0], plane.numel() // wd, wd,
                                    out_n, stream)
    if err != 0:
        raise RuntimeError(f"band_resample launch failed: cudaError {err}")
    launches += 1
    return out

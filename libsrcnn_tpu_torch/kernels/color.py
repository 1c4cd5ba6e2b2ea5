"""The color kernels: both directions of :mod:`..ops.color` on the card.

:mod:`..ops.color` converts interleaved u8 RGB(A) to planar f32 YCbCr(+A)
before the resize, and the model's Y with the resized chroma back to u8
RGB(A) and the conv map after it.  On a CUDA tensor it calls
:func:`split` and :func:`merge`, one launch each of ``csrc/color.cu``
(``color_split``, ``color_merge``).  The kernels compute what the plain
version computes, bit for bit: the plain version is ``ops.color``'s own
torch code, which a CPU tensor takes.  They replace no TPU kernel; the
note at the top of the ``.cu`` file says why they exist and what bounds
them.

A CUDA tensor that a kernel does not take (another dtype, one that needs
a gradient) raises: nothing falls back to the torch ops.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..utils.profiling import counts

#: the kernels' library (``csrc/color.cu``, :mod:`._build`)
LIBRARY = "color"
#: launches made by :func:`split` and :func:`merge` in this process; kept
#: out of ``fused_conv.launches_by`` (``utils.profiling.counts_snapshot``
#: shows it as ``kernels.launch.color``)
launches = 0

_INT_MAX = 2 ** 31 - 1


def check_split_args(rgb: torch.Tensor) -> None:
    """Raise on what ``color_split`` does not take: ``rgb`` must be uint8
    ``[..., D]`` with D 3 or 4 and at most 2**31 - 1 pixels."""
    if rgb.dtype != torch.uint8:
        raise TypeError(f"the color split takes uint8 pixels, got {rgb.dtype}")
    if rgb.dim() < 1 or rgb.shape[-1] not in (3, 4):
        raise ValueError(f"pixels must be [..., D] with D 3 or 4, got {list(rgb.shape)}")
    if rgb.numel() // rgb.shape[-1] > _INT_MAX:
        raise ValueError(f"{list(rgb.shape)} exceeds the kernel's 32-bit pixel count")


def check_merge_args(y: torch.Tensor, rest) -> None:
    """Raise on what ``color_merge`` does not take: ``y`` and the 2 or 3
    planes of ``rest`` (Cb, Cr and an alpha plane, if any) must be float32
    of one shape on one device, need no gradient, and hold at most
    2**31 - 1 pixels."""
    planes = [y, *rest]
    if len(planes) not in (3, 4):
        raise ValueError(f"the color merge takes 3 or 4 planes, got {len(planes)}")
    for p in planes:
        if p.dtype != torch.float32:
            raise TypeError(f"the color merge takes float32 planes, got {p.dtype}")
        if p.requires_grad:
            raise ValueError("the color merge has no backward: merge planes that "
                             "need no gradient")
        if p.shape != y.shape or p.device != y.device:
            raise ValueError(f"every plane must be {list(y.shape)} on {y.device}, "
                             f"got {list(p.shape)} on {p.device}")
    if y.numel() > _INT_MAX:
        raise ValueError(f"{list(y.shape)} exceeds the kernel's 32-bit pixel count")


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    """The built library with its C signatures declared.  Its load counts
    one ``kernels.libs_loaded``."""
    from . import _build

    lib = _build.load(LIBRARY)
    counts["kernels.libs_loaded"] += 1
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.color_split_launch.argtypes = [ptr, ptr, i32, i32, ptr]
    lib.color_merge_launch.argtypes = [ptr] * 6 + [i32, i32, ptr]
    lib.color_split_launch.restype = lib.color_merge_launch.restype = i32
    return lib


def _require_cuda(t: torch.Tensor) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the color kernels take CUDA tensors, got {t.device}; "
                         f"ops.color runs the plain version on the CPU")


def _launched(err: int, what: str) -> None:
    global launches
    if err != 0:
        raise RuntimeError(f"{what} launch failed: cudaError {err}")
    launches += 1


def split(rgb: torch.Tensor) -> torch.Tensor:
    """CUDA ``[..., D]`` u8 RGB(A) -> ``[D, ...]`` f32 YCbCr(+A)
    (:func:`check_split_args`), as ``ops.color.rgb_to_ycbcr``.  One launch
    on the current stream; adds one to :data:`launches`."""
    check_split_args(rgb)
    _require_cuda(rgb)
    d = rgb.shape[-1]
    rgb = rgb.contiguous()
    out = torch.empty((d, *rgb.shape[:-1]), dtype=torch.float32, device=rgb.device)
    if out.numel() == 0:
        return out
    stream = torch.cuda.current_stream(rgb.device).cuda_stream
    with torch.cuda.device(rgb.device):
        err = _lib().color_split_launch(rgb.data_ptr(), out.data_ptr(),
                                        rgb.numel() // d, d, stream)
    _launched(err, "color_split")
    return out


def merge(y: torch.Tensor, rest) -> tuple[torch.Tensor, torch.Tensor]:
    """CUDA f32 planes ``y`` and ``rest`` (Cb, Cr and an alpha plane, if
    any; :func:`check_merge_args`) -> (``[..., D]`` u8 RGB(A), ``[...]``
    u8 conv map), as ``ops.color.merge``.  One launch on the current
    stream; adds one to :data:`launches`."""
    check_merge_args(y, rest)
    _require_cuda(y)
    planes = [p.contiguous() for p in (y, *rest)]
    d = len(planes)
    out = torch.empty((*y.shape, d), dtype=torch.uint8, device=y.device)
    conv = torch.empty(y.shape, dtype=torch.uint8, device=y.device)
    if conv.numel() == 0:
        return out, conv
    ptrs = [p.data_ptr() for p in planes] + ([None] if d == 3 else [])
    stream = torch.cuda.current_stream(y.device).cuda_stream
    with torch.cuda.device(y.device):
        err = _lib().color_merge_launch(*ptrs, out.data_ptr(), conv.data_ptr(),
                                        y.numel(), d, stream)
    _launched(err, "color_merge")
    return out, conv

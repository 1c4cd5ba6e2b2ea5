"""Fully-fused SRCNN 9-1-5 forward: the hand-written CUDA kernel
(``csrc/fused_srcnn.cu``) and its plain PyTorch version.

Port of the exact tier of ``libsrcnn_tpu/kernels/fused_conv.py`` (``_kernel``
at ``precision=HIGHEST``, reached through ``_fused`` / ``forward_y``).  The
TPU kernel's tile geometry (TW=124 columns, 384-lane windows, the im2col
scratch, lane rolls) follows Mosaic's layout rules and is not carried over;
the CUDA kernel keeps what it computes and what it keeps out of device
memory (see the note at the top of the ``.cu`` file).

Interface, for the pipeline and for banded / sharded callers alike:

* ``y_padded`` is the Y plane with a 6 px halo, ``[h+12, w+12]`` f32.  The
  pipeline has the resize emit it directly (``resize_plane_padded``).
* ``edge_flags`` ``(top, bottom, left, right)`` say which borders are true
  image edges.  There conv3 reads conv2's output clamped to the image
  (`libsrcnn.cpp:463-489`); at a 0 flag it reads the c2 computed over the
  real halo pixels.  ``None`` means all four are edges.

A CUDA tensor always goes to the kernel; a CPU tensor goes to the plain
version, :func:`forward_y_reference`.  Nothing falls back from one to the
other.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..models import srcnn

HALO = 6          # 4 (conv1) + 2 (conv3) each side

#: kernel launches made by :func:`forward_y` in this process
launches = 0


def pack_params(params: dict) -> torch.Tensor:
    """OIHW params -> the kernel's flat f32 layout (``fused_srcnn.cu``):
    w1 [81,64] (tap k = 9*dy + dx), b1 [64], w2 [64,32], b2 [32],
    w3 [25,32] (tap k = 5*dy + dx), b3 [1]; 8,129 floats."""
    parts = [
        params["w1"].reshape(64, 81).t(),
        params["b1"],
        params["w2"].reshape(32, 64).t(),
        params["b2"],
        params["w3"].reshape(32, 25).t(),
        params["b3"],
    ]
    return torch.cat([p.reshape(-1).to(torch.float32) for p in parts])


def _flags(edge_flags) -> tuple[int, int, int, int]:
    if edge_flags is None:
        return (1, 1, 1, 1)
    flags = tuple(int(f) for f in edge_flags)
    if len(flags) != 4 or any(f not in (0, 1) for f in flags):
        raise ValueError(f"edge_flags must be 4 values in {{0, 1}}, got {edge_flags!r}")
    return flags


def _check_plane(y_padded: torch.Tensor, h: int, w: int) -> None:
    if h < 1 or w < 1:
        raise ValueError(f"output size must be positive, got {h}x{w}")
    if y_padded.dtype != torch.float32:
        raise TypeError(f"y_padded must be float32, got {y_padded.dtype}")
    if tuple(y_padded.shape) != (h + 2 * HALO, w + 2 * HALO):
        raise ValueError(f"y_padded must be [h+12, w+12] = "
                         f"[{h + 2 * HALO}, {w + 2 * HALO}], got "
                         f"{list(y_padded.shape)}")


def _ring_index(n: int, lo_edge: int, hi_edge: int, device) -> torch.Tensor:
    """Indices into a c2 axis of n+4 entries (global -2 .. n+1) that clamp
    the ring to the image at a true edge and keep it elsewhere."""
    g = torch.arange(-2, n + 2, device=device)
    return g.clamp(0 if lo_edge else -2, n - 1 if hi_edge else n + 1) + 2


def forward_y_reference(params: dict, y_padded: torch.Tensor, h: int, w: int,
                        edge_flags=None) -> torch.Tensor:
    """Plain PyTorch version of :func:`forward_y` (same signature): the
    ``models/srcnn`` convs on the halo plane, with the ring clamp as an
    index gather.  With all flags set and a replicate halo it equals
    ``srcnn.forward_y`` on the inner plane."""
    _check_plane(y_padded, h, w)
    top, bottom, left, right = _flags(edge_flags)
    dev = y_padded.device
    with srcnn.exact_f32(dev):
        c2 = srcnn.conv12(params, y_padded[None, None])   # [1,32,h+4,w+4]
        c2 = c2.index_select(2, _ring_index(h, top, bottom, dev))
        c2 = c2.index_select(3, _ring_index(w, left, right, dev))
        return srcnn.conv3(params, c2)[0]


@functools.lru_cache(maxsize=1)
def _lib() -> ctypes.CDLL:
    """The built kernel library, with its C signatures declared."""
    from . import _build

    lib = _build.load("fused_srcnn")
    lib.srcnn_fused_n_params.restype = ctypes.c_int
    lib.srcnn_fused_n_params.argtypes = []
    lib.srcnn_fused_max_rows.restype = ctypes.c_int
    lib.srcnn_fused_max_rows.argtypes = []
    lib.srcnn_fused_forward.restype = ctypes.c_int
    lib.srcnn_fused_forward.argtypes = (
        [ctypes.c_void_p] * 3 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    return lib


def forward_y(params: dict, y_padded: torch.Tensor, h: int, w: int,
              edge_flags=None) -> torch.Tensor:
    """Fused conv stack on a halo plane ``[h+12, w+12]`` f32 -> ``[h, w]``.

    On a CUDA tensor this launches the CUDA kernel (built at first use) on
    the current stream and adds one to :data:`launches`; on a CPU tensor it
    runs :func:`forward_y_reference`.  Any other device raises."""
    global launches
    _check_plane(y_padded, h, w)
    flags = _flags(edge_flags)
    dev = y_padded.device
    if dev.type == "cpu":
        return forward_y_reference(params, y_padded, h, w, flags)
    if dev.type != "cuda":
        raise ValueError(f"fused_conv.forward_y takes CPU or CUDA tensors, "
                         f"got {dev}")
    if not y_padded.is_contiguous():
        raise ValueError("y_padded must be contiguous")
    packed = pack_params(params).to(dev).contiguous()
    lib = _lib()
    if packed.numel() != lib.srcnn_fused_n_params():
        raise ValueError(f"packed params hold {packed.numel()} floats, the "
                         f"kernel takes {lib.srcnn_fused_n_params()}")
    if h > lib.srcnn_fused_max_rows():
        raise ValueError(f"h={h} exceeds the kernel's grid limit of "
                         f"{lib.srcnn_fused_max_rows()} rows")
    out = torch.empty((h, w), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        err = lib.srcnn_fused_forward(
            y_padded.data_ptr(), out.data_ptr(), packed.data_ptr(), h, w,
            *flags,
            torch.cuda.current_stream(dev).cuda_stream)
    if err != 0:
        raise RuntimeError(f"fused_srcnn launch failed: cudaError {err}")
    launches += 1
    return out

"""Plain reference of what the benchmark's cells compute, in PyTorch and
NumPy alone.

It imports nothing of the program under test: the resize tables, the
color transforms and the convs are written out here, and each model in a
file of its own beside it (``reference/<model>.py``), from their
published descriptions (FreeImage's separable resampler; JPEG full-range
YCbCr with libsrcnn's rational inverse; the model's paper), and it is
handed the same frames and weights as the program.

One pass, for a u8 RGB clip ``[N, H, W, 3]`` at factor ``scale``:

1. RGB -> planar f32 Y, Cb, Cr (JPEG full-range coefficients);
2. Y resized with Mitchell-Netravali bicubic (b = c = 1/3), Cb and Cr with
   bilinear, each axis by a contribution table built here in float64 and
   applied in f32, tap by tap in ascending order;
3. the model's Y path, ``reference/<model>.py``'s ``y_path(params, y,
   dst_h, dst_w, precision)`` (the model's own resize of the Y plane
   included, so that a model that runs on the input's size fits too), in
   f32 with TF32 off (``precision="f32"``), on bf16-rounded operands
   (``"bf16"``: the input plane, every weight and every activation a
   conv reads, with f32 sums), or with TF32 allowed (``"tf32"``, the
   control; on the CPU its operand rounding is emulated), through
   :func:`conv`;
4. the conv map is the floor of the model's plane as u8; RGB is the
   rational inverse 45/32, 11/32, 23/32, 113/64, clamped and truncated.

The planes go through the model one frame at a time, so that a clip of
4K frames fits beside the program's state.
"""

from __future__ import annotations

import contextlib
import importlib
import math

import numpy as np
import torch
import torch.nn.functional as F

PRECISIONS = ("f32", "bf16", "tf32")


# --- resize -----------------------------------------------------------------

def _bicubic(x: np.ndarray) -> np.ndarray:
    """Mitchell-Netravali with b = c = 1/3, support 2."""
    b = c = 1.0 / 3.0
    x = np.abs(x)
    inner = ((12 - 9 * b - 6 * c) * x ** 3 + (-18 + 12 * b + 6 * c) * x ** 2
             + (6 - 2 * b)) / 6.0
    outer = ((-b - 6 * c) * x ** 3 + (6 * b + 30 * c) * x ** 2
             + (-12 * b - 48 * c) * x + (8 * b + 24 * c)) / 6.0
    return np.where(x < 1.0, inner, np.where(x < 2.0, outer, 0.0))


def _bilinear(x: np.ndarray) -> np.ndarray:
    x = np.abs(x)
    return np.where(x < 1.0, 1.0 - x, 0.0)


FILTERS = {"bicubic": (_bicubic, 2.0), "bilinear": (_bilinear, 1.0)}


def contribution_table(kind: str, dst: int, src: int):
    """FreeImage's resampling weights in float64: for each output
    coordinate the leftmost source index and a window of ``2 ceil(width) +
    1`` normalised weights (zero past the right edge).  A downscale widens
    the support by ``src / dst``.  Where the clamped window holds more
    taps than it has room for, the left edge moves one to the right, as
    FreeImage's test (``left < size - 1 / 2`` in integers) always does."""
    filt, support = FILTERS[kind]
    scale = dst / src
    width, fscale = (support / scale, scale) if scale < 1.0 else (support, 1.0)
    window = 2 * int(math.ceil(width)) + 1
    left = np.zeros(dst, np.int64)
    weights = np.zeros((dst, window), np.float64)
    for u in range(dst):
        center = u / scale + 0.5 / scale - 0.5
        lo = max(0, int(math.floor(center - width)))
        hi = min(int(math.ceil(center + width)), src - 1)
        if hi - lo + 1 > window:
            lo += 1
        w = fscale * filt(fscale * (center - np.arange(lo, hi + 1, dtype=np.float64)))
        total = w.sum()
        if total > 0.0 and total != 1.0:
            w = w / total
        left[u] = lo
        weights[u, :w.size] = w
    return left, weights


def resize_axis(planes: torch.Tensor, dst: int, kind: str, dim: int) -> torch.Tensor:
    """Resize ``dim`` of f32 ``planes`` to ``dst`` entries: for each tap
    of the window whose weights are not all zero, gather the source line
    and add its product with the tap's f32 weight."""
    src = planes.shape[dim]
    if dst == src:
        return planes
    left, weights = contribution_table(kind, dst, src)
    shape = [1] * planes.dim()
    shape[dim] = dst
    acc = None
    for k in range(weights.shape[1]):
        if not weights[:, k].any():
            continue
        idx = torch.from_numpy(np.clip(left + k, 0, src - 1)).to(planes.device)
        wk = torch.from_numpy(weights[:, k].astype(np.float32)).to(planes.device)
        term = planes.index_select(dim, idx) * wk.reshape(shape)
        acc = term if acc is None else acc + term
    return acc


def resize(planes: torch.Tensor, dst_h: int, dst_w: int, kind: str) -> torch.Tensor:
    """Resize ``[..., H, W]`` f32 planes: rows first where the width
    grows, columns first otherwise (FreeImage's order)."""
    if dst_w > planes.shape[-1]:
        return resize_axis(resize_axis(planes, dst_h, kind, -2), dst_w, kind, -1)
    return resize_axis(resize_axis(planes, dst_w, kind, -1), dst_h, kind, -2)


def scaled_size(h: int, w: int, scale: float) -> tuple[int, int]:
    """Output (h, w): each side times ``scale`` in float32, truncated."""
    return (int(np.float32(h) * np.float32(scale)),
            int(np.float32(w) * np.float32(scale)))


# --- color ------------------------------------------------------------------

def rgb_to_ycbcr(rgb: torch.Tensor) -> torch.Tensor:
    """u8 ``[..., 3]`` -> f32 ``[3, ...]`` Y, Cb, Cr (JPEG full range)."""
    f = rgb.to(torch.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    return torch.stack([0.299 * r + 0.587 * g + 0.114 * b,
                        128.0 - 0.1687 * r - 0.3313 * g + 0.5 * b,
                        128.0 + 0.5 * r - 0.4187 * g - 0.0813 * b])


def to_u8(x: torch.Tensor) -> torch.Tensor:
    """Clamp to [0, 255] and truncate."""
    return torch.floor(torch.clamp(x, 0.0, 255.0)).to(torch.uint8)


def ycbcr_to_rgb(y: torch.Tensor, cb: torch.Tensor, cr: torch.Tensor) -> torch.Tensor:
    """f32 planes -> u8 ``[..., 3]`` by libsrcnn's rational inverse."""
    cb, cr = cb - 128.0, cr - 128.0
    return torch.stack([to_u8(y + 45.0 * cr / 32.0),
                        to_u8(y - (11.0 * cb + 23.0 * cr) / 32.0),
                        to_u8(y + 113.0 * cb / 64.0)], dim=-1)


# --- convs -----------------------------------------------------------------

def round_bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).to(torch.float32)


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """f32 rounded to TF32's 10 mantissa bits, nearest, ties away from
    zero (what the tensor cores' f32 -> tf32 conversion does)."""
    bits = t.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


@contextlib.contextmanager
def precision_context(device: torch.device, precision: str):
    """cuDNN and cuBLAS with TF32 allowed only for ``"tf32"``, cuDNN's
    autotuner off; nothing to set on the CPU."""
    if device.type != "cuda":
        yield
        return
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = precision == "tf32"
    try:
        with torch.backends.cudnn.flags(enabled=True, benchmark=False,
                                        deterministic=True,
                                        allow_tf32=precision == "tf32"):
            yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, pad: int,
         precision: str) -> torch.Tensor:
    """Replicate-pad by ``pad``, then a valid conv plus bias, with the
    operands rounded as ``precision`` says."""
    if pad:
        x = F.pad(x, (pad, pad, pad, pad), mode="replicate")
    if precision == "bf16":
        x, w = round_bf16(x), round_bf16(w)
    elif precision == "tf32" and x.device.type != "cuda":
        x, w = round_tf32(x), round_tf32(w)
    return F.conv2d(x, w) + b.reshape(1, -1, 1, 1)


def upscale(frames: torch.Tensor, model: str, params: dict, scale: float,
            precision: str = "f32"):
    """u8 ``[N, H, W, 3]`` -> (u8 ``[N, H', W', 3]``, u8 conv map ``[N, H', W']``),
    one frame at a time."""
    if precision not in PRECISIONS:
        raise ValueError(f"precision must be one of {PRECISIONS}, got {precision!r}")
    y_path = importlib.import_module(f"{__package__}.{model}").y_path
    h, w = frames.shape[1:3]
    dst_h, dst_w = scaled_size(h, w, scale)
    outs, convs = [], []
    for frame in frames:
        y, cb, cr = rgb_to_ycbcr(frame[None])
        y_sr = y_path(params, y, dst_h, dst_w, precision)
        cb = resize(cb, dst_h, dst_w, "bilinear")
        cr = resize(cr, dst_h, dst_w, "bilinear")
        outs.append(ycbcr_to_rgb(y_sr, cb, cr)[0])
        convs.append(torch.floor(y_sr).to(torch.uint8)[0])
    return torch.stack(outs), torch.stack(convs)

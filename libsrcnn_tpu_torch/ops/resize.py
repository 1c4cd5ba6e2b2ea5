"""Separable classical resize (PyTorch port of ``libsrcnn_tpu/ops/resize.py``).

Replica of `FRAWResizeEngine::scale` (`frawscale.cpp:162-286`).  The
per-axis contribution tables are precomputed host-side in float64
(:mod:`.weights_table`); the device applies them as a fixed-width band
gather: for each of the K window taps, one ``index_select`` of the shifted
source rows / columns and one multiply-add ``acc + src[left+k] * w_k``, in
ascending tap order.  The multiply and the add stay two ops (no fused
multiply-add), so the f32 result is the JAX op's bit for bit.

Pass ordering matches the reference (`frawscale.cpp:195-278`): upscale in
width runs the vertical pass first then horizontal; downscale-or-equal width
runs horizontal first.  Same-size resize is an exact copy (the reference's
same-size half-buffer copy bug, `frawscale.cpp:185-193`, is deliberately
not reproduced).

The index and weight tensors of one (filter, dst, src, pad, out, device)
are built once and cached as ``[K, out]`` (:func:`_band_stack`); they are
a few KB per axis.  Planes may carry leading batch dimensions
(``[..., H, W]``): every op is elementwise along them, so a batch resizes
bit for bit like its planes one at a time.

That is the plain version, which a CPU tensor takes.  A CUDA tensor takes
the band-resample kernel (:mod:`..kernels.resample`): one launch per axis
applies the same taps in the same order with the same roundings, from the
same tables, so the card's result is the plain version's bit for bit.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import FilterType
from ..kernels import resample
from ..utils.profiling import counts
from .weights_table import contribution_table


def _band_table(filter_type: FilterType, dst: int, src: int, pad_lo: int,
                out: int) -> tuple[np.ndarray, np.ndarray]:
    """One axis's tables as host arrays: clipped source indices [out, K]
    int64 and weights [out, K] f32, K the taps kept.

    ``out`` rows: ``pad_lo`` copies of the first output row's table entry,
    the ``dst`` real rows, then copies of the last row's entry -- so the
    padding is bit-identical to replicate-padding the resized plane.  Taps
    whose weight column is all zero are dropped (`resize.py:46-47` of the
    JAX op), which keeps the accumulation order of the JAX op.
    """
    left, weights = contribution_table(filter_type, dst, src)
    window = weights.shape[1]
    # clipped gather indices per tap; weights past the right boundary are
    # zero so clipping is value-safe
    idx = np.clip(left[:, None] + np.arange(window)[None, :], 0, src - 1)
    w = weights.astype(np.float32)
    pad_hi = out - pad_lo - dst
    idx = np.concatenate([np.repeat(idx[:1], pad_lo, 0), idx,
                          np.repeat(idx[-1:], pad_hi, 0)])
    w = np.concatenate([np.repeat(w[:1], pad_lo, 0), w,
                        np.repeat(w[-1:], pad_hi, 0)])
    keep = [k for k in range(window) if np.any(w[:, k])]
    return idx[:, keep].astype(np.int64), w[:, keep]


@functools.lru_cache(maxsize=256)
def _band_stack(filter_type: FilterType | None, dst: int, src: int, pad_lo: int,
                out: int, device: torch.device):
    """One axis's tables on ``device``, as both versions read them: index
    [K, out] int32 and weight [K, out] f32, tap k of :func:`_band_table`
    in row k.  ``filter_type`` None is a same-size axis: the clamped
    identity gather as index [1, out] and weight None (a copy).  Each
    build (a cache miss) counts one ``resize.tables_built``."""
    counts["resize.tables_built"] += 1
    if filter_type is None:
        idx = np.clip(np.arange(out) - pad_lo, 0, src - 1)[None]
        return torch.from_numpy(idx.astype(np.int32)).to(device), None
    idx, w = _band_table(filter_type, dst, src, pad_lo, out)
    return (torch.from_numpy(np.ascontiguousarray(idx.T, np.int32)).to(device),
            torch.from_numpy(np.ascontiguousarray(w.T)).to(device))


def _resize_axis(plane: torch.Tensor, dst: int, filter_type: FilterType,
                 axis: int, pad_lo: int = 0, out: int | None = None) -> torch.Tensor:
    """Resize one axis (0: rows, 1: columns) of [..., H, W] planes to
    ``dst`` entries, emitted with ``pad_lo`` replicate entries before them
    and replicate padding up to ``out`` entries in all (``out=None``: no
    padding)."""
    dim = axis - 2
    src = plane.shape[dim]
    if out is None:
        if dst == src:
            return plane
        out = dst
    ft = None if dst == src else FilterType(filter_type)
    idx, w = _band_stack(ft, dst, src, pad_lo, out, plane.device)
    if plane.device.type == "cuda":
        return resample.resample(plane, idx, w, axis)
    return _plain_axis(plane, idx, w, axis)


def _plain_axis(plane: torch.Tensor, idx: torch.Tensor, w: torch.Tensor | None,
                axis: int) -> torch.Tensor:
    """The plain version of one axis on the tables of :func:`_band_stack`:
    one ``index_select``, multiply and add per tap, in ascending tap order,
    the sum started from the first term.  Any device; ``_resize_axis``
    sends it a CPU plane."""
    dim = axis - 2
    if w is None:
        # same-size axis: identity gather with clamped indices
        return plane.index_select(dim, idx[0])
    acc = None
    for k in range(idx.shape[0]):
        wk = w[k][:, None] if axis == 0 else w[k][None, :]
        term = plane.index_select(dim, idx[k]) * wk
        acc = term if acc is None else acc + term
    if acc is None:  # degenerate: all-zero table (cannot happen in practice)
        shape = list(plane.shape)
        shape[dim] = idx.shape[1]
        acc = plane.new_zeros(shape)
    return acc


def resize_plane(plane: torch.Tensor, dst_h: int, dst_w: int,
                 filter_type: FilterType) -> torch.Tensor:
    """Resize [..., H, W] float planes to [..., dst_h, dst_w].

    Mirrors the pass ordering of `FRAWResizeEngine::scale`
    (`frawscale.cpp:195-278`).
    """
    src_h, src_w = plane.shape[-2:]
    if dst_h == src_h and dst_w == src_w:
        return plane
    if dst_w <= src_w:
        # horizontal first, then vertical (`frawscale.cpp:195-237`)
        out = _resize_axis(plane, dst_w, filter_type, axis=1)
        return _resize_axis(out, dst_h, filter_type, axis=0)
    # vertical first, then horizontal (`frawscale.cpp:238-278`)
    out = _resize_axis(plane, dst_h, filter_type, axis=0)
    return _resize_axis(out, dst_w, filter_type, axis=1)


def resize_plane_padded(plane: torch.Tensor, dst_h: int, dst_w: int,
                        filter_type: FilterType, pad: int, out_h: int,
                        out_w: int) -> torch.Tensor:
    """Resize to [dst_h, dst_w] and emit an [out_h, out_w] plane with the
    result at offset (pad, pad), replicate-padded everywhere else.  Feeds
    the fused kernel its 6 px halo plane straight out of the resize
    gather, with no separate padding pass.  Same pass ordering as
    :func:`resize_plane`."""
    src_h, src_w = plane.shape[-2:]
    if dst_w <= src_w:
        out = _resize_axis(plane, dst_w, filter_type, 1, pad, out_w)
        return _resize_axis(out, dst_h, filter_type, 0, pad, out_h)
    out = _resize_axis(plane, dst_h, filter_type, 0, pad, out_h)
    return _resize_axis(out, dst_w, filter_type, 1, pad, out_w)


def scaled_size(w: int, h: int, multiply: float) -> tuple[int, int]:
    """Output size computation with the reference's float32 truncation
    (`libsrcnn.cpp:662-663`: ``unsigned rs_w = width * muliply`` in f32)."""
    rs_w = int(np.float32(w) * np.float32(multiply))
    rs_h = int(np.float32(h) * np.float32(multiply))
    return rs_w, rs_h

"""Color-space conversion ops (PyTorch port of ``libsrcnn_tpu/ops/color.py``).

Numerics replicate the reference exactly:

* RGB(A) u8 -> planar float YCbCr uses the JPEG full-range coefficients in
  float32 (`libsrcnn.cpp:250-264`).
* YCbCr -> RGB(A) u8 uses the reference's *rational-approximation* inverse
  45/32, 11/32, 23/32, 113/64 (`libsrcnn.cpp:293-295`), NOT the exact
  coefficients.
* :func:`ycbcr_to_rgb_exact` is the reference's unused exact-coefficient
  inverse (`libsrcnn.cpp:310-346`), kept for parity with the JAX op.
* u8 emission is MIN(255,.), MAX(0,.), then a C-style truncating cast
  (`libsrcnn.cpp:293-305`): the floor is taken explicitly, so the result
  does not depend on how torch casts float to uint8.

Each op is one torch expression per term, in the JAX op's order, so the
f32 results are bit-equal to the JAX package's on the CPU.  That torch
code is the plain version, which a CPU tensor takes.  A CUDA tensor goes
to the color kernels (:mod:`..kernels.color`): one launch for
:func:`rgb_to_ycbcr`, one for :func:`merge` (or :func:`ycbcr_to_rgb`),
bit-equal to the torch expressions on the same card.
"""

from __future__ import annotations

import torch

from ..kernels import color as color_kernel


def trunc_u8(x: torch.Tensor) -> torch.Tensor:
    """MIN(255) / MAX(0) / truncating cast, as the reference emits u8."""
    x = torch.clamp(torch.clamp(x, max=255.0), min=0.0)
    return torch.floor(x).to(torch.uint8)


def rgb_to_ycbcr(rgb_u8: torch.Tensor) -> torch.Tensor:
    """Interleaved u8 RGB(A) [H,W,D] -> planar float32 [D,H,W] YCbCr(+A).

    Mirrors `converImgU8toYCbCr` (`libsrcnn.cpp:233-272`).  D must be 3 or 4;
    the alpha plane (if any) is passed through as float.  A leading batch
    dimension gives [D,N,H,W].
    """
    if rgb_u8.device.type == "cuda":
        return color_kernel.split(rgb_u8)
    return plain_rgb_to_ycbcr(rgb_u8)


def plain_rgb_to_ycbcr(rgb_u8: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`rgb_to_ycbcr`: the torch expressions, on
    any device."""
    f = rgb_u8.to(torch.float32)
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    y = 0.299 * r + 0.587 * g + 0.114 * b
    cb = 128.0 - 0.1687 * r - 0.3313 * g + 0.5 * b
    cr = 128.0 + 0.5 * r - 0.4187 * g - 0.0813 * b
    planes = [y, cb, cr]
    if rgb_u8.shape[-1] == 4:
        planes.append(f[..., 3])
    return torch.stack(planes, dim=0)


def ycbcr_to_rgb(planes: torch.Tensor) -> torch.Tensor:
    """Planar float32 [D,H,W] YCbCr(+A) -> interleaved u8 [H,W,D].

    Mirrors `convertImgF32XtoImgU8` (`libsrcnn.cpp:274-308`): the
    rational-approx inverse with [0,255] clamp and truncating cast.  On the
    card this is :func:`merge` without its conv map.
    """
    if planes.device.type == "cuda":
        return color_kernel.merge(planes[0], list(planes[1:]))[0]
    return plain_ycbcr_to_rgb(planes)


def plain_ycbcr_to_rgb(planes: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`ycbcr_to_rgb`: the torch expressions, on
    any device."""
    y = planes[0]
    cb = planes[1] - 128.0
    cr = planes[2] - 128.0
    r = y + 45.0 * cr / 32.0
    g = y - (11.0 * cb + 23.0 * cr) / 32.0
    b = y + 113.0 * cb / 64.0
    chans = [trunc_u8(r), trunc_u8(g), trunc_u8(b)]
    if planes.shape[0] == 4:
        chans.append(trunc_u8(planes[3]))
    return torch.stack(chans, dim=-1)


def merge(y: torch.Tensor, rest) -> tuple[torch.Tensor, torch.Tensor]:
    """A pass's last step: the model's Y plane ``y`` [...,H,W] and the
    resized chroma (and alpha) planes ``rest`` -> (interleaved u8
    [...,H,W,D], the conv map u8 [...,H,W]).

    The first is :func:`ycbcr_to_rgb` of the planes; the second the
    truncating u8 cast of ``y`` (`libsrcnn.cpp:897-901`): ``floor`` and
    torch's cast, with no clamp.  On the card one launch of the merge
    kernel reads ``y`` once for both, and no stack of the planes is made."""
    if y.device.type == "cuda":
        return color_kernel.merge(y, rest)
    return plain_merge(y, rest)


def plain_merge(y: torch.Tensor, rest) -> tuple[torch.Tensor, torch.Tensor]:
    """The plain version of :func:`merge`: the torch expressions, on any
    device."""
    return (plain_ycbcr_to_rgb(torch.stack([y, *rest], dim=0)),
            torch.floor(y).to(torch.uint8))


def ycbcr_to_rgb_exact(planes: torch.Tensor) -> torch.Tensor:
    """Exact-coefficient inverse, mirroring the unused `convertYCbCrtoImgU8`
    (`libsrcnn.cpp:310-346`; `libsrcnn_tpu/ops/color.py:63-77`).  The
    reference applies no clamp there, and its cast of an out-of-range value
    is undefined; like the JAX op this clamps, the sane reading."""
    y = planes[0]
    cb = planes[1]
    cr = planes[2]
    r = y + 1.402 * cr
    g = y - 0.34414 * cb - 0.71414 * cr
    b = y + 1.772 * cb
    chans = [trunc_u8(r), trunc_u8(g), trunc_u8(b)]
    if planes.shape[0] == 4:
        chans.append(trunc_u8(planes[3]))
    return torch.stack(chans, dim=-1)

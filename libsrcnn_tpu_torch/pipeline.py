"""End-to-end single-pass SRCNN upscale pipeline (the `doSRCNN` equivalent),
PyTorch port of the srcnn / float32 branch of ``libsrcnn_tpu/pipeline.py``.

One pass: u8 image on the device -> planar f32 YCbCr -> band resample ->
SRCNN 9-1-5 on Y -> u8 out.  PyTorch runs eagerly, so there is no compiled
program per shape; what a shape needs from the host (the f64 resize
tables, as device index / weight tensors) is built once and cached in
:mod:`.ops.resize`.

On the kernel path the Y resize emits the conv stack's 6 px halo plane
directly (``resize_plane_padded``) and the fused CUDA kernel consumes it;
otherwise the Y plane goes through the plain ``models/srcnn`` convs.
"""

from __future__ import annotations

import torch

from .config import FilterType, SRCNNConfig, chroma_filter
from .kernels import fused_conv
from .models import srcnn
from .ops import color, resize

#: valid srcnn compute tiers of the JAX package
SRCNN_TIERS = ("float32", "bfloat16", "bfloat16_fast", "int8")

#: tiers and models of the JAX package the port does not run yet, with the
#: ROADMAP item that ports each
UNPORTED_TIERS = {"bfloat16": "M6 (kernel K2)", "bfloat16_fast": "M6 (kernel K3)",
                  "int8": "M10 (kernel K4)"}
UNPORTED_MODELS = ("fsrcnn", "espcn", "vdsr", "srcnn955")


def validate_compute_dtype(cfg: SRCNNConfig) -> None:
    """Reject unknown srcnn tiers up front, before weights load or any
    compute branch runs (`libsrcnn_tpu/pipeline.py:52-60`)."""
    if cfg.model == "srcnn" and cfg.compute_dtype not in SRCNN_TIERS:
        raise ValueError(
            f"srcnn compute_dtype={cfg.compute_dtype!r} is not a tier: "
            f"use one of {SRCNN_TIERS}")


def check_supported(cfg: SRCNNConfig) -> None:
    """Raise for a config the port cannot run: ValueError for what the JAX
    package rejects too, NotImplementedError (naming the ROADMAP item) for
    what it runs and the port does not run yet.  Nothing is substituted."""
    if cfg.model in UNPORTED_MODELS:
        raise NotImplementedError(
            f"model={cfg.model!r} is not ported yet (ROADMAP M9)")
    if cfg.model != "srcnn":
        raise ValueError(f"unknown model {cfg.model!r}")
    validate_compute_dtype(cfg)
    if cfg.compute_dtype in UNPORTED_TIERS:
        raise NotImplementedError(
            f"compute_dtype={cfg.compute_dtype!r} is not ported yet "
            f"(ROADMAP {UNPORTED_TIERS[cfg.compute_dtype]}); the port runs "
            f"the exact 'float32' tier")
    if cfg.self_ensemble:
        raise NotImplementedError(
            "self_ensemble=True is not ported yet (ROADMAP M7)")


def resolve_kernel(use_kernel: bool | None, device: torch.device) -> bool:
    """``None`` -> the fused CUDA kernel for a CUDA device, the plain convs
    for the CPU.  ``True`` off CUDA raises: the CPU never stands in for
    the kernel."""
    if use_kernel is None:
        return device.type == "cuda"
    if use_kernel and device.type != "cuda":
        raise ValueError(f"use_kernel=True needs a CUDA device, got {device}")
    return bool(use_kernel)


def _single_pass(img_u8: torch.Tensor, params: dict, *, dst_h: int, dst_w: int,
                 filter_type: FilterType, use_kernel: bool):
    """[H,W,D] u8 -> ([dst_h,dst_w,D] u8, [dst_h,dst_w] u8), on the image's
    device.

    Mirrors `doSRCNN` (`libsrcnn.cpp:628-923`): the second output is the
    truncated-u8 conv3 map (`:889-915`).
    """
    d = img_u8.shape[-1]
    planes = color.rgb_to_ycbcr(img_u8)  # [D,H,W] f32

    y_filter = FilterType(filter_type)
    c_filter = chroma_filter(y_filter)
    rest = [resize.resize_plane(planes[c], dst_h, dst_w, c_filter)
            for c in range(1, d)]

    if use_kernel:
        halo = fused_conv.HALO
        y_r = resize.resize_plane_padded(planes[0], dst_h, dst_w, y_filter,
                                         halo, dst_h + 2 * halo,
                                         dst_w + 2 * halo)
        y_sr = fused_conv.forward_y(params, y_r, dst_h, dst_w)
    else:
        y_r = resize.resize_plane(planes[0], dst_h, dst_w, y_filter)
        y_sr = srcnn.forward_y(params, y_r)

    out_u8 = color.ycbcr_to_rgb(torch.stack([y_sr, *rest], dim=0))
    # conv3 output is already clamped to [0,255]; truncating u8 cast
    # (`libsrcnn.cpp:897-901`)
    conv_u8 = torch.floor(y_sr).to(torch.uint8)
    return out_u8, conv_u8


def run_pass(img_u8: torch.Tensor, params: dict, multiply: float,
             cfg: SRCNNConfig):
    """One resize+model pass of a [H,W,D] u8 tensor; returns (out_u8,
    conv_u8) tensors on the image's device."""
    check_supported(cfg)
    h, w, _ = img_u8.shape
    dst_w, dst_h = resize.scaled_size(w, h, multiply)
    if dst_w <= 0 or dst_h <= 0:
        raise ValueError(f"bad scale {multiply} for {w}x{h}")
    return _single_pass(img_u8, params, dst_h=dst_h, dst_w=dst_w,
                        filter_type=cfg.filter,
                        use_kernel=resolve_kernel(cfg.use_kernel,
                                                  img_u8.device))

"""End-to-end single-pass SRCNN upscale pipeline (the `doSRCNN` equivalent),
PyTorch port of the srcnn branch of ``libsrcnn_tpu/pipeline.py``.

One pass: u8 image on the device -> planar f32 YCbCr -> band resample ->
SRCNN 9-1-5 on Y -> u8 out.  PyTorch runs eagerly, so there is no compiled
program per shape; what a shape needs from the host (the f64 resize
tables, as device index / weight tensors) is built once and cached in
:mod:`.ops.resize`.

On the kernel path the Y resize emits the conv stack's 6 px halo plane
directly (``resize_plane_padded``) and a fused CUDA kernel consumes it: K1
for the exact ``float32`` tier, K2 (split-bf16x2) for ``bfloat16``, K3
(bf16x1) for ``bfloat16_fast`` (`libsrcnn_tpu/pipeline.py:181-209`), K4
(int8 GEMMs) for ``int8`` (`:167-175`).  Otherwise -- ``use_kernel=False``,
or a CPU tensor -- the Y plane goes through the plain convs: for both bf16
tiers the JAX package's XLA twin (bf16-rounded input, h1 and h2; f32
accumulation), as the JAX package does off the TPU, and for ``int8``
``models/srcnn_int8`` (`:176-180`).  So on the CPU the ``bfloat16`` tier
matches the JAX package's CPU output, not the split math K2 computes on
the card; the int8 tier's plain convs are exact, and K4 equals them bit
for bit.

A pass takes one frame ``[H, W, D]`` or a clip ``[N, H, W, D]``: the
batch dimension rides through color and resize, and the clip's Y planes go
to the kernel in one launch.
"""

from __future__ import annotations

import torch

from .config import FilterType, SRCNNConfig, chroma_filter
from .kernels import fused_conv
from .models import srcnn, srcnn_int8
from .ops import color, resize

#: valid srcnn compute tiers of the JAX package
SRCNN_TIERS = ("float32", "bfloat16", "bfloat16_fast", "int8")

#: srcnn float tier -> GEMM mode of the fused kernel
#: (`libsrcnn_tpu/pipeline.py:191-193`); ``int8`` has its own kernel, K4
KERNEL_PRECISION = {"float32": "exact", "bfloat16": "split",
                    "bfloat16_fast": "bf16x1"}
#: models of the JAX package the port does not run yet (ROADMAP M9)
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
    package rejects too, NotImplementedError (naming ROADMAP M9) for the
    models it runs and the port does not run yet.  Nothing is
    substituted."""
    if cfg.model in UNPORTED_MODELS:
        raise NotImplementedError(
            f"model={cfg.model!r} is not ported yet (ROADMAP M9)")
    if cfg.model != "srcnn":
        raise ValueError(f"unknown model {cfg.model!r}")
    validate_compute_dtype(cfg)


def load_model_params(cfg: SRCNNConfig, device: str | torch.device = "cpu") -> dict:
    """Default parameters of ``cfg``'s tier on ``device`` (srcnn; port of
    `libsrcnn_tpu/pipeline.py:84-107`): the int8 tier's quantized pack,
    else the 9-1-5 f32 weights, which every float tier takes (the bf16
    tiers round them in the convs and kernels)."""
    check_supported(cfg)
    if cfg.compute_dtype == "int8":
        return srcnn_int8.load_params(device)
    return srcnn.load_params(device)


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
                 filter_type: FilterType, use_kernel: bool,
                 compute_dtype: str = "float32"):
    """[..., H,W,D] u8 -> ([..., dst_h,dst_w,D] u8, [..., dst_h,dst_w] u8),
    on the image's device; ``...`` is empty or one batch dimension.

    Mirrors `doSRCNN` (`libsrcnn.cpp:628-923`): the second output is the
    truncated-u8 conv3 map (`:889-915`).
    """
    d = img_u8.shape[-1]
    planes = color.rgb_to_ycbcr(img_u8)  # [D,...,H,W] f32

    y_filter = FilterType(filter_type)
    c_filter = chroma_filter(y_filter)
    rest = [resize.resize_plane(planes[c], dst_h, dst_w, c_filter)
            for c in range(1, d)]

    if use_kernel:
        halo = fused_conv.HALO
        y_r = resize.resize_plane_padded(planes[0], dst_h, dst_w, y_filter,
                                         halo, dst_h + 2 * halo,
                                         dst_w + 2 * halo)
        if compute_dtype == "int8":
            y_sr = fused_conv.forward_y_int8(params, y_r, dst_h, dst_w)
        else:
            y_sr = fused_conv.forward_y(params, y_r, dst_h, dst_w,
                                        precision=KERNEL_PRECISION[compute_dtype])
    else:
        y_r = resize.resize_plane(planes[0], dst_h, dst_w, y_filter)

        def plain(p):
            if compute_dtype == "int8":
                return srcnn_int8.forward_y(params, p)
            return srcnn.forward_y(params, p, compute_dtype)

        # the plain convs run one plane at a time, so that a clip equals
        # its frames bit for bit whatever algorithm a batch would pick
        y_sr = (torch.stack([plain(p) for p in y_r]) if y_r.dim() == 3
                else plain(y_r))

    out_u8 = color.ycbcr_to_rgb(torch.stack([y_sr, *rest], dim=0))
    # conv3 output is already clamped to [0,255]; truncating u8 cast
    # (`libsrcnn.cpp:897-901`)
    conv_u8 = torch.floor(y_sr).to(torch.uint8)
    return out_u8, conv_u8


def run_pass(img_u8: torch.Tensor, params: dict, multiply: float,
             cfg: SRCNNConfig):
    """One resize+model pass of a [H,W,D] u8 frame, or of a [N,H,W,D] clip
    in one batched pass (one kernel launch for its Y planes); returns
    (out_u8, conv_u8) tensors on the image's device.  ``cfg.self_ensemble``
    is the caller's business (``api`` / ``serve``)."""
    check_supported(cfg)
    if img_u8.dim() not in (3, 4):
        raise ValueError(f"expected [H,W,D] or [N,H,W,D], got {list(img_u8.shape)}")
    h, w, _ = img_u8.shape[-3:]
    dst_w, dst_h = resize.scaled_size(w, h, multiply)
    if dst_w <= 0 or dst_h <= 0:
        raise ValueError(f"bad scale {multiply} for {w}x{h}")
    return _single_pass(img_u8, params, dst_h=dst_h, dst_w=dst_w,
                        filter_type=cfg.filter,
                        use_kernel=resolve_kernel(cfg.use_kernel,
                                                  img_u8.device),
                        compute_dtype=cfg.compute_dtype)

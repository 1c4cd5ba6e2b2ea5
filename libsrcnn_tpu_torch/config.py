"""Immutable run configuration.

The reference keeps two mutable process globals set via
``ConfigureFilterSRCNN`` (`libsrcnn.cpp:91-92,930-941`) which are not
thread-safe.  The port, like ``libsrcnn_tpu/config.py``, replaces them with
this frozen config object passed per call; a thin compat shim in
:mod:`libsrcnn_tpu_torch.api` reproduces the global-state API.
"""

from __future__ import annotations

import dataclasses
import enum


class FilterType(enum.IntEnum):
    """Interpolation filter for the classical upscale stage.

    Values match the reference's ``SRCNNFilterType`` enum
    (`libsrcnn.h:37-44`) and the CLI ``--filter=N`` mapping
    (`test.cpp:341-365`).
    """

    NEAREST = 0   # box filter, width 0.5
    BILINEAR = 1  # triangle, width 1
    BICUBIC = 2   # Mitchell-Netravali b=c=1/3, width 2 (default)
    LANCZOS3 = 3  # sinc * sinc, width 3
    BSPLINE = 4   # cubic B-spline, width 2


#: Per-channel filter policy (`libsrcnn.cpp:677-714`): the Y channel gets the
#: configured filter; Cb/Cr/A are forced to bilinear -- unless the configured
#: filter is NEAREST, in which case chroma uses the box filter too.
def chroma_filter(y_filter: FilterType) -> FilterType:
    return FilterType.NEAREST if y_filter == FilterType.NEAREST else FilterType.BILINEAR


@dataclasses.dataclass(frozen=True)
class SRCNNConfig:
    """Configuration for one upscale call.

    The fields mirror ``libsrcnn_tpu.config.SRCNNConfig``; what the JAX
    package rejects raises ``ValueError`` here too (see
    :func:`libsrcnn_tpu_torch.pipeline.check_supported`).

    Attributes:
      filter: interpolation filter for the Y channel (chroma policy is
        derived, see :func:`chroma_filter`).
      step_scale: decompose scale factors > 2 into chained x2 passes with a
        u8 round-trip between passes, mirroring `libsrcnn.cpp:980-1061`.
      compute_dtype: the conv stack's tier.  ``"float32"``: exact f32, TF32
        off (kernel K1).  ``"bfloat16"``: split-bf16x2 on the card (K2:
        activations split into bf16 hi + lo, bf16 weights, f32
        accumulation), <=2 u8 off the exact tier on the TPU.
        ``"bfloat16_fast"``: bf16x1 on the card (K3: one bf16 pass), <=3
        u8 off.  Off the kernel (``use_kernel=False`` or the CPU) both bf16
        tiers run the JAX package's XLA twin (bf16-rounded operands, f32
        accumulation).  ``"int8"``: the quantized pack's int8 GEMMs with
        int32 accumulation and folded requant epilogues (K4 on the card,
        the exact plain convs of ``models/srcnn_int8`` elsewhere, equal bit
        for bit), ~40 dB PSNR from the exact tier.
      self_ensemble: flip self-ensemble: the four flips of the frame go
        through one batched pass, are flipped back and averaged in f32,
        then rounded ties-to-even.
      emit_conv_map: also return the raw Y-channel conv3 output as u8
        (`libsrcnn.cpp:889-915`).
      use_kernel: route the conv stack through the hand-written CUDA kernel
        (``kernels/fused_conv``).  ``None`` (default): the kernel for CUDA
        tensors, the plain PyTorch convs for CPU tensors.  ``True`` on the
        CPU raises; ``False`` runs the plain convs on either device.
      model: which model upscales the Y channel: ``"srcnn"`` (the
        reference's 9-1-5, at the four tiers above), the HR families
        ``"vdsr"`` and ``"srcnn955"`` (they refine the classically resized
        plane, so they serve any factor), or the LR families ``"fsrcnn"``
        and ``"espcn"`` (a learned upscale head per integer factor x2, x3,
        x4; the scale must match a head exactly, and step-scale chains the
        x2 head).  The families take ``"float32"`` (exact f32) and
        ``"bfloat16"`` (bf16 operands, exact products, f32 accumulation on
        every device, :mod:`libsrcnn_tpu_torch.ops.conv`; the JAX
        package's CPU backend computes exact f32 for it instead) and raise
        ``ValueError`` for the other two.
      lane_pack: the JAX package's MXU-lane-packed formulation of the
        learned families' convs (p adjacent output columns share the TPU's
        128 lanes; the same f32 MACs in another reduction order).  The port
        takes the field so that a config written for the JAX package
        builds here, and has nothing to pack on Hopper: ``upscale``
        ignores it for every model; ``upscale_chunked`` refuses ``True``,
        as the JAX package's chunked path does.
    """

    filter: FilterType = FilterType.BICUBIC
    step_scale: bool = False
    compute_dtype: str = "float32"
    self_ensemble: bool = False
    emit_conv_map: bool = False
    use_kernel: bool | None = None
    model: str = "srcnn"
    lane_pack: bool | None = None


DEFAULT_CONFIG = SRCNNConfig()

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

    The fields mirror ``libsrcnn_tpu.config.SRCNNConfig``; options the port
    does not cover yet raise ``NotImplementedError`` when a call uses them
    (see :func:`libsrcnn_tpu_torch.pipeline.check_supported`).

    Attributes:
      filter: interpolation filter for the Y channel (chroma policy is
        derived, see :func:`chroma_filter`).
      step_scale: decompose scale factors > 2 into chained x2 passes with a
        u8 round-trip between passes, mirroring `libsrcnn.cpp:980-1061`.
      compute_dtype: the conv stack's tier.  Only ``"float32"`` (exact f32,
        TF32 off) is ported; the ``bfloat16``, ``bfloat16_fast`` and
        ``int8`` tiers are ROADMAP items M6 and M10.
      self_ensemble: flip self-ensemble; not ported yet (ROADMAP M7).
      emit_conv_map: also return the raw Y-channel conv3 output as u8
        (`libsrcnn.cpp:889-915`).
      use_kernel: route the conv stack through the hand-written CUDA kernel
        (``kernels/fused_conv``).  ``None`` (default): the kernel for CUDA
        tensors, the plain PyTorch convs for CPU tensors.  ``True`` on the
        CPU raises; ``False`` runs the plain convs on either device.
      model: which model family upscales the Y channel.  Only ``"srcnn"``
        (the reference's 9-1-5) is ported; the rest of the zoo is ROADMAP
        item M9.
    """

    filter: FilterType = FilterType.BICUBIC
    step_scale: bool = False
    compute_dtype: str = "float32"
    self_ensemble: bool = False
    emit_conv_map: bool = False
    use_kernel: bool | None = None
    model: str = "srcnn"


DEFAULT_CONFIG = SRCNNConfig()
